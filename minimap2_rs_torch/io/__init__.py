from .fasta import read_fasta, read_fasta_first, write_fasta  # noqa: F401
