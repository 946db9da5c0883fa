"""Host-side FASTA ingest (the reference uses the noodles-fasta crate,
reference src/index.rs:429-438, main.rs:92-103).

Names follow the usual convention: the record name is the first
whitespace-delimited token after '>'."""

from __future__ import annotations


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    """All (name, sequence) records of a FASTA file."""
    records: list[tuple[str, bytes]] = []
    name: str | None = None
    chunks: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    records.append((name, b"".join(chunks)))
                name = line[1:].split()[0].decode(errors="replace") if len(line) > 1 else "*"
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        records.append((name, b"".join(chunks)))
    return records


def read_fasta_first(path: str) -> tuple[str, bytes]:
    """First record only, ('*', b'') when empty — matching the reference
    CLI's behavior (main.rs:92-103)."""
    name: str | None = None
    chunks: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    break
                name = line[1:].split()[0].decode(errors="replace") if len(line) > 1 else "*"
            elif name is not None and line:
                chunks.append(line)
    if name is None:
        return "*", b""
    return name, b"".join(chunks)


def write_fasta(path: str, records: list[tuple[str, bytes]], width: int = 80) -> None:
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
