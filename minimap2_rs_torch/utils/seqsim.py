"""Synthetic genome and read simulation for tests and benchmarks.

The reference ships no test data; its parity was established against a
human chr8 read (README.md:8-27). We generate deterministic synthetic
genomes with realistic repeat content (homopolymers, tandem repeats,
segmental duplications) and simulate reads with SNPs/indels and
reverse-complemented orientation."""

from __future__ import annotations

import numpy as np

_COMP = {65: 84, 67: 71, 71: 67, 84: 65}  # A<->T, C<->G
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in _COMP.items():
    _COMP_TABLE[_a] = _b


def revcomp(seq: bytes) -> bytes:
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMP_TABLE[arr[::-1]].tobytes()


def random_genome(
    length: int,
    seed: int = 0,
    repeat_frac: float = 0.25,
    n_frac: float = 0.001,
) -> bytes:
    """Genome with `repeat_frac` of its length made of repeats."""
    rng = np.random.default_rng(seed)
    parts: list[bytes] = []
    ln = 0
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    while ln < length:
        n_before = len(parts)
        r = rng.random()
        if r < n_frac:
            parts.append(b"N" * int(rng.integers(1, 50)))
        elif r < repeat_frac:
            kind = rng.integers(0, 3)
            if kind == 0:  # homopolymer
                parts.append(bytes([rng.choice(bases)]) * int(rng.integers(8, 40)))
            elif kind == 1:  # tandem repeat
                unit = rng.choice(bases, size=int(rng.integers(2, 8))).tobytes()
                parts.append(unit * int(rng.integers(4, 30)))
            else:  # duplicated segment from earlier sequence
                if parts:
                    src = b"".join(parts[-4:])
                    if len(src) > 100:
                        st = int(rng.integers(0, len(src) - 100))
                        parts.append(src[st : st + int(rng.integers(50, 100))])
                    else:
                        parts.append(src)
                else:
                    parts.append(rng.choice(bases, size=100).tobytes())
        else:
            parts.append(rng.choice(bases, size=int(rng.integers(200, 2000))).tobytes())
        # incremental length: summing every part each round was O(n^2)
        # and dominated >=100 Mbp generation (minutes -> seconds)
        ln += sum(len(q) for q in parts[n_before:])
    return b"".join(parts)[:length]


def simulate_reads(
    genome: bytes,
    n_reads: int,
    read_len: int | tuple[int, int] = (500, 1000),
    error_rate: float = 0.02,
    indel_frac: float = 0.3,
    rev_frac: float = 0.5,
    seed: int = 1,
) -> list[tuple[str, bytes, int, int, str]]:
    """Simulate reads; returns (name, seq, true_start, true_end, strand)."""
    rng = np.random.default_rng(seed)
    lo, hi = (read_len, read_len + 1) if isinstance(read_len, int) else read_len
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for i in range(n_reads):
        L = int(rng.integers(lo, hi))
        if len(genome) <= L + 1:
            st = 0
            L = len(genome) - 1
        else:
            st = int(rng.integers(0, len(genome) - L))
        frag = g[st : st + L].copy()
        # mutate
        n_err = rng.poisson(error_rate * L)
        for _ in range(n_err):
            p = int(rng.integers(0, frag.shape[0]))
            r = rng.random()
            if r < indel_frac / 2 and frag.shape[0] > 50:  # deletion
                frag = np.delete(frag, p)
            elif r < indel_frac:  # insertion
                frag = np.insert(frag, p, rng.choice(bases))
            else:  # SNP
                frag[p] = rng.choice(bases)
        seq = frag.tobytes()
        strand = "+"
        if rng.random() < rev_frac:
            seq = revcomp(seq)
            strand = "-"
        out.append((f"read{i}", seq, st, st + L, strand))
    return out


def write_test_fasta(
    ref_path: str,
    reads_path: str,
    genome_len: int = 200_000,
    n_reads: int = 20,
    seed: int = 0,
) -> None:
    """Convenience fixture writer used by the verify workflow."""
    from ..io.fasta import write_fasta

    genome = random_genome(genome_len, seed=seed)
    write_fasta(ref_path, [("ref1", genome)])
    reads = simulate_reads(genome, n_reads, seed=seed + 1)
    write_fasta(reads_path, [(name, seq) for name, seq, *_ in reads])
