"""The plain reference: minimap2_rs's PAF for the repo's golden data,
and its two formulations of the minimizer sketch agreeing."""

import numpy as np
import pytest
import torch
from conftest import ROOT

from port_bench.reference import chain as rchain
from port_bench.reference import index as rindex
from port_bench.reference import pipeline as rpipe
from port_bench.reference import sketch as rsketch

GOLD = ROOT / "tests" / "golden"


def _fasta(path):
    recs, name, chunks = [], None, []
    for line in path.read_bytes().splitlines():
        if line.startswith(b">"):
            if name is not None:
                recs.append((name, b"".join(chunks)))
            name, chunks = line[1:].split()[0].decode(), []
        elif line:
            chunks.append(line)
    recs.append((name, b"".join(chunks)))
    return recs


def _index(recs, reads, w=10, k=15, chunk=1 << 26):
    want = np.array([m[0] >> 8 for _n, s in reads for m in rsketch.query_minimizers(s, w, k)],
                    dtype=np.uint64)

    def fetch(rid, lo, hi):
        return torch.from_numpy(rsketch.nt4(recs[rid][1][lo:hi]).astype(np.int64))

    return rindex.build_index([n for n, _s in recs], [len(s) for _n, s in recs], fetch, w, k,
                              want, 2e-4, 10, "cpu", chunk=chunk)


@pytest.mark.parametrize("mode", ["prune", "exact"])
def test_reference_reproduces_the_golden_paf(mode):
    refs, reads = _fasta(GOLD / "golden_refs.fa"), _fasta(GOLD / "golden_reads.fa")
    idx = _index(refs, reads, chunk=7001)
    cp, mp = rchain.ChainParams(k=15), rpipe.MapParams()
    lines = [ln for n, s in reads for ln in rpipe.map_read(idx, n, s, cp, mp, mode=mode)]
    want = (GOLD / "golden_w10k15.paf").read_text().splitlines()
    assert lines == want


def test_bfloat16_control_differs_on_the_golden_reads():
    refs, reads = _fasta(GOLD / "golden_refs.fa"), _fasta(GOLD / "golden_reads.fa")
    idx = _index(refs, reads)
    cp, mp = rchain.ChainParams(k=15), rpipe.MapParams()
    diff = sum(rpipe.map_read(idx, n, s, cp, mp, pen_dtype="bfloat16")
               != rpipe.map_read(idx, n, s, cp, mp) for n, s in reads)
    assert diff >= len(reads) // 2


@pytest.mark.parametrize("w,k", [(10, 15), (5, 11), (1, 7), (11, 19)])
def test_scan_and_set_sketches_agree(w, k):
    rng = np.random.default_rng(w * 100 + k)
    for n in (1, 7, 33, 2000):
        seq = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)])
        scan = sorted(set(rsketch.query_minimizers(seq, w, k)), key=lambda m: m[1])
        codes = torch.from_numpy(rsketch.nt4(seq).astype(np.int64))
        whole = rsketch.genome_minimizers(codes, 0, n, (0, n), w, k)
        got = [((int(a) << 8) | k, int(b)) for a, b in zip(*whole)]
        assert got == scan
        parts = []
        for a in range(0, n, 300):
            b = min(n, a + 300)
            lo, hi = max(a - w - k, 0), min(b + w, n)
            parts.append(rsketch.genome_minimizers(codes[lo:hi], lo, n, (a, b), w, k)[1])
        assert torch.equal(torch.cat(parts), whole[1])


def test_sketch_refuses_what_it_does_not_model():
    with pytest.raises(ValueError):
        rsketch.query_minimizers(b"ACGTN" * 10, 10, 15)
    with pytest.raises(ValueError):
        rsketch.query_minimizers(b"ACGT" * 10, 10, 14)


def test_index_keeps_every_occurrence_and_mid_occ():
    rng = np.random.default_rng(3)
    seq = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 50000)])
    recs = [("a", seq[:30000] + seq[:20000]), ("b", seq[30000:])]
    reads = [("r", seq[1000:3000])]
    idx = _index(recs, reads, chunk=4096)
    assert idx.mid_occ >= 10
    # the read's span occurs twice in "a": every kept key has count >= 2
    assert (idx.counts >= 2).sum() >= 0.9 * idx.keys.shape[0]
    rids = idx.positions >> np.uint64(32)
    assert set(rids.tolist()) <= {0, 1}
