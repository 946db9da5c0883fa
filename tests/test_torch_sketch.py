"""The port's minimizer sketch and compaction against the JAX package's
(ops/sketch.py: the u32 fast path for k <= 15, the u64 path for k 17-27,
the exact scan for even k, HPC spans) and against the reference scan of
oracle/sketch.py: exact equality on seqsim reads with N runs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.ops import sketch as jsketch  # noqa: E402
from minimap2_rs_tpu.oracle.sketch import sketch_sequence  # noqa: E402
from minimap2_rs_tpu.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads  # noqa: E402
from minimap2_rs_torch.ops import sketch as tsketch  # noqa: E402

torch.set_num_threads(2)


def _batch(L=512, n=12, seed=0):
    """nt4 codes (B, L) padded with 4, and true lengths: seqsim reads
    (both strands, N runs from the genome) plus an empty read, a read
    shorter than k, one of all N and one cut by an N run."""
    g = random_genome(100_000, seed=seed, n_frac=0.02)
    seqs = [s for _n, s, *_ in simulate_reads(g, n, read_len=(L // 2, L), seed=seed + 1)]
    seqs += [b"", b"ACGTACG", b"N" * 50, g[500:700] + b"N" * 5 + g[900:1100]]
    codes = np.full((len(seqs), L), 4, np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = nt4_encode(s[:L])
    lengths = np.array([min(len(s), L) for s in seqs], np.int32)
    return codes, lengths


def _ks_pair(ks: torch.Tensor):
    """The port's int64 key_span -> the JAX (hi, lo) uint32 words."""
    k = ks.numpy()
    inv = k == tsketch.KS_INVALID
    hi = np.where(inv, 0xFFFFFFFF, k >> 32).astype(np.uint32)
    lo = np.where(inv, 0xFFFFFFFF, k & 0xFFFFFFFF).astype(np.uint32)
    return hi, lo


U64_KW = [(17, 10), (19, 10), (21, 11), (27, 10)]


@pytest.mark.parametrize("k,w", [(15, 10), (11, 5)] + U64_KW)
def test_sketch_positions_matches_jax(k, w):
    codes, lengths = _batch(seed=k)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes), torch.from_numpy(lengths), w, k)
    jks, jps, jem = jsketch.sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), w, k)
    hi, lo = _ks_pair(ks)
    np.testing.assert_array_equal(hi, np.asarray(jks.hi))
    np.testing.assert_array_equal(lo, np.asarray(jks.lo))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps).astype(np.int64))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert em.sum() > 100


@pytest.mark.parametrize("max_out", [256, 40])
def test_compact_minimizers_matches_jax(max_out):
    k, w = 15, 10
    codes, lengths = _batch(seed=7)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes), torch.from_numpy(lengths), w, k)
    cks, cps, n, ovf = tsketch.compact_minimizers(ks, ps, em, max_out)
    jks, jps, jem = jsketch.sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), w, k)
    jcks, jcps, jn, jovf = jsketch.compact_minimizers(jks, jps, jem, max_out)
    hi, lo = _ks_pair(cks)
    np.testing.assert_array_equal(hi, np.asarray(jcks.hi))
    np.testing.assert_array_equal(lo, np.asarray(jcks.lo))
    np.testing.assert_array_equal(cps.numpy(), np.asarray(jcps).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert ovf.any() == (max_out == 40)


@pytest.mark.parametrize("k,w", U64_KW)
def test_compact_minimizers_matches_jax_u64(k, w):
    codes, lengths = _batch(seed=k + 1)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes), torch.from_numpy(lengths), w, k)
    cks, cps, n, ovf = tsketch.compact_minimizers(ks, ps, em, 128)
    jks, jps, jem = jsketch.sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), w, k)
    jcks, jcps, jn, jovf = jsketch.compact_minimizers(jks, jps, jem, 128)
    hi, lo = _ks_pair(cks)
    np.testing.assert_array_equal(hi, np.asarray(jcks.hi))
    np.testing.assert_array_equal(lo, np.asarray(jcks.lo))
    np.testing.assert_array_equal(cps.numpy(), np.asarray(jcps).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    # keys wider than 32 bits really occur
    assert (hi[hi != 0xFFFFFFFF] > 0).any()


@pytest.mark.parametrize("k,w", [(15, 10)] + U64_KW)
def test_sketch_equals_reference_scan(k, w):
    """The emitted (key_span, pos<<1|strand) set of every read equals the
    oracle's exact per-base scan (sketch.rs:29-100)."""
    codes, lengths = _batch(L=384, n=6, seed=k + 2)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes), torch.from_numpy(lengths), w, k)
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    for b in range(codes.shape[0]):
        L = int(lengths[b])
        e = em[b].numpy()
        got = set(zip(ks[b].numpy()[e].tolist(), ps[b].numpy()[e].tolist()))
        want = set(sketch_sequence(acgt[codes[b, :L]].tobytes(), w, k)) if L else set()
        assert got == want, (k, b)


@pytest.mark.parametrize("k,hpc", [(14, False), (16, False), (15, True)])
def test_unported_sketch_paths_raise(k, hpc):
    """Even k (the exact scan) and HPC spans, once unported, now equal
    the JAX package's sketch."""
    codes, lengths = _batch(L=64, n=2)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes), torch.from_numpy(lengths),
                                          10, k, hpc)
    jks, jps, jem = jsketch.sketch_positions(jnp.asarray(codes), jnp.asarray(lengths),
                                             10, k, hpc)
    hi, lo = _ks_pair(ks)
    np.testing.assert_array_equal(hi, np.asarray(jks.hi))
    np.testing.assert_array_equal(lo, np.asarray(jks.lo))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps).astype(np.int64))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert em.any()
