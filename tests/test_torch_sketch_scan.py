"""The port's sketch at even k (the exact scan: ops/sketch_scan.py and the
window-scan kernel's plain version), at k = 28 and under HPC, against the
JAX package's ops.sketch.sketch_positions and the oracle's exact scan, on
the tie-heavy corpora of tests/test_sketch_scan.py: exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.ops import sketch as jsketch  # noqa: E402
from minimap2_rs_tpu.oracle.sketch import sketch_sequence  # noqa: E402
from minimap2_rs_tpu.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome  # noqa: E402
from minimap2_rs_torch.kernels import window_scan as kscan  # noqa: E402
from minimap2_rs_torch.ops import sketch as tsketch  # noqa: E402
from minimap2_rs_torch.ops import sketch_scan as tscan  # noqa: E402

torch.set_num_threads(2)


def _cases():
    """tests/test_sketch_scan.py's corpora: random, tie-heavy two-letter,
    strand-symmetric repeats and a stale-register N reset."""
    cases = [random_genome(900, seed=s) for s in range(3)]
    for alpha in (b"AC", b"AT"):
        r = np.random.default_rng(len(alpha))
        cases.append(bytes(r.choice(list(alpha), size=600).tolist()))
    cases.append(b"ACGT" * 150)
    cases.append(b"ATATATAT" * 60)
    cases.append(b"A" * 200 + b"N" + b"CGCG" * 60)
    return cases


def _batch(cases):
    L = -(-max(len(s) for s in cases) // 8) * 8
    codes = np.full((len(cases), L), 4, np.int32)
    lengths = np.zeros(len(cases), np.int32)
    for i, s in enumerate(cases):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    return codes, lengths


def _u64(ks: torch.Tensor) -> np.ndarray:
    """The port's key_span words as the JAX package's uint64 values
    (KS_INVALID -> all ones)."""
    k = ks.numpy()
    return np.where(k == tsketch.KS_INVALID, np.uint64(2**64 - 1), k.view(np.uint64))


CASES = [(10, 14, False), (5, 10, False), (10, 16, False), (3, 2, False),
         (1, 14, False), (10, 14, True), (10, 15, True), (10, 28, False)]


@pytest.mark.parametrize("w,k,hpc", CASES)
def test_sketch_positions_equals_jax_and_oracle(w, k, hpc):
    cases = _cases()
    codes, lengths = _batch(cases)
    ks, ps, em = tsketch.sketch_positions(torch.from_numpy(codes),
                                          torch.from_numpy(lengths), w, k, hpc)
    jks, jps, jem = jsketch.sketch_positions(jnp.asarray(codes), jnp.asarray(lengths),
                                             w, k, hpc)
    jk64 = (np.asarray(jks.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(jks.lo)
    got = _u64(ks)
    np.testing.assert_array_equal(got, jk64)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps).astype(np.int64))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    for b, seq in enumerate(cases):
        e = em[b].numpy()
        mine = set(zip(got[b][e].tolist(), ps[b].numpy()[e].tolist()))
        want = {(x, y & 0xFFFFFFFF) for x, y in sketch_sequence(seq, w, k, is_hpc=hpc)}
        assert mine == want, (w, k, hpc, b)
    if k == 28:  # the word really passes 2^63 (negative as int64)
        assert (ks[em] < 0).any()


@pytest.mark.parametrize("k", [14, 15])
def test_emit_final_suppresses_the_end_flush(k):
    """emit_final=False drops only the sequence-end flush, as in JAX."""
    codes, lengths = _batch(_cases()[:4])
    ef = np.array([True, False, True, False])
    args = (torch.from_numpy(codes), torch.from_numpy(lengths), 10, k, False)
    _ks, _ps, em = tsketch.sketch_positions(*args, emit_final=torch.from_numpy(ef))
    _ks, _ps, em_all = tsketch.sketch_positions(*args)
    _jks, _jps, jem = jsketch.sketch_positions(
        jnp.asarray(codes), jnp.asarray(lengths), 10, k, False, jnp.asarray(ef))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert torch.equal(em & em_all, em)
    assert torch.equal(em[ef], em_all[ef])


def test_window_scan_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the kernel wrapper runs _window_scan_ref and counts
    no launch."""
    codes, lengths = _batch(_cases())
    ks, ps, l_eff = tscan._kmer_info_even(torch.from_numpy(codes),
                                          torch.from_numpy(lengths), 14, False)
    ef = torch.ones(len(lengths), dtype=torch.bool)
    kscan.reset_launches()
    got = kscan.window_scan(ks, ps, l_eff.to(torch.int32), torch.from_numpy(lengths),
                            10, 14, ef)
    want = tscan._window_scan_ref(ks, ps, l_eff, torch.from_numpy(lengths), 10, 14, ef)
    assert torch.equal(got, want) and got.any()
    assert not any(kscan.launches.values())


def test_window_scan_wrapper_launches_the_tiled_entry(monkeypatch):
    """On a CUDA device the wrapper launches the position-parallel entry
    and counts it by length class; sequential_scan launches the first
    design uncounted. The launch itself is replaced, as this machine has
    no card."""
    entries = []

    def fake_launch(entry, ks, *_a):
        entries.append(entry)
        return torch.zeros(ks.shape, dtype=torch.bool)

    monkeypatch.setattr(kscan, "_validate", lambda *a: torch.device("cuda"))
    monkeypatch.setattr(kscan, "_launch", fake_launch)
    monkeypatch.setattr(kscan, "captured", None)
    monkeypatch.setattr(kscan, "launches", dict.fromkeys(kscan.launches, 0))
    args = [torch.zeros((2, 5000), dtype=torch.int64)] * 2 + [
        torch.zeros((2, 5000), dtype=torch.int32), torch.zeros(2, dtype=torch.int32)]
    ef = torch.ones(2, dtype=torch.bool)
    kscan.window_scan(*args, 10, 14, ef)
    kscan.sequential_scan(*args, 10, 14, ef)
    assert entries == ["mm2t_window_scan_tile", "mm2t_window_scan"]
    assert {k: v for k, v in kscan.launches.items() if v} == {"window_scan/long": 1}


def test_sequential_scan_needs_cuda():
    codes, lengths = _batch(_cases()[:2])
    ks, ps, l_eff = tscan._kmer_info_even(torch.from_numpy(codes),
                                          torch.from_numpy(lengths), 14, False)
    with pytest.raises(ValueError):
        kscan.sequential_scan(ks, ps, l_eff.to(torch.int32), torch.from_numpy(lengths),
                              10, 14, torch.ones(2, dtype=torch.bool))
