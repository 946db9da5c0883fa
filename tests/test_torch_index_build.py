"""The port's device index build (ops/index_build.py,
models/index_builder.build_index_device) against the JAX package's
build_index_device and the native C++ build, and its prefix-fallback
lookup (tables above the direct table's byte cap) against the JAX
package's, on tables built with plan_prefix_layout. Exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import IndexParams  # noqa: E402
from minimap2_rs_tpu.models import index_builder as jbuild  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.ops.u64 import U64Pair  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome  # noqa: E402
from minimap2_rs_torch.models import index_builder as tbuild  # noqa: E402
from minimap2_rs_torch.ops import index_build as tib  # noqa: E402
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("keys", "starts", "counts", "positions", "S")


def _records():
    """Several sequences: one spanning many 4 kb chunks with N runs, one
    just over a chunk, one short, one all N, one empty."""
    return [
        ("a", random_genome(30_000, seed=3, n_frac=0.02)),
        ("b", random_genome(4_500, seed=4)),
        ("c", b"ACGTNNNNACGTTTGCA" * 20),
        ("n", b"N" * 300),
        ("e", b""),
    ]


@pytest.mark.parametrize("flag", [0, 1], ids=["plain", "hpc"])
@pytest.mark.parametrize("k", [15, 19])
def test_build_index_device_equals_jax_and_native(k, flag):
    recs = _records()
    p = IndexParams(w=10, k=k, flag=flag)
    got = tbuild.build_index_device(recs, p, chunk=4096, device="cpu")
    want = jbuild.build_index_device(recs, p, chunk=4096)
    native = tbuild.build_index_native(recs, p)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name), getattr(native, name), err_msg=name)
    assert [s.length for s in got.seq] == [len(s) for _n, s in recs]
    assert got.keys.shape[0] > 4000


def test_even_k_takes_the_host_exact_build():
    recs = _records()[:2]
    p = IndexParams(w=10, k=14)
    got = tbuild.build_index_device(recs, p, chunk=4096, device="cpu")
    native = tbuild.build_index_native(recs, p)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(native, name), err_msg=name)


def test_chunk_overflow_raises(monkeypatch):
    """A flat buffer too small for a batch's minimizers raises, as in JAX."""
    import minimap2_rs_torch.ops.index_build as mod

    def tiny(codes, content, own_start, own_len, seq_off, rid, final, w, k, hpc, max_out):
        return orig(codes, content, own_start, own_len, seq_off, rid, final, w, k, hpc, 64)

    orig = mod.sketch_chunk_flat
    monkeypatch.setattr(mod, "sketch_chunk_flat", tiny)
    with pytest.raises(RuntimeError, match="overflow"):
        tib.build_sorted_pairs_device([(0, np.zeros(5000, np.uint8))], 10, 15, chunk=4096,
                                      device="cpu")


def test_plan_chunks_equals_jax():
    from minimap2_rs_tpu.ops.index_build import plan_chunks

    lens = [0, 1, 4095, 4096, 4097, 30_000]
    assert tib.plan_chunks(lens, 4096, 10, 15) == plan_chunks(lens, 4096, 10, 15)


@pytest.mark.parametrize("k", [15, 28])
def test_prefix_fallback_lookup_equals_jax(k, monkeypatch):
    """With the direct table over its byte cap, from_host keeps the full
    kv/prefix tables in both packages, and the two-gather probe finds the
    same (start, count) for real and random keys."""
    g = random_genome(60_000, seed=k)
    idx = tbuild.build_index_native([("chrP", g)], IndexParams(w=10, k=k))
    for mod in (tidx, jidx):
        plan = mod.plan_direct_layout
        monkeypatch.setattr(mod, "plan_direct_layout",
                            lambda *a, _plan=plan, **kw: _plan(*a, byte_cap=1))
    args = (idx.keys, idx.starts, idx.counts, idx.positions)
    t = tidx.DeviceIndex.from_host(*args, key_bits=2 * k, device="cpu")
    j = jidx.DeviceIndex.from_host(*args, key_bits=2 * k)
    assert t.dm_slots == 0 and j.dm_slots == 0
    kv, prefix, _shift, S = tidx.plan_prefix_layout(idx.keys, 2 * k)
    assert t.bucket_slots == S and t.kv.shape == kv.shape
    np.testing.assert_array_equal(t.kv.numpy().view(np.uint32), np.asarray(j.kv))
    np.testing.assert_array_equal(t.prefix.numpy(), np.asarray(j.prefix))
    rng = np.random.default_rng(1)
    real = rng.choice(idx.keys, size=512).astype(np.int64)
    rand = rng.integers(0, 1 << (2 * k), size=511, dtype=np.int64)
    q = np.concatenate([real, rand, [0]]).reshape(32, 32)
    start, count = tidx.index_lookup(t, torch.from_numpy(q))
    js, jc = jidx.index_lookup(j, U64Pair(jnp.asarray((q >> 32).astype(np.uint32)),
                                          jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32))))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc).astype(np.int64))
    assert (count.numpy().reshape(-1)[:512] > 0).all()
