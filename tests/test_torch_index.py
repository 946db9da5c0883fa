"""The port's DeviceIndex tables and lookup against the JAX package's
(ops/index_ops.py), for both layouts the planner produces: the 4-word
direct table (small genome) and the fused single-gather table (the
5 Mbp headline genome). The tables must be the same bytes: they are the
state the port carries over from the reference layout."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import IndexParams  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.ops.u64 import U64Pair  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402

torch.set_num_threads(2)

# genome length -> the planner's layout (dm_entry) for it
LAYOUTS = {50_000: 4, 5_000_000: 3}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def both(request):
    glen = request.param
    g = random_genome(glen, seed=glen % 97)
    idx = build_index_native([("chrT", g)], IndexParams())
    args = (idx.keys, idx.starts, idx.counts, idx.positions)
    kw = dict(key_bits=2 * idx.k, seq_lens=[s.length for s in idx.seq])
    return glen, idx, tidx.DeviceIndex.from_host(*args, **kw, device="cpu"), jidx.DeviceIndex.from_host(*args, **kw)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_device_index_tables_equal_jax(both):
    glen, _idx, t, j = both
    assert t.dm_entry == j.dm_entry == LAYOUTS[glen]
    for name in ("prefix_shift", "bucket_slots", "n_keys", "dm_bits", "dm_slots",
                 "dm_entry", "dm_fp_bits", "pos_packed", "n_seq"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("kv", "pos", "dm"):
        np.testing.assert_array_equal(_u32(getattr(t, name)), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.prefix.numpy(), np.asarray(j.prefix))
    assert j.dm_start is None  # the planner never makes the compact two-phase table
    np.testing.assert_array_equal(t.seq_cum.numpy(), np.asarray(j.seq_cum).astype(np.int64))


def test_index_lookup_matches_jax(both):
    _glen, idx, t, j = both
    rng = np.random.default_rng(0)
    real = rng.choice(idx.keys, size=2048).astype(np.int64)
    rand = rng.integers(0, 1 << (2 * idx.k), size=2047, dtype=np.int64)
    q = np.concatenate([real, rand, [0]]).reshape(64, 64)
    start, count = tidx.index_lookup(t, torch.from_numpy(q))
    js, jc = jidx.index_lookup(j, U64Pair(jnp.asarray((q >> 32).astype(np.uint32)),
                                          jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32))))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc).astype(np.int64))
    assert (count.numpy()[:32] > 0).all()  # the real keys are found


def test_unported_layouts_raise(both):
    """The sharded index's two-phase entry (dm_entry == 2), once
    unported, now probes as the JAX index_lookup does on the same compact
    tables (built at the planner's p and S); the prefix fallback (no
    direct table), once unported, probes the full kv/prefix tables and
    finds every key block the direct table finds."""
    _glen, idx, t, j = both
    kb = 2 * idx.k
    meta, start_plane = tidx.fill_direct_table(idx.keys, idx.starts, idx.counts, kb,
                                               t.dm_bits, t.dm_slots, 2)
    jmeta, jstart = jidx.fill_direct_table(idx.keys, idx.starts, idx.counts, kb,
                                           t.dm_bits, t.dm_slots, 2)
    np.testing.assert_array_equal(meta, np.asarray(jmeta))
    np.testing.assert_array_equal(start_plane, np.asarray(jstart))
    two = tidx.DeviceIndex(**{**t.__dict__, "dm": tidx._t32(meta, "cpu"), "dm_entry": 2,
                              "dm_start": tidx._t32(start_plane, "cpu")})
    jtwo = dataclasses.replace(j, dm=jnp.asarray(jmeta), dm_start=jnp.asarray(jstart),
                               dm_entry=2)
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.choice(idx.keys, size=1024).astype(np.int64),
                        rng.integers(0, 1 << kb, size=1023, dtype=np.int64), [0]])
    start, count = tidx.index_lookup(two, torch.from_numpy(q))
    js, jc = jidx.index_lookup(jtwo, U64Pair(jnp.asarray((q >> 32).astype(np.uint32)),
                                             jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32))))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc).astype(np.int64))
    want = np.searchsorted(idx.keys, q[:1024])
    np.testing.assert_array_equal(count.numpy()[:1024], idx.counts[want])
    kv, prefix, shift, S = tidx.plan_prefix_layout(idx.keys, 2 * idx.k)
    kv[: idx.keys.shape[0], 2] = idx.starts.astype(np.uint32)
    kv[: idx.keys.shape[0], 3] = idx.counts.astype(np.uint32)
    flat = tidx.DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                      key_bits=2 * idx.k, device="cpu")
    fb = tidx.DeviceIndex(**{**flat.__dict__, "kv": tidx._t32(kv, "cpu"),
                             "prefix": torch.from_numpy(prefix), "prefix_shift": shift,
                             "bucket_slots": S, "dm_slots": 0})
    keys = torch.from_numpy(idx.keys[::97].astype(np.int64))
    start, count = tidx.index_lookup(fb, keys)
    want = np.searchsorted(idx.keys, idx.keys[::97])
    np.testing.assert_array_equal(start.numpy(), idx.starts[want])
    np.testing.assert_array_equal(count.numpy(), idx.counts[want])
