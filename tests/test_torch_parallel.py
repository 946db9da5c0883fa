"""The port's multi-GPU pieces against the JAX package's on the CPU: the
hash-range-sharded index tables and their two-phase (dm_entry == 2)
probe, and, over 4 gloo ranks spawned once for the module, the dp and
sharded chain-score steps and the collective index statistics. Exact
equality everywhere (JAX on its virtual 8-device CPU mesh)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams as JChainParams  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.ops.chain_ops import chain_scalars_from_params as jscalars  # noqa: E402
from minimap2_rs_tpu.ops.u64 import U64Pair  # noqa: E402
from minimap2_rs_tpu.parallel import pipeline as jpipe  # noqa: E402
from minimap2_rs_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from minimap2_rs_tpu.parallel.sharded_index import ShardedDeviceIndex as JSharded  # noqa: E402
from minimap2_rs_torch.config import ChainParams, IndexParams  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402
from minimap2_rs_torch.parallel import ranks  # noqa: E402
from minimap2_rs_torch.parallel.sharded_index import ShardedDeviceIndex  # noqa: E402
from minimap2_rs_torch.runtime import host as nhost  # noqa: E402
from minimap2_rs_torch.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads  # noqa: E402

torch.set_num_threads(2)

N_RANKS = 4
FRACS = (2e-4, 0.01, 0.5)


@pytest.fixture(scope="module")
def genome_idx():
    """The 60 kb fixture of tests/test_mesh_mapper.py (k=11, w=5)."""
    return build_index_native([("chrM", random_genome(60_000, seed=11))],
                              IndexParams(w=5, k=11))


def _arrays(idx):
    return idx.keys, idx.starts, idx.counts, idx.positions


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_tables_equal_jax(genome_idx, n_shards):
    """Each rank's shard tables byte-equal to the JAX stacked arrays at
    that shard, at one uniform compact layout (dm_entry 2)."""
    kb = 2 * genome_idx.k
    j = JSharded.from_host(*_arrays(genome_idx), n_shards=n_shards, key_bits=kb)
    assert j.dm_entry == 2
    for s in range(n_shards):
        t = ShardedDeviceIndex.from_host(*_arrays(genome_idx), n_shards, kb, rank=s,
                                         device="cpu")
        for name in ("prefix_shift", "bucket_slots", "n_keys_local", "dm_bits", "dm_slots",
                     "dm_entry", "dm_fp_bits", "n_shards"):
            assert getattr(t, name) == getattr(j, name), name
        for name in ("kv", "pos", "prefix", "dm", "dm_start"):
            np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name))[s],
                                          err_msg=f"{name}, shard {s}")
        local = t.local()
        np.testing.assert_array_equal(local.dm_start.numpy().view(np.uint32),
                                      np.asarray(j.dm_start)[s])
        assert local.pos.shape[0] == 2 and not local.pos_packed
    with pytest.raises(ValueError):
        ShardedDeviceIndex.from_host(*_arrays(genome_idx), n_shards, kb, rank=n_shards,
                                     device="cpu")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_entry2_lookup_equals_jax(genome_idx, n_shards):
    """The two-phase probe on each shard's local index equals the JAX
    index_lookup on that shard, for real keys (every one found in
    exactly one shard), random keys and key 0."""
    kb = 2 * genome_idx.k
    j = JSharded.from_host(*_arrays(genome_idx), n_shards=n_shards, key_bits=kb)
    rng = np.random.default_rng(n_shards)
    q = np.concatenate([rng.choice(genome_idx.keys, size=2048).astype(np.int64),
                        rng.integers(0, 1 << kb, size=2047, dtype=np.int64), [0]])
    q = q.reshape(64, 64)
    jq = U64Pair(jnp.asarray((q >> 32).astype(np.uint32)),
                 jnp.asarray((q & 0xFFFFFFFF).astype(np.uint32)))
    found = np.zeros(q.shape, dtype=np.int64)
    for s in range(n_shards):
        t = ShardedDeviceIndex.from_host(*_arrays(genome_idx), n_shards, kb, rank=s,
                                         device="cpu").local()
        assert t.dm_entry == 2
        start, count = tidx.index_lookup(t, torch.from_numpy(q))
        one = dataclasses.replace(
            j, **{f: getattr(j, f)[s:s + 1] for f in ("kv", "pos", "prefix", "dm", "dm_start")})
        js, jc = jidx.index_lookup(one.local(), jq)
        np.testing.assert_array_equal(start.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jc).astype(np.int64))
        found += count.numpy() > 0
    assert (found[:32] == 1).all() and found.max() == 1


def _tiny(n_reads: int, w=5, k=11, genome_len=6000, L=128, seed=0):
    """__graft_entry__._tiny_problem through the port's own modules."""
    genome = random_genome(genome_len, seed=seed)
    idx = build_index_native([("chrT", genome)], IndexParams(w=w, k=k))
    reads = simulate_reads(genome, n_reads, read_len=(80, L - 8), seed=seed + 1)
    codes = np.full((n_reads, L), 4, dtype=np.int32)
    lengths = np.zeros(n_reads, dtype=np.int32)
    for i, (_, s, *_r) in enumerate(reads):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    statics = dict(w=w, k=k, q_occ_max=10, q_occ_frac=0.01, M=64, A=128, window=128)
    return idx, codes, lengths, statics


@pytest.fixture(scope="module")
def spawned(genome_idx, tmp_path_factory):
    """One spawn of N_RANKS gloo ranks for the module (ranks.step_checks):
    the tiny problem's 16 reads through the dp step on a (4, 1) mesh and
    the sharded step on a (1, 4) mesh, then the 60 kb index's collective
    statistics over 4 shards."""
    nhost.native_available()  # build the host runtime once, before the ranks
    idx, codes, lengths, statics = _tiny(n_reads=4 * N_RANKS)
    cp = ChainParams.defaults_for_k(idx.k)
    res = ranks.spawn(ranks.step_checks, N_RANKS, idx, codes, lengths, cp, statics,
                      N_RANKS, FRACS, genome_idx,
                      store_dir=tmp_path_factory.mktemp("store"), device="cpu",
                      timeout_s=240)
    return idx, codes, lengths, statics, res


def _jax_step(maker, mesh, index, idx, codes, lengths, statics):
    out = maker(mesh, {**statics, "hpc": False})(
        index, jnp.asarray(codes), jnp.asarray(lengths),
        jscalars(JChainParams.defaults_for_k(idx.k)), jnp.int32(max(idx.calc_mid_occ(2e-4), 10)))
    return {kk: np.asarray(v) for kk, v in out.items()}


def _cat(res, mode, name):
    return np.concatenate([r[mode][name] for r in res])


@pytest.mark.parametrize("mode", ["dp", "sharded"])
def test_step_equals_jax(spawned, mode):
    """map_batch_sharded on 4 gloo ranks equals JAX make_map_batch_sharded
    on make_mesh(dp=1, ix=4) (the window 128 over the exchanged 512
    slots), and map_batch_dp equals make_map_batch_dp on (4, 1): the
    anchor words, n_anchors, anc_ovf and (f, prev), rows in read order."""
    idx, codes, lengths, statics, res = spawned
    args = _arrays(idx)
    if mode == "dp":
        index = jidx.DeviceIndex.from_host(*args, key_bits=2 * idx.k)
        want = _jax_step(jpipe.make_map_batch_dp, jmake_mesh(dp=N_RANKS, ix=1), index, idx,
                         codes, lengths, statics)
    else:
        index = JSharded.from_host(*args, n_shards=N_RANKS, key_bits=2 * idx.k)
        want = _jax_step(jpipe.make_map_batch_sharded, jmake_mesh(dp=1, ix=N_RANKS), index,
                         idx, codes, lengths, statics)
        assert all(r["dm_entry"] == 2 for r in res)
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "f", "prev", "n_anchors", "anc_ovf"):
        got = _cat(res, mode, name)
        w = want[name]
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        np.testing.assert_array_equal(got, w, err_msg=name)
    assert _cat(res, mode, "n_anchors").sum() > 0


def test_modes_agree(spawned):
    """The dryrun's cross-check: reads that overflow neither mode have the
    same anchors and chain scores in both."""
    _idx, codes, _l, _s, res = spawned
    ovf = _cat(res, "dp", "anc_ovf") | _cat(res, "sharded", "anc_ovf")
    na = _cat(res, "dp", "n_anchors")
    np.testing.assert_array_equal(na[~ovf], _cat(res, "sharded", "n_anchors")[~ovf])
    f_dp, f_sh = _cat(res, "dp", "f"), _cat(res, "sharded", "f")
    for b in np.flatnonzero(~ovf):
        np.testing.assert_array_equal(f_dp[b, :na[b]], f_sh[b, :na[b]])
    assert (~ovf).sum() >= codes.shape[0] // 2


def test_collective_stats_equal_jax(spawned, genome_idx):
    """index_stats_allreduce and calc_mid_occ_allreduce on 4 shards equal
    JAX index_stats_psum and calc_mid_occ_psum and the host quantile, on
    every rank."""
    res = spawned[-1]
    mesh = jmake_mesh(dp=2, ix=N_RANKS)
    j = JSharded.from_host(*_arrays(genome_idx), n_shards=N_RANKS, key_bits=2 * genome_idx.k)
    nk, npos = jpipe.index_stats_psum(mesh, j)
    assert (nk, npos) == (genome_idx.keys.shape[0], genome_idx.positions.shape[0])
    for r in res:
        assert r["stats"] == (nk, npos)
        for frac in FRACS:
            want = jpipe.calc_mid_occ_psum(mesh, j, frac)
            assert r["mid_occ"][frac] == want == genome_idx.calc_mid_occ(frac), frac
    st = res[0]["collectives"]
    assert st["all_reduce/ix"]["calls"] == 1 + 3 * 32
    assert st["all_to_all/ix"]["transport"] == "gloo, host memory"
