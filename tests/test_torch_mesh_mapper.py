"""End-to-end parity of the port's MeshMapper on the CPU, over 8 gloo
ranks spawned once for the module: the PAF bytes of the replicated
index (dp = 8) and of the hash-range-sharded index (dp = 2, ix = 4) must
equal the host oracle's and the JAX MeshMapper's on its virtual
8-device mesh; the longer-read sharded case (bucket crossing, rescue
band switching) equals the JAX MeshMapper's bytes and the oracle within
the single-device long-read tolerance; the sharded case again through
the program cache (models/programs.ReplayStandIn in place of the CUDA
graph) gives the same bytes and collectives on its replayed passes. A
1-rank mesh in this process equals the single-device Mapper. The fixtures are tests/test_mesh_mapper.py's."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models.mesh_mapper import MeshMapper as JaxMeshMapper  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads  # noqa: E402
from minimap2_rs_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, revcomp, simulate_reads  # noqa: E402
from minimap2_rs_torch import config as tconfig  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.models.mapper import Mapper  # noqa: E402
from minimap2_rs_torch.models.mesh_mapper import make_mesh_mapper  # noqa: E402
from minimap2_rs_torch.models.programs import ReplayStandIn  # noqa: E402
from minimap2_rs_torch.parallel import ranks  # noqa: E402
from minimap2_rs_torch.runtime import host as nhost  # noqa: E402

torch.set_num_threads(2)

W, K = 5, 11
N_RANKS = 8
MKW = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)
LONG_KW = dict(buckets=(512, 2048), batch_size=8, mini_frac=0.6, anchor_frac=1.0)
RUNS = [
    dict(name="dp8", dp=8, ix=1, sharded=False, reads="short", kw=MKW),
    dict(name="sharded", dp=2, ix=4, sharded=True, reads="short", kw=MKW),
    # the world is 8 ranks, so (4, 2) stands in for the JAX test's (2, 2)
    dict(name="longer", dp=4, ix=2, sharded=True, reads="long", kw=LONG_KW),
    # the sharded run again through the program cache with the stand-in
    # graph: a first pass, then two in which every stage replays
    dict(name="sharded_graphs", dp=2, ix=4, sharded=True, reads="short", kw=MKW,
         graph=ReplayStandIn, passes=2),
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    genome = random_genome(60_000, seed=11)
    idx = build_index([("chrM", genome)], IndexParams(w=W, k=K))
    cp = ChainParams.defaults_for_k(K)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 21, read_len=(150, 450), seed=13)]
    rng = np.random.default_rng(5)
    rl.append(("junk", bytes(rng.choice(list(b"ACGT"), size=300).astype(np.uint8))))
    rl.append(("empty", b""))
    rl.append(("rc", revcomp(genome[7000:7400])))
    long_rl = [(n, s) for n, s, *_ in simulate_reads(genome, 8, read_len=(900, 2000),
                                                     seed=29)]
    tidx = build_index_native([("chrM", genome)], tconfig.IndexParams(w=W, k=K))
    tcp = tconfig.ChainParams.defaults_for_k(K)
    nhost.native_available()  # build the host runtime once, before the ranks
    reads = {"short": rl, "long": long_rl}
    runs = [{**r, "idx": tidx, "cp": tcp, "mp": tconfig.MapParams(), "reads": reads[r["reads"]]}
            for r in RUNS]
    res = ranks.spawn(ranks.mesh_map, N_RANKS, runs, task_kw=dict(fracs=(2e-4,)),
                      store_dir=tmp_path_factory.mktemp("store"), device="cpu",
                      timeout_s=300)
    return dict(idx=idx, cp=cp, mp=mp, rl=rl, long_rl=long_rl, tidx=tidx, tcp=tcp,
                host=map_reads(idx, rl, cp, mp), res=res, jax={})


def _jax_blob(setup, dp, ix, sharded, reads, kw):
    key = (dp, ix, sharded, id(reads))
    if key not in setup["jax"]:
        setup["jax"][key] = _jax_map(setup, dp, ix, sharded, reads, kw)
    return setup["jax"][key]


def _jax_map(setup, dp, ix, sharded, reads, kw):
    mm = JaxMeshMapper.from_oracle_index(setup["idx"], setup["cp"], setup["mp"],
                                         mesh=jmake_mesh(dp=dp, ix=ix),
                                         index_sharded=sharded, **kw)
    return mm.map_reads_paf(reads)


def _lines(blob: bytes) -> list:
    return blob.decode().split("\n")[:-1] if blob else []


@pytest.mark.parametrize("name", ["dp8", "sharded"])
def test_mesh_paf_equals_oracle_and_jax(setup, name):
    run = next(r for r in RUNS if r["name"] == name)
    blobs = [r[name]["blob"] for r in setup["res"]]
    assert all(b == blobs[0] for b in blobs), "ranks disagree"
    assert _lines(blobs[0]) == setup["host"]
    assert blobs[0] == _jax_blob(setup, run["dp"], run["ix"], run["sharded"], setup["rl"],
                                 MKW)
    assert "rc" in {l.split("\t")[0] for l in _lines(blobs[0])}
    coll = setup["res"][0][name]["collectives"]
    if run["sharded"]:
        assert all(r[name]["dm_entry"] == 2 for r in setup["res"])
        assert {"all_gather/ix", "all_to_all/ix", "all_gather/world"} <= set(coll)
        assert all(r[name]["mid_occ"][2e-4] == setup["idx"].calc_mid_occ(2e-4)
                   for r in setup["res"])
    else:
        assert set(coll) == {"all_gather/dp"}


def test_sharded_mesh_through_programs(setup):
    """The sharded mode (dp = 2, ix = 4) through each rank's program cache
    with the stand-in graph: the minimizer all_gather, the anchor
    all_to_all and the wire-row all_gather captured with their stage. Every
    pass's bytes equal the eager run's, the JAX MeshMapper's and the
    oracle's; each key runs eagerly once, then is captured once; the two
    later passes replay every stage, and their collectives count what two
    eager passes send."""
    res = [r["sharded_graphs"] for r in setup["res"]]
    eager = [r["sharded"] for r in setup["res"]]
    assert all(r["blob"] == eager[0]["blob"] for r in res)
    assert _lines(res[0]["blob"]) == setup["host"]
    assert res[0]["blob"] == _jax_blob(setup, 2, 4, True, setup["rl"], MKW)
    for r, e in zip(res, eager):
        first, later = r["first_stats"], r["pass_stats"]
        n_keys = first["eager_stages"]
        assert n_keys >= 2
        assert first["device_stages"] == n_keys + first.get("graph_replays", 0)
        assert first.get("graph_captures", 0) + sum(
            st.get("graph_captures", 0) for st in later) == n_keys
        for st in later:
            assert "eager_stages" not in st and st["graph_replays"] == st["device_stages"]
        assert "graph_captures" not in later[-1]
        assert set(r["collectives"]) == set(e["collectives"]) == {
            "all_gather/ix", "all_to_all/ix", "all_gather/world"}
        for key, st in r["collectives"].items():
            want = e["collectives"][key]
            assert st["calls"] == 2 * want["calls"] == st["replayed_calls"] > 0
            assert st["bytes_sent"] == 2 * want["bytes_sent"] > 0
            assert want["replayed_calls"] == 0
        assert (sum(st["collective_payload_bytes"] for st in later)
                == 2 * e["first_stats"]["collective_payload_bytes"])


def test_mesh_longer_reads_sharded(setup):
    """Bucket crossing + rescue-band switching through the sharded mesh:
    the JAX MeshMapper's bytes, and the oracle's within the reference's
    max_chain_skip tolerance on s1 (tests/test_mesh_mapper.py)."""
    blobs = [r["longer"]["blob"] for r in setup["res"]]
    assert all(b == blobs[0] for b in blobs)
    assert blobs[0] == _jax_blob(setup, 2, 2, True, setup["long_rl"], LONG_KW)
    dev = _lines(blobs[0])
    host = map_reads(setup["idx"], setup["long_rl"], setup["cp"], setup["mp"])
    assert len(dev) == len(host) > 0
    for d, h in zip(dev, host):
        df, hf = d.split("\t"), h.split("\t")
        assert df[:12] == hf[:12] and df[13] == hf[13]
        ds1 = int(df[14].split(":")[-1])
        hs1 = int(hf[14].split(":")[-1])
        assert hs1 <= ds1 <= hs1 + 16


def test_one_rank_mesh_equals_single_device(setup):
    """dp = 1 in this process (a 1-rank gloo group) == the single-device
    Mapper == the oracle; more ranks than the launch has is an error."""
    assert not dist.is_initialized()
    try:
        mm = make_mesh_mapper(setup["tidx"], setup["tcp"], tconfig.MapParams(), dp=1,
                              device="cpu", **MKW)
        blob = mm.map_reads_paf(setup["rl"])
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh_mapper(setup["tidx"], setup["tcp"], dp=2, device="cpu", **MKW)
    finally:
        dist.destroy_process_group()
    single = Mapper.from_oracle_index(setup["tidx"], setup["tcp"], tconfig.MapParams(),
                                      device="cpu", **MKW)
    assert blob == single.map_reads_paf(setup["rl"])
    assert _lines(blob) == setup["host"]
    assert set(mm.mesh.stats) == {"all_gather/dp"}
