"""The port's captured device programs (models/programs.py) on the CPU:
the key holds every static of a stage; the copy-in, replay and copy-out
plumbing gives each batch the eager stage's output, with a stand-in for
the CUDA graph that re-runs the recorded stage on the static buffers,
and whole mapping passes through it equal the eager mapper's and the
JAX package's oracle; a key is captured only when it comes back, and at
most max_programs live; replays add the recorded kernel launches; a
1-rank MeshMapper captures its mesh steps, collectives included, as the
Mapper does, and a gloo mesh on a card refuses to. A real capture needs
the card (chip_smoke.py)."""

import copy
import dataclasses
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map
from minimap2_rs_torch.kernels import counts
from minimap2_rs_torch.models import mapper as tmapper
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.mesh_mapper import MeshMapper, make_mesh_mapper
from minimap2_rs_torch.models.programs import (
    COUNTERS,
    ProgramCache,
    ReplayStandIn,
    program_key,
)
from minimap2_rs_torch.parallel.mesh import Mesh
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

torch.set_num_threads(2)

W, K = 5, 11
SMALL = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)


class RecordingCache(ProgramCache):
    """A ProgramCache that keeps every call's (fn, inputs, statics)."""

    def __init__(self, device):
        super().__init__(device, graph=ReplayStandIn)
        self.calls = []

    def run(self, fn, inputs, stats, /, **statics):
        self.calls.append((fn, inputs, statics))
        return super().run(fn, inputs, stats, **statics)


@pytest.fixture(scope="module")
def small():
    genome = random_genome(60_000, seed=1)
    idx = build_index_native([("chrA", genome)], IndexParams(w=W, k=K))
    return genome, idx, ChainParams.defaults_for_k(K), MapParams()


def _reads(genome, n, seed, lo=150, hi=450):
    rl = [(nm, s) for nm, s, *_ in simulate_reads(genome, n, read_len=(lo, hi), seed=seed)]
    # an N in some reads: the 2-bit wire's exception list changes
    return [(nm, s[:40] + b"N" + s[41:] if i % 3 == 0 else s) for i, (nm, s) in enumerate(rl)]


def _mapper(small, graphs_on_cpu: bool, **kw):
    _g, idx, cp, mp = small
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **{**SMALL, **kw})
    if graphs_on_cpu:
        m.programs = RecordingCache("cpu")
    return m


# ---- (a) the key -----------------------------------------------------------

LITE_STATICS = [name for name, p in inspect.signature(
    tmapper._fused_map_stage_lite).parameters.items() if p.kind is p.KEYWORD_ONLY]


@pytest.fixture(scope="module")
def lite_call(small):
    """(fn, inputs, statics) of the first lite stage a CPU Mapper issues."""
    genome = small[0]
    m = _mapper(small, True)
    m.map_reads_paf(_reads(genome, 6, seed=3))
    return m.programs.calls[0]


def _changed(v):
    """A static of the same kind that differs: a new identity for tensors
    and other objects, another value for the rest."""
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 1
    if isinstance(v, float):
        return v * 1.5
    if v is None:
        return 25
    if isinstance(v, str):
        return "4bit" if v != "4bit" else "2bit"
    if dataclasses.is_dataclass(v) and hasattr(v, "bw"):
        return dataclasses.replace(v, bw=v.bw + 1)
    if isinstance(v, torch.Tensor):
        return v.clone()
    return copy.copy(v)


def test_the_mapper_passes_every_static_of_each_stage(lite_call):
    fn, inputs, statics = lite_call
    assert fn is tmapper._fused_map_stage_lite
    assert sorted(statics) == sorted(LITE_STATICS)
    assert [t.dtype for t in inputs] == [torch.uint8, torch.int32, torch.int32]
    assert inputs[2].shape == (tmapper._NEX_CAP,)


@pytest.mark.parametrize("name", LITE_STATICS)
def test_each_static_is_in_the_key(lite_call, name):
    """Changing one static gives a new key; equal statics (a copy of the
    dict, the same objects) give the same key."""
    fn, inputs, statics = lite_call
    key = program_key(fn, inputs, statics)
    assert program_key(fn, tuple(t.clone() for t in inputs), dict(statics)) == key
    other = {**statics, name: _changed(statics[name])}
    assert program_key(fn, inputs, other) != key


@pytest.mark.parametrize("what", ["stage", "B", "wire 4-bit", "wire dtype", "nex length"])
def test_stage_and_input_shapes_are_in_the_key(lite_call, what):
    fn, (wire, lengths, nex), statics = lite_call
    B, L4 = wire.shape
    if what == "stage":
        fn = tmapper._fused_map_stage
    elif what == "B":
        wire, lengths = torch.zeros((2 * B, L4), dtype=torch.uint8), lengths.repeat(2)
    elif what == "wire 4-bit":
        wire, nex = torch.zeros((B, 2 * L4), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32)
    elif what == "wire dtype":
        wire = wire.to(torch.int32)
    else:
        nex = torch.zeros(2 * nex.shape[0], dtype=torch.int32)
    assert program_key(fn, (wire, lengths, nex), statics) != program_key(*lite_call)


# ---- (b) copy-in, replay, copy-out ------------------------------------------

def _batch(m, seqs, bucket):
    """A bucket's padded host batch, as the submit loop encodes it."""
    B = m._quantize_b(len(seqs), m._shapes_for(bucket, 1)[3])
    lengths = np.zeros(B, dtype=np.int32)
    lengths[: len(seqs)] = [len(s) for s in seqs]
    wire_arr, nex, wire = m._encode(seqs, B, bucket)
    assert wire == "2bit"
    return wire_arr, lengths, nex


def test_replays_give_each_batch_the_eager_output(small):
    """Three batches of different content, lengths and N lists under one
    key, interleaved with three under a second key: each output equals
    the eager stage's on that batch, though every replay overwrites the
    static output the one before it left."""
    genome = small[0]
    cached, eager = _mapper(small, True), _mapper(small, False)
    keys = [(256, True), (512, False)]
    jobs = []
    for i in range(3):
        for bucket, wide in keys:
            lo = bucket // 2 - 60 * i
            seqs = [s for _n, s in _reads(genome, 5 + i, seed=10 * i + bucket, lo=lo, hi=bucket)]
            jobs.append((_batch(eager, seqs, bucket), bucket, wide))
    stats, outs, wants = {}, [], []
    for arrays, bucket, wide in jobs:
        M, A, window, _B = cached._shapes_for(bucket, 1)
        kw = dict(wide=wide, M=M, A=A, window=window, wire="2bit", max_chain_skip=None)
        outs.append(cached._device_stage_lite(*arrays, cached._scalars, stats=stats, **kw))
        wants.append(eager._device_stage_lite(*arrays, eager._scalars, stats={}, **kw))
    for (out, stamps), (want, _s) in zip(outs, wants):
        assert stamps.ready is None
        assert torch.equal(out, want)
    assert len({tuple(o.flatten().tolist()) for o, _r in outs}) == len(outs)
    # per key: the first batch eager, the second captured and replayed,
    # the third replayed
    assert {k: stats[k] for k in stats if k in COUNTERS and k != "capture"} == {
        "device_stages": 6, "eager_stages": 2, "graph_captures": 2, "graph_replays": 4}
    assert {"upload", "stage_issue", "d2h_issue", "capture"} <= set(stats)
    assert len(cached.programs.programs) == 2


def _forced_set(kind):
    """(genome, index, Mapper fields, reads) that force the 4x tier and
    the device-resolved wide band ("tier2": undersized anchor slots and
    chimeras with halves 200 kb apart), or the lazy wide pass of a
    long-read shape ("lazy": an 8 kb bucket, A >= 1024) - the cases of
    tests/test_torch_mapper.py."""
    seed = 42 if kind == "tier2" else 45
    g = random_genome(400_000, seed=seed)
    idx = build_index_native([("chrR", g)], IndexParams())
    rng = np.random.default_rng(seed + 2)
    if kind == "tier2":
        rl = [(n, s) for n, s, *_ in simulate_reads(g, 240, read_len=(500, 1000), seed=43)]
        rl += [(f"chim{c}", g[a: a + 400] + g[a + 200_000: a + 200_400])
               for c, a in enumerate(rng.integers(0, 150_000, size=8).tolist())]
        kw = dict(buckets=(1024,), batch_size=64, mini_frac=0.25, anchor_frac=0.04)
    else:
        rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000), seed=46)]
        rl += [(f"lchim{c}", g[a: a + 3000] + g[a + 300_000: a + 303_000])
               for c, a in enumerate(rng.integers(0, 80_000, size=3).tolist())]
        kw = dict(buckets=(8192,), batch_size=8)
    return idx, kw, rl


@pytest.mark.parametrize("path", ["lite", "general", "tier2", "lazy"])
def test_mapper_through_programs_equals_eager(small, path):
    """Two whole mapping passes through the program cache give the eager
    mapper's bytes and the JAX package's oracle's lines: the lite and
    general programs, the general path's rescue re-chain, the 4x tier,
    and the wide band on the device and in the lazy pass. The first pass
    runs each key's first batch eagerly; the second replays every
    stage."""
    genome, idx, cp, mp = small
    kw = SMALL
    if path == "general":
        cp = ChainParams.defaults_for_k(K, min_cnt=1, min_chain_score=10)
    if path in ("lite", "general"):
        rl = _reads(genome, 20, seed=5)
        rng = np.random.default_rng(6)
        for ci in range(4):
            a = int(rng.integers(0, 20_000))
            rl.append((f"chim{ci}", genome[a: a + 200] + genome[a + 30_000: a + 30_200]))
    else:
        idx, kw, rl = _forced_set(path)
        cp = ChainParams.defaults_for_k(15)
    ms = [tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **kw)
          for _ in range(2)]
    ms[0].programs = RecordingCache("cpu")
    blobs = [m.map_reads_paf(rl) for m in ms]
    first = dict(ms[0].stats)
    ms[0].stats = {}
    assert ms[0].map_reads_paf(rl) == blobs[0] == blobs[1]
    assert blobs[0].count(b"\n") >= 6
    assert blobs[0].decode().split("\n")[:-1] == oracle_map(idx, rl, cp, mp)
    st, eager = ms[0].stats, ms[1].stats
    assert first["eager_stages"] + first.get("graph_replays", 0) == first["device_stages"]
    assert "eager_stages" not in st and st["graph_replays"] == st["device_stages"]
    assert first.get("graph_captures", 0) + st.get("graph_captures", 0) >= 1
    assert eager["eager_stages"] == eager["device_stages"] == st["device_stages"]
    if path == "general":
        assert st["rescue_reads"] > 0
        assert any(fn is tmapper._packed_chain_stage for fn, _i, _s in ms[0].programs.calls)
    if path == "tier2":
        assert st["tier2_reads"] >= 48 and st["wide_reads"] > 0
        assert any(s["M"] > ms[0]._shapes_for(1024, 1)[0] for _f, _i, s in ms[0].programs.calls)
    if path == "lazy":
        assert st["wide_reads"] > 0
        assert any(not s["wide"] and s["scalars"] == ms[0]._scalars_wide
                   for _f, _i, s in ms[0].programs.calls)


# ---- (c) replay accounting --------------------------------------------------

def test_replays_add_the_recorded_launches():
    launches = {"k/a": 0, "k/b": 0}
    kept = []

    def stage(x, *, n):
        for key in ("k/a", "k/b", "k/a"):
            if counts.count(launches, key):
                kept.append(key)
        return x * n

    cache = ProgramCache("cpu", graph=ReplayStandIn)
    stats = {}
    for i in range(4):
        out, _ready = cache.run(stage, (torch.arange(4) + i,), stats, n=3)
        assert torch.equal(out, (torch.arange(4) + i) * 3)
    # the eager first run counts, the capture records, each of 3 replays
    # adds
    assert launches == {"k/a": 8, "k/b": 4}
    assert kept == ["k/a", "k/b", "k/a"]  # inputs kept on the eager run only
    assert stats["eager_stages"] == 1
    assert stats["graph_captures"] == 1 and stats["graph_replays"] == 3
    (prog,) = cache.programs.values()
    assert [k for _d, k in prog.launches] == ["k/a", "k/b", "k/a"]


def test_a_key_is_captured_only_when_it_comes_back():
    """A key seen once runs eagerly and holds no program; the second run
    of a key captures it."""
    cache = ProgramCache("cpu", graph=ReplayStandIn)
    stats = {}
    for n in (2, 3, 4):
        cache.run(lambda x, *, n: x * n, (torch.arange(3),), stats, n=n)
    assert stats["eager_stages"] == 3 and "graph_captures" not in stats
    assert len(cache.programs) == 0 and cache.capture_s == []
    out, _ready = cache.run(lambda x, *, n: x * n, (torch.arange(3),), stats, n=3)
    assert torch.equal(out, torch.arange(3) * 3)
    assert stats["graph_captures"] == stats["graph_replays"] == 1
    assert len(cache.programs) == 1 and len(cache.capture_s) == 1


def test_live_programs_are_bounded_least_recently_used_first():
    """At most max_programs live: the least recently used goes first, and
    an evicted key that comes back is captured again (never run eagerly
    again); every output stays the stage's."""
    def stage(x, *, n):
        return x * n

    cache = ProgramCache("cpu", graph=ReplayStandIn, max_programs=2)
    stats = {}
    order = [2, 3, 2, 3, 4, 4, 2, 3, 3, 4]
    for i, n in enumerate(order):
        x = torch.arange(5) + i
        out, _ready = cache.run(stage, (x,), stats, n=n)
        assert torch.equal(out, x * n)
        assert len(cache.programs) <= 2
    # 2 and 3 run eagerly, then are captured; 4 runs eagerly, then is
    # captured, evicting 2; 2 comes back (evicting 3), then 3 (evicting
    # 4), 3 replays, and 4 comes back (evicting 2)
    assert stats["eager_stages"] == 3
    assert stats["graph_captures"] == 6
    assert stats["graph_replays"] == len(order) - 3
    assert [k[2][0][1] for k in cache.programs] == [3, 4]


def test_concurrent_runs_keep_each_batch_apart():
    """Threads issuing through one cache at once (the producer and the
    drain on the general path without the native runtime) each get their
    own batch's output: copy-in, replay and copy-out of one run are not
    interleaved with another's."""
    import sys
    import threading

    def stage(x, *, n):
        return (x * n).cumsum(0) + x.flip(0)

    cache = ProgramCache("cpu", graph=ReplayStandIn)
    errors, stats = [], {}

    def worker(t):
        for i in range(40):
            x = torch.arange(64) * (t + 1) + i
            n = 2 + t % 3
            out, _ready = cache.run(stage, (x,), {}, n=n)
            if not torch.equal(out, stage(x, n=n)):
                errors.append((t, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == [] and len(cache.programs) == 3 and stats == {}


def test_recordings_do_not_nest():
    with counts.recording() as rec:
        assert counts.count({"x": 0}, "x") is False
        with pytest.raises(RuntimeError, match="already open"):
            with counts.recording():
                pass
    assert len(rec) == 1
    d = {"x": 0}
    counts.replay(rec * 2)
    assert counts.count(d, "x") is True and d == {"x": 1}


# ---- (d) MeshMapper through the program cache ------------------------------

def _jax_mesh_blob(genome, rl, sharded):
    """The JAX MeshMapper's bytes on a 1-device mesh, index built by the
    JAX package from the same genome."""
    from minimap2_rs_tpu import config as jconfig
    from minimap2_rs_tpu.models.mesh_mapper import MeshMapper as JaxMeshMapper
    from minimap2_rs_tpu.oracle.index import build_index
    from minimap2_rs_tpu.parallel.mesh import make_mesh as jmake_mesh

    jidx = build_index([("chrA", genome)], jconfig.IndexParams(w=W, k=K))
    mm = JaxMeshMapper.from_oracle_index(jidx, jconfig.ChainParams.defaults_for_k(K),
                                         jconfig.MapParams(), mesh=jmake_mesh(dp=1, ix=1),
                                         index_sharded=sharded, **SMALL)
    return mm.map_reads_paf(rl)


def _coll(mesh_stats):
    return {k: (v["calls"], v["bytes_sent"]) for k, v in mesh_stats.items()}


@pytest.mark.parametrize("sharded", [False, True])
def test_mesh_mapper_through_programs(small, sharded):
    """A 1-rank gloo MeshMapper on the CPU with the stand-in graph, over
    three passes, beside an eager twin: each pass's bytes equal the
    twin's, the oracle's and the JAX MeshMapper's; each key runs eagerly
    once, is captured once and replays on every later pass (no stats
    dict in the key); Mesh.stats counts the replayed collectives as the
    twin counts its eager ones."""
    genome, idx, cp, mp = small
    rl = _reads(genome, 12, seed=7)
    rng = np.random.default_rng(8)
    for ci in range(3):
        a = int(rng.integers(0, 20_000))
        rl.append((f"chim{ci}", genome[a: a + 200] + genome[a + 30_000: a + 30_200]))
    assert not dist.is_initialized()
    try:
        mms = [make_mesh_mapper(idx, cp, mp, dp=1, index_sharded=sharded, device="cpu",
                                **SMALL) for _ in range(2)]
        cached, eager = mms
        assert cached.graphs is True and cached.programs is None  # the CPU: eager
        cached.programs = RecordingCache("cpu")
        blobs, stats = [], []
        for _p in range(3):
            got = []
            for m in mms:
                m.stats = {}
                got.append(m.map_reads_paf(rl))
            blobs.append(got)
            stats.append(dict(cached.stats))
    finally:
        dist.destroy_process_group()
    want = blobs[0][1]
    assert want.count(b"\n") >= 8
    assert all(b == want for pair in blobs for b in pair)
    assert want.decode().split("\n")[:-1] == oracle_map(idx, rl, cp, mp)
    assert want == _jax_mesh_blob(genome, rl, sharded)
    pc = cached.programs
    assert all(fn.__func__ is MeshMapper._mesh_stage_lite for fn, _i, _s in pc.calls)
    assert all("stats" not in statics for _f, _i, statics in pc.calls)
    n_keys = len(pc.programs)
    assert n_keys >= 2 and len(pc._seen) == n_keys
    assert sum(st.get("eager_stages", 0) for st in stats) == n_keys
    assert sum(st.get("graph_captures", 0) for st in stats) == n_keys
    assert stats[0]["eager_stages"] + stats[0].get("graph_replays", 0) == stats[0]["device_stages"]
    for st in stats[1:]:
        assert "eager_stages" not in st and st["graph_replays"] == st["device_stages"]
    assert "graph_captures" not in stats[2]
    assert _coll(cached.mesh.stats) == _coll(eager.mesh.stats)
    axis = "world" if sharded else "dp"
    assert set(cached.mesh.stats) == {f"all_gather/{axis}"}
    st = cached.mesh.stats[f"all_gather/{axis}"]
    assert st["replayed_calls"] == sum(s.get("graph_replays", 0) for s in stats) > 0
    assert eager.mesh.stats[f"all_gather/{axis}"]["replayed_calls"] == 0


def test_gloo_mesh_on_a_card_refuses_graphs(small):
    """graphs=True on a gloo mesh on a CUDA device raises before anything
    moves to the device (so here, without a card); graphs=False gets past
    the check to the upload, which needs the card."""
    _g, idx, cp, mp = small
    card = torch.device("cuda", 0)
    mesh = Mesh(dp=1, ix=2, rank=0, device=card, backend="gloo", groups={})
    kw = dict(idx=idx, dev_idx=None, cp=cp, mp=mp, mid_occ=10, device=card, mesh=mesh)
    with pytest.raises(ValueError, match="stages every collective through host memory"):
        MeshMapper(**kw)
    with pytest.raises((AssertionError, RuntimeError)) as e:
        MeshMapper(**kw, graphs=False)
    assert "host memory" not in str(e.value)
    assert tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu").graphs is True
