"""The port's tracing on the CPU: the map programs split into the stages
sketch, anchors and chain (on the prefix-probe layout sketch, probe,
anchors and chain) give the bytes of the unsplit pipeline, eagerly and
through the program cache's stand-in graphs, with the per-batch program
counts unchanged; the drain's chain_pairs equals the pairs
utils/measure.chain_bound counts on the same chain-DP calls; the card's
idle split adds up with the batches' stamps to the call's span (here on
host-clock stamps); span() opens its profiler range only under a profiler,
and a profile of all threads shows the submit thread's spans."""

import json

import numpy as np
import pytest
import torch

from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.kernels import chain_dp as kchain
from minimap2_rs_torch.models import mapper as tmapper
from minimap2_rs_torch.models import stages as tstages
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.programs import (
    Clock,
    ProgramCache,
    ReplayStandIn,
    idle_split,
    program_stages,
    run_eager,
)
from minimap2_rs_torch.ops import index_ops as tidx
from minimap2_rs_torch.runtime.host import native_sketch_array
from minimap2_rs_torch.utils import measure, profiling
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

torch.set_num_threads(2)

W, K = 5, 11
SMALL = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)
# the busy, head, feed and tail seconds must add up to the call's span
# within this much per batch
SLACK_S = 1e-6


@pytest.fixture(scope="module")
def small():
    genome = random_genome(60_000, seed=11)
    idx = build_index_native([("chrT", genome)], IndexParams(w=W, k=K))
    return genome, idx, ChainParams.defaults_for_k(K), MapParams()


def _reads(genome, n, seed, lo=150, hi=450):
    rl = [(nm, s) for nm, s, *_ in simulate_reads(genome, n, read_len=(lo, hi), seed=seed)]
    # an N in some reads: the 2-bit wire's exception list
    return [(nm, s[:40] + b"N" + s[41:] if i % 3 == 0 else s) for i, (nm, s) in enumerate(rl)]


def _long_set():
    """A long-read shape (A >= 1024: one band, the lazy wide pass) on a
    400 kb genome at k 15, with chimeras whose halves lie 300 kb apart."""
    g = random_genome(400_000, seed=45)
    idx = build_index_native([("chrL", g)], IndexParams())
    rng = np.random.default_rng(47)
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000), seed=46)]
    rl += [(f"lchim{c}", g[a: a + 3000] + g[a + 300_000: a + 303_000])
           for c, a in enumerate(rng.integers(0, 80_000, size=3).tolist())]
    return idx, ChainParams.defaults_for_k(15), rl, dict(buckets=(8192,), batch_size=8)


# ---- the staged programs ----------------------------------------------------

def _unsplit_lite(codes, lengths, nex, **st):
    """The lite program as one function, as it was before the split."""
    codes = tstages.wire_codes(codes, lengths, nex, st["wire"])
    anc = tstages.sketch_to_anchors(
        st["dev_idx"], codes, lengths, st["mid_occ"], w=st["w"], k=st["k"],
        q_occ_max=st["q_occ_max"], q_occ_frac=st["q_occ_frac"], M=st["M"], A=st["A"])
    return tstages.chain_finalize_lite(
        anc, lengths, st["scalars"], st["scalars_wide"], st["tlens"],
        st["rmq_rescue_size"], st["rmq_rescue_ratio"], k=st["k"], window=st["window"],
        log2_tab=st["log2_tab"], flag_window_ovf=st["flag_window_ovf"],
        max_chain_skip=st["max_chain_skip"], wide=st["wide"])


def _unsplit_general(codes, lengths, nex, **st):
    """The general program as one function, as it was before the split."""
    codes = tstages.wire_codes(codes, lengths, nex, st["wire"])
    anc = tstages.sketch_to_anchors(
        st["dev_idx"], codes, lengths, st["mid_occ"], w=st["w"], k=st["k"],
        q_occ_max=st["q_occ_max"], q_occ_frac=st["q_occ_frac"], M=st["M"], A=st["A"])
    f, prev = kchain.chain_dp_batch(
        *tstages.chain_inputs(anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"]),
        st["scalars"], st["window"], st["log2_tab"], st["max_chain_skip"])
    words = [tmapper.as_i32(anc[c]) for c in ("x_hi", "x_lo", "y_hi", "y_lo")]
    flags = [anc[c].to(torch.int32)[:, None]
             for c in ("n_mini", "n_anchors", "mini_ovf", "anc_ovf")]
    return torch.cat(words + [f, prev, tmapper.as_i32(anc["cps"])] + flags, dim=1)


def _batches(m, genome, wire, bucket=512):
    """Three padded host batches of one bucket and shape, of different
    reads, on the 2-bit or the 4-bit wire."""
    out = []
    for i in range(3):
        seqs = [s for _n, s in _reads(genome, 6, seed=30 + i, lo=200, hi=bucket)]
        B = m._quantize_b(len(seqs), m._shapes_for(bucket, 1)[3])
        lengths = np.zeros(B, dtype=np.int32)
        lengths[: len(seqs)] = [len(s) for s in seqs]
        if wire == "2bit":
            wire_arr, nex, got = m._encode(seqs, B, bucket)
            assert got == "2bit"
        else:
            wire_arr = m._encode4(seqs + [b""] * (B - len(seqs)), B, bucket)
            nex = np.zeros(1, dtype=np.int32)
        out.append(tuple(map(torch.from_numpy, (wire_arr, lengths, nex))))
    return out


def _statics(m, path, wire, bucket=512):
    M, A, window, _B = m._shapes_for(bucket, 1)
    if path == "lite":
        return m._map_program(lite=True), _unsplit_lite, m._lite_statics(
            m._scalars, wide=True, M=M, A=A, window=window, wire=wire, max_chain_skip=None)
    return m._map_program(lite=False), _unsplit_general, dict(
        dev_idx=m.dev_idx, scalars=m._scalars, mid_occ=m.mid_occ, log2_tab=m._log2_tab,
        M=M, A=A, window=window, wire=wire, max_chain_skip=None, **m._stage_kw())


@pytest.mark.parametrize("path", ["lite", "general"])
@pytest.mark.parametrize("wire", ["2bit", "4bit"])
def test_staged_programs_equal_the_unsplit_pipeline(small, path, wire):
    """Each program's three stages, called through the fused function,
    run_eager and the cache's stand-in graphs (eager, captured, replayed),
    give the unsplit pipeline's bytes on three batches of one key; the
    cache counts one program per batch and keeps one graph per stage."""
    genome, idx, cp, mp = small
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    fn, unsplit, st = _statics(m, path, wire)
    assert [name for name, _s in program_stages(fn)] == ["sketch", "anchors", "chain"]
    cache, stats = ProgramCache("cpu", graph=ReplayStandIn), {}
    outs = set()
    for batch in _batches(m, genome, wire):
        want = unsplit(*batch, **st)
        assert torch.equal(fn(*batch, **st), want)
        eager, stamps = run_eager(fn, batch, {}, Clock("cpu"), **st)
        assert torch.equal(eager, want)
        assert stamps.names == ("h2d", "sketch", "anchors", "chain", "d2h")
        assert len(stamps.marks) == 5 + 1 and stamps.ready is None
        got, stamps = cache.run(fn, batch, stats, **st)
        assert torch.equal(got, want)
        assert len(stamps.marks) == 6
        outs.add(tuple(want.flatten().tolist()))
    assert len(outs) == 3
    assert {k: stats[k] for k in ("eager_stages", "graph_captures", "graph_replays")} == {
        "eager_stages": 1, "graph_captures": 1, "graph_replays": 2}
    (prog,) = cache.programs.values()
    assert len(prog.graphs) == 3 and len(prog.stage_launches) == 3
    assert prog.launches == [e for rec in prog.stage_launches for e in rec]


@pytest.mark.parametrize("path", ["lite", "general"])
def test_the_probe_layout_runs_the_lookup_as_a_stage_of_its_own(small, monkeypatch, path):
    """Without a direct table (the prefix probe, as on a human-sized
    index) the map programs run four stages, the lookup ("probe") apart
    from the expansion and sort ("anchors"), with the unsplit pipeline's
    bytes eagerly and through the stand-in graphs; a mapping pass stamps
    dev_probe and counts probe_queries, the reads' minimizers. On the
    direct table the programs keep their three stages and neither key
    appears; the PAF bytes are the same."""
    genome, idx, cp, mp = small
    if path == "general":
        cp = ChainParams.defaults_for_k(K, min_cnt=1, min_chain_score=10)
    direct = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    monkeypatch.setattr(tidx, "_DM_BYTE_CAP", 1)
    monkeypatch.setattr(tidx.plan_direct_layout, "__defaults__", (1,))
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    assert direct.dev_idx.dm_slots > 0 and m.dev_idx.dm_slots == 0
    assert [n for n, _s in program_stages(_statics(direct, path, "2bit")[0])] == [
        "sketch", "anchors", "chain"]
    fn, unsplit, st = _statics(m, path, "2bit")
    assert [n for n, _s in program_stages(fn)] == ["sketch", "probe", "anchors", "chain"]
    cache, stats = ProgramCache("cpu", graph=ReplayStandIn), {}
    for batch in _batches(m, genome, "2bit"):
        want = unsplit(*batch, **st)
        assert torch.equal(fn(*batch, **st), want)
        got, stamps = cache.run(fn, batch, stats, **st)
        assert torch.equal(got, want)
        assert stamps.names == ("h2d", "sketch", "probe", "anchors", "chain", "d2h")
    rl = _reads(genome, 12, seed=13)
    blob = m.map_reads_paf(rl)
    assert blob == direct.map_reads_paf(rl) and blob.count(b"\n") >= 8
    assert m.stats["dev_probe"] > 0
    assert "dev_probe" not in direct.stats and "probe_queries" not in direct.stats
    assert direct.stats["dev_anchors"] > 0
    # every read ran once (no tier 2, no wide pass): one probe a minimizer
    assert not m.stats.get("tier2_reads") and not m.stats.get("wide_reads")
    n_mini = sum(len(native_sketch_array(s, W, K)) for _n, s in rl)
    assert m.stats["probe_queries"] == n_mini


def test_evictions_and_recaptures_are_counted():
    """graph_evictions counts the least recently used programs dropped;
    graph_recaptures the captures of a key captured before (one for each
    of the three keys, each captured again after its eviction)."""
    cache, stats = ProgramCache("cpu", graph=ReplayStandIn, max_programs=2), {}
    for i, n in enumerate([2, 3, 2, 3, 4, 4, 2, 3, 3, 4]):
        out, _stamps = cache.run(lambda x, *, n: x * n, (torch.arange(5) + i,), stats, n=n)
        assert torch.equal(out, (torch.arange(5) + i) * n)
    assert stats["graph_captures"] == 6 and stats["graph_evictions"] == 4
    assert stats["graph_recaptures"] == 3


# ---- the counters -----------------------------------------------------------

def _pairs_spy(monkeypatch, module, name, n_out, calls):
    """Wrap module.name (a chain DP) so that each call adds the pairs
    utils/measure.chain_bound counts on its inputs to `calls`."""
    real = getattr(module, name)

    def spy(grp, rpos, qpos, span, scal, window, tab, skip=None):
        calls.append(measure.chain_bound((grp, rpos, qpos, span), scal, window, n_out, tab,
                                         skip)[2])
        return real(grp, rpos, qpos, span, scal, window, tab, skip)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("case", ["two bands", "one band", "general"])
def test_chain_pairs_equal_chain_bound(small, monkeypatch, case):
    """stats["chain_pairs"] equals the sum of chain_bound's pairs over the
    chain-DP calls the pass made: two a batch where the lite program runs
    both bands (A < 1024), one a batch of a long-read shape and of its
    lazy wide pass, one on the general path and its rescue re-chain;
    anchors is the sum of the batches' n_anchors."""
    genome, idx, cp, mp = small
    kw = SMALL
    if case == "one band":
        idx, cp, rl, kw = _long_set()
    else:
        rl = _reads(genome, 20, seed=5)
        rng = np.random.default_rng(6)
        rl += [(f"chim{c}", genome[a: a + 200] + genome[a + 30_000: a + 30_200])
               for c, a in enumerate(rng.integers(0, 20_000, size=4).tolist())]
    if case == "general":
        cp = ChainParams.defaults_for_k(K, min_cnt=1, min_chain_score=10)
    calls: list = []
    _pairs_spy(monkeypatch, tstages, "chain_dp_aux_batch", 4, calls)
    _pairs_spy(monkeypatch, tmapper, "chain_dp_batch", 2, calls)
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **kw)
    assert m.map_reads_paf(rl).count(b"\n") >= 4
    st = m.stats
    assert st["chain_pairs"] == sum(calls) > 0
    assert st["anchors"] > 0
    if case == "two bands":
        assert len(calls) == 2 * st["device_stages"]
    else:
        assert len(calls) == st["device_stages"]
    if case == "one band":
        assert st["wide_reads"] > 0
    if case == "general":
        assert st["rescue_reads"] > 0


def test_window_pairs_counts_each_anchors_predecessors():
    """window_pairs: sum over i < n of min(i, H), on arrays and tensors."""
    n = np.array([0, 1, 2, 5, 6, 7, 40], dtype=np.int64)
    want = [sum(min(i, 5) for i in range(v)) for v in n.tolist()]
    assert measure.window_pairs(n, 5).tolist() == want
    assert measure.window_pairs(torch.from_numpy(n), 5).tolist() == want


# ---- the idle split ---------------------------------------------------------

BUSY = ("dev_h2d", "dev_sketch", "dev_anchors", "dev_chain", "dev_d2h", "dev_rechain")
IDLE = ("dev_idle_head", "dev_idle_feed", "dev_idle_tail")


@pytest.mark.parametrize("how", ["eager", "stand-in", "one band", "general"])
def test_idle_split_adds_up_to_the_call_on_host_stamps(small, how):
    """Per call, the batches' busy seconds (every dev_ span) and the idle
    head, feed and tail add up to the call's span (dev_call), within a
    microsecond a batch, on two calls; each part is at least 0."""
    genome, idx, cp, mp = small
    kw, rl = SMALL, _reads(genome, 30, seed=8)
    if how == "one band":
        idx, cp, rl, kw = _long_set()
    if how == "general":
        cp = ChainParams.defaults_for_k(K, min_cnt=1, min_chain_score=10)
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **kw)
    if how == "stand-in":
        m.programs = ProgramCache("cpu", graph=ReplayStandIn)
    for _call in range(2):
        m.stats = {}
        m.map_reads_paf(rl)
        st = m.stats
        busy = sum(st.get(k, 0.0) for k in BUSY)
        assert busy > 0 and all(st[k] >= 0 for k in IDLE)
        assert abs(busy + sum(st[k] for k in IDLE) - st["dev_call"]) <= (
            SLACK_S * st["device_stages"])
        assert st["dev_call"] <= st["map_reads_paf"]
        assert set(BUSY[:5]) <= set(st)


def test_idle_split_assigns_each_gap():
    """head: before the first batch; feed: before a later fed batch; tail:
    before a batch the submit thread did not feed, and after the last.
    Overlapping batches break the sum, as they would on two streams."""
    got = idle_split(10.0, [(1.0, 2.0, True), (2.5, 4.0, True), (6.0, 7.0, False),
                            (4.0, 5.0, True)])
    assert got == pytest.approx({"dev_idle_head": 1.0, "dev_idle_feed": 0.5,
                                 "dev_idle_tail": 4.0})
    assert idle_split(3.0, []) == {"dev_idle_head": 0.0, "dev_idle_feed": 0.0,
                                   "dev_idle_tail": 3.0}
    over = [(1.0, 3.0, True), (2.0, 4.0, True)]
    parts = idle_split(5.0, over)
    assert sum(e - s for s, e, _f in over) + sum(parts.values()) > 5.0


# ---- spans ------------------------------------------------------------------

def test_span_adds_seconds_and_opens_a_range_only_under_a_profiler(monkeypatch):
    stats = {}
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.span(stats, "x"):
        pass
    assert opened == [] and stats["x"] >= 0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(stats, "x") as sp:
            pass
    assert opened == ["mm2t.x"] and sp.seconds >= 0
    assert "mm2t.x" in {e.name for e in prof.events()}
    with profiling.span(stats, "x"):
        pass
    assert opened == ["mm2t.x"]


def test_a_profile_of_all_threads_shows_the_submit_thread(small, tmp_path):
    """utils/profiling.device_trace profiles every thread: its trace holds
    the submit thread's mm2t.encode beside the calling thread's
    mm2t.map_reads_paf, on another thread."""
    genome, idx, cp, mp = small
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    with profiling.device_trace(str(tmp_path), m.device):
        m.map_reads_paf(_reads(genome, 10, seed=9))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name", "").startswith("mm2t."):
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert {"mm2t.map_reads_paf", "mm2t.encode", "mm2t.submit", "mm2t.post",
            "mm2t.group", "mm2t.join", "mm2t.paf"} <= set(tids)
    assert not tids["mm2t.encode"] & tids["mm2t.map_reads_paf"]


def test_stats_line_prints_counters_as_integers():
    import io

    out = io.StringIO()
    profiling.print_stage_stats({"post": 1.5, "anchors": 12, "chain_pairs": 3400,
                                 "graph_evictions": 2, "graph_recaptures": 1,
                                 "h2d_bytes": 4096, "wide_reads": 3,
                                 "device_stages": 7, "dev_sketch": 0.25, "capture": 0.5},
                                n_reads=10, total_bp=1000, dt=2.0, file=out)
    line = out.getvalue()
    for part in ("post:1.50s", "anchors:12 ", "chain_pairs:3400", "graph_evictions:2",
                 "graph_recaptures:1",
                 "h2d_bytes:4096", "wide_reads:3", "device_stages:7", "dev_sketch:0.25s",
                 "capture:0.50s"):
        assert part in line
