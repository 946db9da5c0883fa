"""End-to-end parity of the port's Mapper.map_reads_paf on the CPU: its
PAF bytes must equal the JAX Mapper's and the host oracle pipeline's.
The lite path: the 4x overflow tier, the device-resolved wide band, the
lazy wide-band pass of long-read shapes and the host fallback. The
general path (min_cnt < 2 or MM2T_NO_LITE): secondaries and s2 on a
repeat, the host rescue decision and its batched wide-band re-chain,
long-read shapes at the uncapped window, and the Python postprocess."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models.mapper import Mapper as JaxMapper  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, revcomp, simulate_reads  # noqa: E402
from minimap2_rs_torch.models import mapper as tmapper  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402

torch.set_num_threads(2)

W, K = 5, 11
SMALL = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)


@pytest.fixture(scope="module")
def small():
    genome = random_genome(60_000, seed=1)
    idx = build_index([("chrA", genome)], IndexParams(w=W, k=K))
    cp = ChainParams.defaults_for_k(K)
    return genome, idx, cp, MapParams()


def _corpus(genome):
    """Both strands, junk, empty and tiny reads, a reverse-complemented
    fragment."""
    rng = np.random.default_rng(4)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 10, read_len=(150, 450), seed=3)]
    junk = bytes(rng.choice(list(b"ACGT"), size=300).astype(np.uint8))
    rl += [("junk", junk), ("empty", b""), ("tiny", b"ACGTACGTA"),
           ("frag", genome[1000:1400]), ("rc", revcomp(genome[2000:2400]))]
    return rl


def test_port_paf_equals_jax_mapper_and_oracle(small):
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    blob = port.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **SMALL).map_reads_paf(rl)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, rl, cp, mp)
    names = {l.split("\t")[0] for l in lines}
    assert {"frag", "rc"} <= names and "junk" not in names
    assert next(l for l in lines if l.startswith("rc\t")).split("\t")[4] == "-"


def test_python_formatter_equals_native(small, monkeypatch):
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    native = port.map_reads_paf(rl)
    monkeypatch.setattr(tmapper, "native_format_lite", lambda *a, **kw: None)
    assert port.map_reads_paf(rl) == native


@pytest.mark.parametrize("missing", ["pack2", "pack2+pack4"])
def test_wire_fallbacks_equal_the_2bit_wire(small, monkeypatch, missing):
    """Without the 2-bit encoder (too many Ns) the batch takes the 4-bit
    wire; without the native runtime, the NumPy encoder."""
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    want = port.map_reads_paf(rl)
    monkeypatch.setattr(tmapper, "native_encode_pack2", lambda *a, **kw: None)
    if missing == "pack2+pack4":
        monkeypatch.setattr(tmapper, "native_encode_pack4", lambda *a, **kw: None)
    assert port.map_reads_paf(rl) == want


def test_unported_paths_raise(small, monkeypatch):
    """The general path (min_cnt=1, and MM2T_NO_LITE at the default
    min_cnt) and an even-k index (the exact scan sketch), all once
    unported, give the JAX Mapper's PAF bytes."""
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    cp1 = ChainParams.defaults_for_k(K, min_cnt=1)
    m = tmapper.Mapper.from_oracle_index(idx, cp1, mp, device="cpu", **SMALL)
    assert not m._lite_eligible()
    blob = m.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp1, mp, **SMALL).map_reads_paf(rl)
    assert blob.count(b"\n") >= 10
    monkeypatch.setenv("MM2T_NO_LITE", "1")
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    assert not m._lite_eligible()
    blob = m.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **SMALL).map_reads_paf(rl)
    assert blob.decode().split("\n")[:-1] == oracle_map(idx, rl, cp, mp)
    monkeypatch.delenv("MM2T_NO_LITE")
    idx16 = build_index([("chrA", genome[:20_000])], IndexParams(w=W, k=16))
    cp16 = ChainParams.defaults_for_k(16)
    m = tmapper.Mapper.from_oracle_index(idx16, cp16, mp, device="cpu", **SMALL)
    rl16 = rl + [("frag16", genome[3000:3400])]
    blob = m.map_reads_paf(rl16)
    assert blob == JaxMapper.from_oracle_index(idx16, cp16, mp, **SMALL).map_reads_paf(rl16)
    assert b"frag16\t" in blob


REPEAT = dict(buckets=(1024,), batch_size=32)
CP_N1M10 = ChainParams.defaults_for_k(K, min_cnt=1, min_chain_score=10)


@pytest.fixture(scope="module")
def repeat():
    """A 200 kb genome with a 3 kb segment duplicated 60 kb downstream,
    w=5, k=11, and 25 reads."""
    g = random_genome(200_000, seed=5)
    g = g[:100_000] + g[40_000:43_000] + g[100_000:]
    idx = build_index_native([("chrD", g)], IndexParams(w=W, k=K))
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 25, read_len=(500, 1000), seed=6)]
    rl += [("dup", g[40_200:41_000]), ("dup_rc", revcomp(g[41_500:42_300]))]
    return g, idx, rl


def test_general_path_secondaries_equal_jax_and_oracle(repeat):
    """align -n 1 -m 10 on a repeat: secondary lines and s2 > 0, equal to
    the JAX Mapper and the oracle."""
    _g, idx, rl = repeat
    mp = MapParams()
    port = tmapper.Mapper.from_oracle_index(idx, CP_N1M10, mp, device="cpu", **REPEAT)
    blob = port.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, CP_N1M10, mp, **REPEAT).map_reads_paf(rl)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, rl, CP_N1M10, mp)
    sec = [l for l in lines if "\ttp:A:S\t" in l]
    assert sec and any(int(l.split("s2:i:")[1].split("\t")[0]) > 0 for l in lines)
    dup = [l for l in lines if l.startswith("dup\t")]
    assert len(dup) >= 2  # the segment maps to both copies
    assert port.stats["rescue_reads"] > 0 and "rescue" in port.stats


def test_general_python_postprocess_equals_native(repeat, monkeypatch):
    """Without the native runtime the general host side runs in Python
    (oracle backtrack, per-batch rescue re-chain): same bytes."""
    _g, idx, rl = repeat
    mp = MapParams()
    port = tmapper.Mapper.from_oracle_index(idx, CP_N1M10, mp, device="cpu", **REPEAT)
    native = port.map_reads_paf(rl)
    monkeypatch.setattr(tmapper, "native_available", lambda: False)
    monkeypatch.setattr(tmapper, "native_backtrack", lambda *a, **kw: None)
    port.stats = {}
    assert port.map_reads_paf(rl) == native
    assert port.stats["rescue_reads"] > 0


def test_general_rescue_decision_equals_jax():
    """Chimeras (halves 100 kb apart) fire the host rescue decision at
    -n 1; the batched bw_long re-chain (_drain_rescues) runs, and the
    output equals the JAX Mapper's."""
    g = random_genome(300_000, seed=52)
    idx = build_index_native([("chrC", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15, min_cnt=1)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 24, read_len=(500, 1000), seed=53)]
    rng = np.random.default_rng(54)
    for ci in range(6):
        a = int(rng.integers(0, 150_000))
        rl.append((f"chim{ci}", g[a : a + 400] + g[a + 100_000 : a + 100_400]))
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **REPEAT)
    blob = port.map_reads_paf(rl)
    assert 0 < port.stats["rescue_reads"] < len(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **REPEAT).map_reads_paf(rl)


def test_general_long_read_shape_uncapped_window(monkeypatch):
    """At A >= 1024 the general path runs the full window
    min(max_chain_iter, A), not the lite cap, and equals JAX."""
    g = random_genome(400_000, seed=45)
    idx = build_index_native([("chrL", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15, min_cnt=1)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000), seed=46)]
    rl.append(("lchim", g[9000:12_000] + g[309_000:312_000]))
    kw = dict(buckets=(8192,), batch_size=8)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **kw)
    windows = []
    stage = tmapper._fused_map_stage

    def spy(*a, **k):
        windows.append((k["A"], k["window"]))
        return stage(*a, **k)

    monkeypatch.setattr(tmapper, "_fused_map_stage", spy)
    blob = port.map_reads_paf(rl)
    assert windows and all(A >= 1024 and w == min(cp.max_chain_iter, A) > tmapper.LITE_WINDOW_CAP
                           for A, w in windows)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **kw).map_reads_paf(rl)
    assert blob.count(b"\n") >= 4


def test_lite_and_general_paths_agree(small, monkeypatch):
    """At the default min_cnt the lite path and the general path give the
    same bytes (tests/test_device_pipeline.py:63-77 for JAX)."""
    genome, idx, cp, mp = small
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 8, read_len=(150, 450), seed=17)]
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    assert m._lite_eligible()
    lite = m.map_reads_paf(rl)
    monkeypatch.setenv("MM2T_NO_LITE", "1")
    assert not m._lite_eligible()
    assert m.map_reads_paf(rl) == lite
    assert lite.count(b"\n") >= 6


def test_k19_map_equals_jax_and_oracle():
    """k=19, w=10 (the map-hifi preset): the int64 sketch past k=15 and a
    38-bit key table, through the port, JAX and the oracle."""
    g = random_genome(200_000, seed=19)
    idx = build_index_native([("chrK", g)], IndexParams(w=10, k=19))
    cp = ChainParams.defaults_for_k(19)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 12, read_len=(500, 1000),
                                                error_rate=0.01, seed=20)]
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **REPEAT)
    blob = port.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **REPEAT).map_reads_paf(rl)
    assert blob.decode().split("\n")[:-1] == oracle_map(idx, rl, cp, mp)
    assert blob.count(b"\n") >= 10


def test_overflow_tier_and_wide_band_parity():
    """Undersized anchor slots force exact overflow flags and the 4x
    device tier; chimeras (halves 200 kb apart) fire the rescue flag and
    switch to the bw_long band on device."""
    g = random_genome(400_000, seed=42)
    idx = build_index_native([("chrR", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 240, read_len=(500, 1000), seed=43)]
    rng = np.random.default_rng(44)
    for ci in range(8):
        a = int(rng.integers(0, 150_000))
        rl.append((f"chim{ci}", g[a : a + 400] + g[a + 200_000 : a + 200_400]))
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", buckets=(1024,),
                                         batch_size=64, mini_frac=0.25, anchor_frac=0.04)
    assert m.map_reads(rl) == oracle_map(idx, rl, cp, mp)
    assert m.stats["tier2_reads"] >= 48   # ran the 4x device tier
    assert m.stats["wide_reads"] > 0
    assert m.stats.get("host_reads", 0) < len(rl)


def test_lazy_wide_pass_at_long_read_shapes():
    """An 8 kb bucket lands at A = 1536 >= 1024: single normal band,
    then the lazy phase-2.2 wide re-run of rescue-flagged chimeras."""
    g = random_genome(400_000, seed=45)
    idx = build_index_native([("chrL", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000), seed=46)]
    rng = np.random.default_rng(47)
    for ci in range(3):
        a = int(rng.integers(0, 80_000))
        rl.append((f"lchim{ci}", g[a : a + 3000] + g[a + 300_000 : a + 303_000]))
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", buckets=(8192,),
                                         batch_size=8)
    assert m._shapes_for(8192, 1)[1] >= 1024
    assert m.map_reads(rl) == oracle_map(idx, rl, cp, mp)
    assert m.stats["wide_reads"] > 0


def test_output_does_not_change_with_batch_size():
    g = random_genome(200_000, seed=33)
    idx = build_index_native([("c", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 48, read_len=(500, 1000), seed=34)]
    outs = [
        tmapper.Mapper.from_oracle_index(idx, cp, MapParams(), device="cpu",
                                         batch_size=bs).map_reads_paf(rl)
        for bs in (48, 8)
    ]
    assert outs[0] == outs[1]
    assert outs[0].count(b"\n") >= 40


def test_submit_thread_error_propagates(small):
    genome, idx, cp, mp = small
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)

    def _raise(*a, **kw):
        raise RuntimeError("injected submit failure")

    m._submit_groups = _raise
    with pytest.raises(RuntimeError, match="injected submit failure"):
        m.map_reads_paf(_corpus(genome))
