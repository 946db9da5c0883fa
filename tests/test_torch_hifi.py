"""The map-hifi preset (k 19, w 10) on the prefix probe at 128 slots a
key, on the CPU, held to the benchmark's plain reference
(port_bench/reference) as its harness judges a run.

The cell chm13-hifi maps HiFi reads against T2T-CHM13's 3.1 Gbp, about
565 M keys: at the prefix table's cap of 2^26 buckets, 8.4 keys a bucket
on average. A minimizer's key is the smallest hash of its windows, so
keys crowd the low buckets: a key value there is in the index whenever
its k-mer is in the genome, about (w + 1) / 2 = 5.5 times the mean
density, some 46 keys a bucket, and thousands of buckets past 64. The
planner widens bucket_slots to 128. Here a 190 kb genome in three
sequences at the same k has the same 8.4 keys a bucket under a 12-bit
cap (index_ops._MAX_PREFIX_BITS set down, the direct table off, as
tests/test_torch_chromosomes.py does), and the same crowding. Reads
come from port_bench/generate.py under the hifi mix, with fewer reads a
call.

Held: the planner's 128 slots; Mapper.map_reads_paf's lite path equal to
the reference under its pruned or exact chain DP; the same bytes on the
direct table; the probe's counter probe_queries equal to the
reference's query minimizers after its filter; and reads that overflow
their anchor slots, however few, mapped by the 4x tier on the device,
none by the host pipeline. Besides, the lite path's dv takes libm's
powf, as minimap2_rs's f32::powf does: the cell's traced run found one
read whose dv NumPy's AVX-512 float32 power gave an ulp off (0.0007 for
0.0006). Imports no JAX."""

import ctypes
import ctypes.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.models.mapper import Mapper, _dv_from_fields  # noqa: E402
from minimap2_rs_torch.models.programs import (  # noqa: E402
    ProgramCache,
    ReplayStandIn,
    program_key,
)
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402
from minimap2_rs_torch.ops.finalize_ops import FIELDS  # noqa: E402
from minimap2_rs_torch.runtime import host as thost  # noqa: E402
import bench_torch  # noqa: E402
from port_bench import generate, harness  # noqa: E402
from port_bench.reference import pipeline as rpipe  # noqa: E402
from port_bench.reference import sketch as rsketch  # noqa: E402

torch.set_num_threads(2)

W, K = 10, 19  # minimap2_rs's map-hifi (main.rs:125-133)
SEQS = [("chr1", 110_000), ("chr2", 50_000), ("chr3", 30_000)]
SEED = 2**31 + 19  # past 32 signed bits, as a run's --seed may be
N_READS = 10


def _mapper(idx, layout: str, **kw) -> Mapper:
    """A CPU mapper of the cell's parameters on the prefix probe under a
    12-bit cap ("probe") or on the planner's own direct table."""
    with pytest.MonkeyPatch.context() as mp:
        if layout == "probe":
            mp.setattr(tidx, "_DM_BYTE_CAP", 1)
            mp.setattr(tidx.plan_direct_layout, "__defaults__", (1,))
            mp.setattr(tidx, "_MAX_PREFIX_BITS", 12)
        return Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(K), MapParams(),
                                        device="cpu", batch_size=8, **kw)


@pytest.fixture(scope="module")
def hifi():
    """(genome records, index, reads, reference index, the reads' PAF
    lines on the probe layout, that mapper's stats)."""
    recs, codes = generate.genome(SEQS, SEED, "cpu")
    mix = json.loads((ROOT / "port_bench/traffic/hifi.json").read_text())
    mix["reads_per_call"] = N_READS
    reads = generate.read_pool(codes, mix, SEED, 1, "cpu")[0]
    idx = build_index_native(recs, IndexParams(w=W, k=K))
    ref = harness.reference_index(reads, recs, {"w": W, "k": K}, "cpu")
    m = _mapper(idx, "probe")
    di = m.dev_idx
    assert 8 < di.n_keys / (di.prefix.shape[0] - 1) < 9
    assert (di.dm_slots, di.bucket_slots) == (0, 128)
    blob = m.map_reads_paf(reads)
    return recs, idx, reads, ref, blob, dict(m.stats)


def _judge(ref, reads, blob) -> dict:
    by_read = harness._lines_by_read(blob)
    return harness.judge(ref, reads, [by_read.get(n, []) for n, _s in reads], io.StringIO())


def test_the_probe_layout_maps_hifi_reads_as_the_reference(hifi):
    """Every read equal to the reference as the harness judges it; every
    read mapped on the device (no tier, no host), with one batch's
    stamps per stage, the lookup's in dev_probe."""
    _recs, idx, reads, ref, blob, st = hifi
    assert 12_000 * 0.8 < sum(len(s) for _n, s in reads) / N_READS < 13_500 * 1.25
    verdict = _judge(ref, reads, blob)
    assert verdict == dict(verdict, mismatched=0, judged=N_READS)
    assert blob.count(b"\n") >= N_READS
    assert st.get("host_reads", 0) == 0 and st.get("tier2_reads", 0) == 0
    assert st["device_stages"] > 0 and st["dev_probe"] > 0 and st["dev_anchors"] > 0


def test_the_direct_table_gives_the_same_bytes(hifi):
    _recs, idx, reads, _ref, blob, _st = hifi
    m = _mapper(idx, "direct")
    assert m.dev_idx.dm_slots > 0
    assert m.map_reads_paf(reads) == blob
    assert "dev_probe" not in m.stats and "probe_queries" not in m.stats


def test_probe_queries_are_the_references_query_minimizers(hifi):
    """probe_queries counts the minimizers the stage "probe" looked up,
    padding left out: the reference's minimizers after its query filter
    (seeds.rs:13-36), read by read, where no read ran twice."""
    _recs, _idx, reads, _ref, _blob, st = hifi
    mp = MapParams()
    want = sum(len(rpipe.filter_minimizers(rsketch.query_minimizers(s, W, K),
                                           mp.q_occ_max, mp.q_occ_frac))
               for _n, s in reads)
    assert st.get("wide_reads", 0) == 0 and st.get("tier2_reads", 0) == 0
    assert st["probe_queries"] == want


def test_a_few_overflowing_reads_take_the_4x_tier_on_the_device(hifi):
    """Anchor slots cut below HiFi's density (0.156 a base of the bucket
    against about 0.175 a base of the read) overflow the reads nearest
    their bucket's top, fewer than a batch: the 4x tier maps
    them on the device, none goes to the host pipeline, and the bytes
    stay the reference's."""
    _recs, idx, reads, ref, blob, _st = hifi
    m = _mapper(idx, "probe", anchor_frac=0.156)
    got = m.map_reads_paf(reads)
    assert 0 < m.stats["tier2_reads"] < N_READS
    assert m.stats.get("host_reads", 0) == 0
    assert got == blob
    assert _judge(ref, reads, got)["mismatched"] == 0


def test_stage_times_replay_the_probe_layouts_own_program(hifi):
    """bench_torch.stage_ms_per_call (chip_smoke.py's lookup times on the
    assembly and chm13 phases) on a probe-layout mapper whose programs a
    cache captured (ReplayStandIn for the graphs): the lite program it
    times and replays is the mapper's own, the one with the stage
    "probe", and its last prefix gives that program's rows."""
    _recs, idx, reads, _ref, _blob, _st = hifi
    short = [(n, s[:900]) for n, s in reads]
    m = _mapper(idx, "probe")
    m.programs = ProgramCache("cpu", graph=ReplayStandIn)
    for _ in range(2):
        m.map_reads_paf(short)
    program = m._map_program(lite=True)
    assert program.__name__.endswith("_probe")
    host_in, st = bench_torch.lite_batch(m, short, 1024)
    captured = m.programs.programs[program_key(program, host_in, st)]
    assert captured.names[1:-1] == ("sketch", "probe", "anchors", "chain")
    ms = bench_torch.stage_ms_per_call(m, short, 1024)
    assert set(ms) == set(bench_torch.STAGES) and ms["full_call"] > 0
    rows = dict(bench_torch.stage_prefixes(st, program))["chain_finalize"](*host_in)
    mine, _stamps = m._device_stage_lite(
        *(a.numpy() for a in host_in), m._scalars, stats={},
        **{k: st[k] for k in ("wide", "M", "A", "window", "wire", "max_chain_skip")})
    assert torch.equal(rows, mine)


def _libm_powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_the_lite_dv_takes_libms_powf(monkeypatch, native):
    """runtime/host.powf equals libm's powf on 20,000 random dv inputs
    (NumPy's array power, where it dispatches AVX-512, misses about a
    tenth), through the native loop and through NumPy's scalar powers;
    and _dv_from_fields writes minimap2_rs's dv on the fields of the read
    that first showed the fault (n_match 22 of n_tot 105 at k 15:
    0.0990, where NumPy's AVX-512 power gave 0.0989)."""
    if not native:
        monkeypatch.setattr(thost, "_load", lambda: None)
    rng = np.random.default_rng(18)
    x = rng.random(20_000, dtype=np.float32)
    y = np.float32(1.0) / rng.uniform(1, 28, 20_000).astype(np.float32)
    lib_powf = _libm_powf()
    want = np.array([lib_powf(float(a), float(b)) for a, b in zip(x, y)], dtype=np.float32)
    assert np.array_equal(thost.powf(x, y), want)
    col = {name: i for i, name in enumerate(FIELDS)}
    fields = np.zeros((2, len(FIELDS)), dtype=np.int32)
    fields[:, col["n_mini"]] = 120
    fields[:, col["sum_span"]] = 120 * 15
    fields[:, col["n_match"]] = 22
    fields[:, col["n_tot"]] = 105
    fields[0, col["dv_found"]] = 1
    dv = _dv_from_fields(fields, col)
    assert dv.dtype == np.float32
    assert f"{dv[0]:.4f}" == "0.0990" and dv[1] == 0
    assert dv[0] == np.float32(1.0) - np.float32(lib_powf(22 / np.float32(105),
                                                         np.float32(1.0) / np.float32(15)))
