"""bench_torch.py, the port's counterpart of bench.py, on the CPU at a cut
size: its key table against bench.py's own keys, a whole run's record
(every key, the parity counts, the aligned bases against the JAX
package's oracle), the roofline's last prefix against the JAX package's
_fused_map_stage_lite rows, and the failures that must end a run."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench_torch as bt  # noqa: E402
from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models import mapper as jmapper  # noqa: E402
from minimap2_rs_tpu.ops.chain_ops import chain_scalars_from_params  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads  # noqa: E402
from minimap2_rs_torch import config as tconfig  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.models.mapper import Mapper, _fused_map_stage_lite  # noqa: E402
from minimap2_rs_torch.models.programs import (  # noqa: E402
    ProgramCache,
    ReplayStandIn,
    program_key,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

# bench.py's sections at a size the plain versions map in seconds: short
# reads in a 512-base bucket, 16-read calls
SIZES = {"read_len": (200, 400), "extra_genome": 100_000, "hifi": (8, (600, 900)), "hpc": 8,
         "ont": (8, (300, 450)), "even": 8, "longread_len": (1100, 1500),
         "skipprune": (8, 16, 16, 16), "chain": (8, 64, 2),
         "mapper": {"buckets": (512, 1024, 2048)}}
ARGV = ["--device", "cpu", "--reads", "32", "--genome-mb", "0.1", "--batch-size", "16",
        "--longread-n", "6", "--large-mb", "0.2", "--large-reads", "32"]
# every 16th of 32 reads, every 6th of 6, every 64th of 32
PARITY = {"default": 2, "hifi_k19": 8, "hpc": 8, "ont_10pct": 8, "even_k14": 8,
          "longread": 1, "large": 1, "skipprune": 8}


def _bench_py_keys() -> set:
    """Every key of bench.py's record, read from its source: the final
    dict, extra["..."], the parity_check tags, the roofline dict and the
    stage names of _measure_stage_floor (dotted under their dicts)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and \
                isinstance(node.slice, ast.Constant):
            prefix = {"extra": "", "roof": "roofline.",
                      "out_ms": "roofline.stage_ms_per_call."}.get(node.value.id)
            if prefix is not None:
                keys.add(prefix + node.slice.value)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "parity_check":
            keys.add(f"parity_{node.args[0].value}")
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                getattr(node.targets[0], "id", None) == "roof":
            keys |= {f"roofline.{k.value}" for k in node.value.keys}
        elif isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            keys |= {f"roofline.stage_ms_per_call.{e.elts[0].value}" for e in node.iter.elts}
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and \
                isinstance(node.args[0], ast.Dict):
            keys |= {k.value for k in node.args[0].keys if k is not None}
    return keys


def test_key_table_covers_bench_py():
    """Every bench.py key is kept, renamed or dropped, and every rename
    and drop says why."""
    want = _bench_py_keys()
    assert {"vs_baseline", "parity_skipprune", "relay_sync_ms", "chain_vpu_util",
            "roofline.headline_vs_floor", "roofline.stage_ms_per_call.full_call",
            "large_index_build_pass_stages_s"} <= want
    assert set(bt.KEY_TABLE) == want
    changed = {k for k, v in bt.KEY_TABLE.items() if v != k}
    assert changed == {"relay_sync_ms", "chain_vpu_util", "vs_baseline", "longread_vs_target",
                       "index_build_device_d2h_floor_s", "chain_util_error", "roofline_error"}
    assert set(bt.WHY) == changed and all(bt.WHY.values())
    assert not set(bt.ADDED) & set(bt.KEY_TABLE.values())


@pytest.fixture(scope="module")
def record():
    return bt.main(ARGV, sizes=SIZES)


def test_cpu_record_holds_every_key(record):
    assert bt.flat_keys(record) == bt.record_keys()
    assert record["device"] == "cpu" and record["chain_bound_share"] is None
    assert record["metric"] == "aligned_read_bp_per_s_per_chip" and record["unit"] == "bp/s"
    # no kernel launches on the CPU: every wrapper takes its plain version
    assert set(record["launches"]) == {"headline", "hifi_k19", "hpc", "ont_10pct", "even_k14",
                                       "longread", "large", "chain", "skipprune"}
    assert not any(record["launches"].values())
    stages = record["roofline"]["stage_ms_per_call"]
    assert list(stages) == list(bt.STAGES)
    assert stages["full_call"] == pytest.approx(sum(v for k, v in stages.items()
                                                    if k != "full_call"))
    assert len(record["pass_times_s"]) == 7 and len(record["pass_floor_samples_ms"]) == 8


def test_cpu_record_parity_counts(record):
    assert {t: record[f"parity_{t}"] for t in PARITY} == PARITY
    assert record["parity_reads"] == sum(v for t, v in PARITY.items() if t != "skipprune")


def test_cpu_record_aligned_bases_equal_the_jax_oracle(record):
    """The headline's aligned bases equal those of the reads the JAX
    package's oracle maps, and value is them over the median pass."""
    genome = random_genome(100_000, seed=0)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 32, read_len=(200, 400), seed=1)]
    lines = oracle_map(build_index([("chrB", genome)], IndexParams()), rl,
                       ChainParams.defaults_for_k(15), MapParams())
    names = {l.split("\t", 1)[0] for l in lines}
    want = sum(len(s) for n, s in rl if n in names)
    assert want > 0 and record["aligned_bp"] == want
    assert record["value"] == want / sorted(record["pass_times_s"])[3]


def test_chain_finalize_prefix_equals_the_jax_program_rows():
    """The roofline's chain_finalize prefix on the headline's first batch,
    element for element: the JAX package's _fused_map_stage_lite (called
    as bench.py's _measure_stage_floor calls it) and the port mapper's
    own stage give the same wire rows; and the batch's shapes and statics
    are those of a program the mapper captures (the key full_call
    replays on the card)."""
    genome = random_genome(100_000, seed=0)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 32, read_len=(200, 400), seed=1)]
    cp, mp = ChainParams.defaults_for_k(15), MapParams()
    m = Mapper.from_oracle_index(
        build_index_native([("chrB", genome)], tconfig.IndexParams()),
        tconfig.ChainParams.defaults_for_k(15), tconfig.MapParams(), device="cpu",
        batch_size=16, **SIZES["mapper"])
    host_in, st = bt.lite_batch(m, rl, 512)
    got = dict(bt.stage_prefixes(st))["chain_finalize"](*host_in)
    mine, _ready = m._device_stage_lite(
        *(a.numpy() for a in host_in), m._scalars, stats={},
        **{k: st[k] for k in ("wide", "M", "A", "window", "wire", "max_chain_skip")})
    assert torch.equal(got, mine)
    m.programs = ProgramCache("cpu", graph=ReplayStandIn)
    for _ in range(2):
        m.map_reads_paf(rl)
    assert program_key(_fused_map_stage_lite, host_in, st) in m.programs.programs

    jm = jmapper.Mapper.from_oracle_index(build_index([("chrB", genome)], IndexParams()), cp,
                                          mp, batch_size=16, **SIZES["mapper"])
    jm._ensure_meta()
    want = jmapper._fused_map_stage_lite(
        jm.dev_idx, *(jnp.asarray(a.numpy()) for a in host_in),
        chain_scalars_from_params(cp),
        chain_scalars_from_params(dataclasses.replace(cp, bw=cp.bw_long)),
        jnp.int32(jm.mid_occ), jnp.asarray(jm._tlens), jnp.int32(cp.rmq_rescue_size),
        jnp.float32(cp.rmq_rescue_ratio), q_occ_max=mp.q_occ_max, q_occ_frac=mp.q_occ_frac,
        M=st["M"], A=st["A"], window=st["window"], pallas_chain=jmapper._use_pallas_chain(),
        flag_window_ovf=st["flag_window_ovf"], wire=st["wire"], max_chain_skip=None,
        wide=st["wide"], w=st["w"], k=st["k"], hpc=False)
    assert got.shape == (16, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_dropped_paf_line_fails_the_run(monkeypatch):
    orig = Mapper.map_reads_paf

    def drop_first(self, reads):
        blob = orig(self, reads)
        return blob[blob.index(b"\n") + 1:]

    monkeypatch.setattr(Mapper, "map_reads_paf", drop_first)
    with pytest.raises(AssertionError, match=r"parity failure \[default\]"):
        bt.main(ARGV + ["--skip-extra-parity", "--skip-longread", "--skip-large"],
                sizes=SIZES)


def test_device_defaults_to_cuda_which_raises_without_a_card():
    assert bt._parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bt.main([])
