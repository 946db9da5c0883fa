"""scaling_bench_torch.py, the port's counterpart of scaling_bench.py, on
the CPU: its key table against scaling_bench.py's own record keys, and
one cut run over gloo ranks (spawned once for the module: 1 rank, then
2) whose dp = 1, dp = 2 and sharded (1, 2) runs give the JAX oracle's
bytes, with program-only times through ReplayStandIn and the sharded
call's collective payload equal to the JAX package's count for the JAX
mesh's shapes; and the failures that must end a run."""

import ast
import hashlib
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")

import scaling_bench_torch as sbt  # noqa: E402
from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models import mapper as jmapper  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.parallel.pipeline import sharded_payload_bytes  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

READS, GENOME_KB, BATCH = 32, 60, 16
ARGV = ["--device", "cpu", "--dp", "2", "--sharded", "--reads", str(READS), "--genome-kb",
        str(GENOME_KB), "--pin-threads"]
# short reads in a 512-base bucket, 16-read calls
SIZES = dict(read_len=(200, 400), batch_size=BATCH, mapper={"buckets": (512, 1024)},
             timeout_s=300)


def _template(node) -> str:
    """A key as written: a string, or an f-string with "{dp}" for its
    one formatted value (args.dp)."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else "{dp}" for v in node.values)


def _scaling_bench_keys() -> set:
    """Every key of scaling_bench.py's record, read from its source: the
    dicts named extra and the one json.dumps prints, and extra["..."]."""
    tree = ast.parse((ROOT / "scaling_bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "extra" \
                and isinstance(node.value, ast.Dict):
            keys |= {_template(k) for k in node.value.keys}
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and \
                isinstance(node.args[0], ast.Dict):
            keys |= {_template(k) for k in node.args[0].keys if k is not None}
        elif isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "extra":
            keys.add(_template(node.slice))
    return keys


def test_key_table_covers_scaling_bench_py():
    """Every scaling_bench.py key is kept, renamed or dropped, and every
    rename and drop says why."""
    want = _scaling_bench_keys()
    assert {"metric", "t_dp{dp}_s", "program_only_dp{dp}_s", "sharded_dp_ix_s",
            "ici_payload_per_call", "predicted_ici_overhead_frac"} <= want
    assert set(sbt.KEY_TABLE) == want
    changed = {k for k, v in sbt.KEY_TABLE.items() if v != k}
    assert changed == {"ici_payload_per_call", "ici_bytes_per_read",
                       "predicted_ici_overhead_frac"}
    assert set(sbt.WHY) == changed and all(sbt.WHY.values())
    assert not set(sbt.ADDED) & set(sbt.KEY_TABLE.values())


@pytest.fixture(scope="module")
def record():
    return sbt.main(ARGV, sizes=SIZES)


def test_record_holds_every_key(record):
    assert set(record) == sbt.record_keys(2, sharded=True, held=True)
    assert record["transport"] == "gloo-cpu" and record["device"] == "cpu"
    assert record["metric"] == "mesh_scaling_efficiency" and record["dp"] == 2
    assert record["unit"] == "(t_dp1/t_dp2)/2"
    assert set(record["pass_times_s"]) == {"dp1", "dp2", "sharded"}
    assert all(len(v) == 3 for v in record["pass_times_s"].values())
    assert record["t_dp2_s"] == sorted(record["pass_times_s"]["dp2"])[1]
    assert record["value"] == record["t_dp1_s"] / record["t_dp2_s"] / 2
    assert record["reads_per_s_dp2"] == READS / record["t_dp2_s"]


def test_program_only_times_through_the_stand_in(record):
    """Every run's ranks held programs (ReplayStandIn) and replayed each
    of them in 3 timed rounds."""
    for name, rounds in record["program_rounds_s"].items():
        assert len(rounds) == 3 and min(rounds) > 0, name
    assert record["program_only_dp1_s"] == sorted(record["program_rounds_s"]["dp1"])[1]
    assert record["sharded_program_only_s"] > 0
    assert record["program_only_efficiency"] == (
        record["program_only_dp1_s"] / record["program_only_dp2_s"] / 2)


def test_every_run_gives_the_jax_oracle_bytes(record):
    """The dp = 1, dp = 2 and sharded runs gave one blob on every rank
    (the run fails otherwise); it is the JAX oracle's."""
    genome = random_genome(GENOME_KB * 1000, seed=0)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, READS, read_len=(200, 400), seed=1)]
    lines = oracle_map(build_index([("chrS", genome)], IndexParams()), rl,
                       ChainParams.defaults_for_k(15), MapParams())
    want = "".join(l + "\n" for l in lines).encode()
    assert len(lines) > READS // 2
    assert record["paf_sha256"] == hashlib.sha256(want).hexdigest()
    # the sharded run's collectives over the ix axis, the dp runs' over dp
    assert {"all_gather/ix", "all_to_all/ix", "all_gather/world"} <= set(
        record["collectives"]["sharded"])
    assert set(record["collectives"]["dp2"]) == {"all_gather/dp"}


def test_collective_payload_equals_the_jax_count(record):
    """The sharded call's payload: the JAX package's sharded_payload_bytes
    for the JAX MeshMapper's statics of that call (the bucket's M, and A
    split over the two shards, mesh_mapper.py:124), renamed."""
    pay = record["collective_payload_per_call"]
    assert set(pay) == {f"({BATCH}, 512)"}
    jm = jmapper.Mapper.from_oracle_index(
        build_index([("chrS", random_genome(GENOME_KB * 1000, seed=0))], IndexParams()),
        ChainParams.defaults_for_k(15), MapParams(), batch_size=BATCH, **SIZES["mapper"])
    M, A, _w, _B = jm._shapes_for(512, 1)
    want = sharded_payload_bytes({"M": M, "A": max(128, -(-A // 2 // 128) * 128)}, BATCH, 2)
    got = pay[f"({BATCH}, 512)"]
    assert got == {k.replace("per_device", "per_rank").replace("ici", "collective"): v
                   for k, v in want.items()}
    assert record["collective_bytes_per_read"] == want["ici_bytes_per_read"]
    assert record["collective_bytes_per_s"] == (
        want["ici_bytes_per_read"] * record["reads_per_s_dp2"])


def test_a_rank_with_other_bytes_fails_the_run():
    ok = {"blob": b"r\t1\n"}
    sbt.check_same_bytes({"dp1": [ok], "dp2": [ok, dict(ok)]})
    with pytest.raises(AssertionError, match="run sharded, rank 1: other PAF bytes"):
        sbt.check_same_bytes({"dp1": [ok], "sharded": [ok, {"blob": b""}]})
    with pytest.raises(AssertionError, match="produced no mappings"):
        sbt.check_same_bytes({"dp1": [{"blob": b""}]})


def test_nccl_ranks_need_a_card_each_and_share_device_needs_cuda():
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="--dp 2 NCCL ranks need 2 cards"):
            sbt.transport(torch.device("cuda", 0), 2, share_device=False)
    assert sbt.transport(torch.device("cuda", 0), 2, share_device=True) == (
        "gloo-shared-device")
    with pytest.raises(ValueError, match="--share-device needs --device cuda"):
        sbt.transport(torch.device("cpu"), 2, share_device=True)
    with pytest.raises(ValueError, match="--sharded needs --dp 2"):
        sbt.main(["--device", "cpu", "--dp", "1", "--sharded"])
