"""Shared set-up of the benchmark's CPU tests: the checkout's root on
sys.path, and a scratch checkout holding a copy of port_bench and a
BENCHMARK.json with one tiny cell added, which the harness runs on the
CPU (the mapper's plain PyTorch paths) in a few seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MIX = {
    "reads_per_call": 8, "pool_calls": 2, "warmup_passes": 1,
    "lengths": {"dist": "uniform", "min": 500, "max": 1000}, "length_seed": 1,
    "error_rate": 0.05, "indel_share": 0.5, "reverse_share": 0.5,
    "check_reads": {"uniform": 6, "per_path": 2},
}


def make_root(dst: Path, mix: dict = TINY_MIX, cell: str = "tiny",
              program_env: dict | None = None) -> Path:
    """A checkout at dst: port_bench copied, a config of two sequences
    (120 and 80 kb, with `program_env` where given) and the mix as new
    files, the cell added to a copy of BENCHMARK.json and to every
    per-layer metric's cells."""
    shutil.copytree(ROOT / "port_bench", dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = {"name": "tiny-cfg", "k": 15, "w": 10, "reduced": [],
           "sequences": [["s1", 120000], ["s2", 80000]]}
    if program_env:
        cfg["program_env"] = program_env
    (dst / "port_bench/configs/tiny-cfg.json").write_text(json.dumps(cfg))
    (dst / f"port_bench/traffic/{cell}.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-cfg", "source": "https://example.org/tiny",
                             "file": "port_bench/configs/tiny-cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "tiny-cfg", "traffic": cell,
                               "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
