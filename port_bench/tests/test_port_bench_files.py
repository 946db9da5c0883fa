"""BENCHMARK.json against the benchmark's contract, and a cell, a mix
and a metric added as new files alone being found by name."""

import io
import json
import re
import time

from conftest import ROOT, make_root

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_names_and_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and b["command"][1] == "port_bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["k"] % 2 == 1
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (ROOT / "port_bench/traffic" / f"{w['traffic']}.json").exists()
    assert {w["config"] for w in b["workloads"]} == set(configs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "port_bench/metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200


def test_new_cell_mix_and_metric_are_found_as_new_files(tmp_path):
    root = make_root(tmp_path)
    (root / "port_bench/metrics/calls_in_window.py").write_text(
        "def read(rec):\n    return float(rec['calls'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "read_bp_per_s", "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, err = io.StringIO(), io.StringIO()
    harness.run(["--workload", "tiny", "--seed", "7", "--seconds", "0.01", "--trace", "1"],
                root=root, t_start=time.perf_counter(), device="cpu", out=out, err=err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["calls_in_window"]["value"] >= 1
    assert list(res)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1] == "check mismatched_reads 0 limit 0"
