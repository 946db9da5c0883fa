"""`correct` comes out false for the control and for each fault the
cells can have, and true for the mapper as it is. The harness runs on
the CPU (its look for a chip skipped) with the mapper's plain PyTorch
paths, the timed path broken underneath by a wrapper. The cells have
one chip, so there is no exchange between chips to leave out."""

import io
import json
import os
import time

import pytest
import torch
from conftest import ROOT, TINY_MIX, make_root

from port_bench import control, harness


class _Wrap:
    def __init__(self, mapper):
        self.mapper = mapper
        self.last = b""

    def map_reads_paf(self, reads):
        return self.mapper.map_reads_paf(reads)


class SkipHalf(_Wrap):
    """Half of the call's reads left out: only the first half mapped."""

    def map_reads_paf(self, reads):
        return self.mapper.map_reads_paf(reads[: len(reads) // 2])


class AlteredAnswer(_Wrap):
    """Every answer altered where it is produced: the target start of each
    PAF line off by one."""

    def map_reads_paf(self, reads):
        lines = self.mapper.map_reads_paf(reads).decode().split("\n")
        out = []
        for ln in lines:
            f = ln.split("\t")
            if len(f) > 8:
                f[7] = str(int(f[7]) + 1)
            out.append("\t".join(f))
        return "\n".join(out).encode()


class StaleState(_Wrap):
    """A call that returns its state unchanged: the previous call's PAF."""

    def map_reads_paf(self, reads):
        prev, self.last = self.last, self.mapper.map_reads_paf(reads)
        return prev


class AlteredLater(AlteredAnswer):
    """Answers altered from the third call on (after the warm-up call and
    the window's first): only a repeated call of the same reads shows it."""

    def map_reads_paf(self, reads):
        self.n = getattr(self, "n", 0) + 1
        return super().map_reads_paf(reads) if self.n > 2 else self.mapper.map_reads_paf(reads)


def _run(root, wrap, seconds="0.01"):
    out, err = io.StringIO(), io.StringIO()
    harness.run(["--workload", "tiny", "--seed", "11", "--seconds", seconds, "--trace", "0"],
                root=root, t_start=time.perf_counter(), device="cpu", mapper_wrap=wrap,
                out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1])


class SeesEnv(_Wrap):
    """The mapper as it is, noting a configuration's setting at each call."""

    seen: list = []

    def map_reads_paf(self, reads):
        SeesEnv.seen.append(os.environ.get("PORT_BENCH_TEST_SETTING"))
        return self.mapper.map_reads_paf(reads)


@pytest.mark.parametrize("wrap,correct", [
    (_Wrap, True), (SkipHalf, False), (AlteredAnswer, False), (StaleState, False)])
def test_faults_come_out_not_correct(tmp_path, wrap, correct):
    res = _run(make_root(tmp_path), wrap)
    assert res["correct"] is correct
    assert (res["checks"]["mismatched_reads"]["value"] > 0) is not correct


def test_a_repeated_call_that_answers_otherwise_comes_out_not_correct(tmp_path):
    mix = dict(TINY_MIX, pool_calls=1)
    res = _run(make_root(tmp_path, mix), AlteredLater, seconds="4")
    assert res["attempted"] >= 2 * mix["reads_per_call"]
    assert res["correct"] is False and res["checks"]["mismatched_reads"]["value"] > 0


def test_bfloat16_control_comes_out_not_correct(tmp_path):
    got = control.control(make_root(tmp_path), "tiny", 5, torch.device("cpu"))
    assert got["judged"] > 0 and got["mismatched_reads"] > 0


def test_program_env_reaches_the_mapper_and_is_restored(tmp_path, monkeypatch):
    monkeypatch.delenv("PORT_BENCH_TEST_SETTING", raising=False)
    SeesEnv.seen = []
    res = _run(make_root(tmp_path, program_env={"PORT_BENCH_TEST_SETTING": "1"}), SeesEnv)
    assert res["correct"] is True and SeesEnv.seen and set(SeesEnv.seen) == {"1"}
    assert "PORT_BENCH_TEST_SETTING" not in os.environ


def test_run_py_sets_program_env_before_numpy(tmp_path, monkeypatch):
    """run.py applies the cell's program_env from the files alone, before
    it imports NumPy, and nothing for a cell it cannot find."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_bench_run", ROOT / "port_bench/run.py")
    run_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_py)
    root = make_root(tmp_path, program_env={"PORT_BENCH_TEST_SETTING": "2"})
    monkeypatch.delenv("PORT_BENCH_TEST_SETTING", raising=False)
    assert run_py.apply_program_env(root, ["--workload", "nothing"]) == {}
    assert "PORT_BENCH_TEST_SETTING" not in os.environ
    got = run_py.apply_program_env(root, ["--workload", "tiny", "--seed", "1"])
    assert got == {"PORT_BENCH_TEST_SETTING": "2"}
    assert os.environ["PORT_BENCH_TEST_SETTING"] == "2"
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    monkeypatch.delenv("NPY_DISABLE_CPU_FEATURES", raising=False)
    assert "AVX512F" in run_py.apply_program_env(ROOT, ["--workload", cell]).get(
        "NPY_DISABLE_CPU_FEATURES", "")
