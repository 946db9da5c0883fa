"""Each metric file's number from a recorded run record and profiler
events, and the trace reduction itself."""

import importlib.util

import pytest
from conftest import ROOT

from port_bench import trace


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(name, ROOT / "port_bench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


class Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


S = 1_000_000_000
EVENTS = [
    Ev(trace.WINDOW, "CUDA", 1 * S, 8 * S),
    Ev(trace.WINDOW, "CPU", 0, 10 * S),
    Ev(trace.CALL + "0", "CPU", 0, 6 * S),
    Ev(trace.CALL + "1", "CPU", 6 * S, 10 * S),
    Ev("cudaGraphLaunch", "CPU", 1 * S, 1 * S + 1000),
    Ev("void chain_dp_lane_kernel<true>(int const*)", "CUDA", 1 * S, 2 * S),
    Ev("void chain_dp_short_kernel(int const*)", "CUDA", int(1.5 * S), int(2.5 * S)),
    Ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 7 * S, 8 * S),
    Ev("outside", "CUDA", 11 * S, 12 * S),
    # the device-side copy of a call's record_function range
    Ev(trace.CALL + "0", "CUDA", 1 * S, 5 * S),
]
RECORD = {
    "reads": 8000, "bases": 2_000_000_000, "window_s": 10.0, "setup_s": 42.5,
    "setup": {"index_build_s": 31.0, "index_upload_s": 19.5},
    "stats": {"host_reads": 400, "tier2_reads": 8000, "tier2": 6.0, "post": 5.0},
    "trace": trace.summarize(EVENTS),
}


def test_trace_summary():
    tr = RECORD["trace"]
    assert tr["window_s"] == 10.0
    assert tr["busy_s"] == pytest.approx(2.5)
    assert tr["op_s"]["void chain_dp_lane_kernel<true>(int const*)"] == pytest.approx(1.0)
    assert "outside" not in tr["op_s"]
    assert [round(s, 6) for _l, s in tr["gaps"]] == [4.5, 2.0, 1.0]
    assert tr["gaps"][0][0] == "call.0: host code outside torch"
    assert tr["gaps"][1][0] == "call.1: host code outside torch"


@pytest.mark.parametrize("name,want", [
    ("read_bp_per_s", 2e8), ("setup_s", 42.5), ("post_s_per_gbp", 2.5),
    ("device_idle_share", 75.0),
    ("chain_dp_s_per_gbp", 1.0), ("index_build_s", 31.0), ("index_upload_s", 19.5),
])
def test_metric_files(name, want):
    assert _read(name, RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_share", "chain_dp_s_per_gbp"])
def test_trace_metrics_read_nothing_without_a_trace(name):
    assert _read(name, dict(RECORD, trace=None)) is None
