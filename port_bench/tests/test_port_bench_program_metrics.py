"""The metric files that read the mapper's own counters
(Mapper.stats: dev_sketch, dev_anchors, dev_chain, dev_idle_head/feed/
tail, chain_pairs) from a hand-made run record, and read nothing from a
record of a program that keeps none of them."""

import importlib.util

import pytest
from conftest import ROOT


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(name, ROOT / "port_bench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


RECORD = {
    "reads": 8000, "bases": 2_000_000_000, "window_s": 10.0, "setup_s": 42.5,
    "setup": {},
    "stats": {"dev_h2d": 0.1, "dev_sketch": 3.0, "dev_anchors": 1.0, "dev_chain": 4.0,
              "dev_d2h": 0.2, "dev_idle_head": 0.25, "dev_idle_feed": 0.75,
              "dev_idle_tail": 0.5, "dev_call": 9.8, "post": 1.0,
              # 67e12 / 29 pairs take one second at the bound
              "chain_pairs": 67e12 / 29 * 0.04},
    "trace": {"window_s": 10.0, "busy_s": 8.0, "gaps": [],
              "op_s": {"void chain_dp_lane_kernel<true>(int const*)": 1.5,
                       "void chain_dp_short_kernel(int const*)": 0.5,
                       "void at::native::elementwise_kernel": 3.0}},
}


@pytest.mark.parametrize("name,want", [
    ("sketch_s_per_gbp", 1.5), ("lookup_s_per_gbp", 0.5), ("chain_stage_s_per_gbp", 2.0),
    ("idle_submit_share", 10.0), ("idle_tail_share", 5.0), ("chain_dp_roofline", 2.0),
])
def test_program_metric_files(name, want):
    assert _read(name, RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", ["sketch_s_per_gbp", "lookup_s_per_gbp",
                                  "chain_stage_s_per_gbp", "idle_submit_share",
                                  "idle_tail_share", "chain_dp_roofline"])
def test_a_program_without_the_counters_reads_nothing(name):
    assert _read(name, dict(RECORD, stats={"post": 1.0})) is None


def test_the_roofline_reads_nothing_without_a_trace_or_a_chain_kernel():
    assert _read("chain_dp_roofline", dict(RECORD, trace=None)) is None
    no_kernel = dict(RECORD["trace"], op_s={"void at::native::elementwise_kernel": 3.0})
    assert _read("chain_dp_roofline", dict(RECORD, trace=no_kernel)) is None
