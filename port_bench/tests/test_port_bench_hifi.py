"""The chm13-hifi cell's own files: the hifi mix as the generator reads
it (Wenger et al. 2019's lengths and accuracy), and the two metric files
that read the prefix probe's counters (Mapper.stats: dev_probe,
probe_queries) from a hand-made run record, and read nothing from a
record of a program that keeps neither."""

import importlib.util
import json

import pytest
from conftest import ROOT

from port_bench import generate


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(name, ROOT / "port_bench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


RECORD = {
    "reads": 8000, "bases": 2_000_000_000, "window_s": 10.0, "setup_s": 42.5,
    "setup": {},
    "stats": {"dev_h2d": 0.1, "dev_sketch": 3.0, "dev_anchors": 1.0, "dev_chain": 4.0,
              "dev_d2h": 0.2, "dev_call": 9.8, "post": 1.0,
              # 3.35e12 / 32 queries take one second at the bound
              "dev_probe": 0.5, "probe_queries": 3.35e12 / 32 * 0.02},
    "trace": None,
}


def test_the_hifi_mix_has_wengers_lengths_and_accuracy():
    """The hifi mix (Wenger et al. 2019): a call's lengths lie within
    2,000-30,000 bp with a mean near 13,500 and a spread near its 2,500;
    the reads' identity has a mean near 99.8% and never passes 100%."""
    mix = json.loads((ROOT / "port_bench/traffic/hifi.json").read_text())
    lengths = generate.call_lengths(mix)
    assert lengths.shape[0] == mix["reads_per_call"] == 4000
    assert lengths.min() >= 2000 and lengths.max() <= 30000
    assert abs(lengths.mean() / 13500 - 1) < 0.01
    assert abs(lengths.std() / 2500 - 1) < 0.05
    ident = 1 - generate.call_error_rates(mix)
    assert abs(ident.mean() - 0.998) < 0.0001
    assert ident.max() <= 1.0 and ident.min() > 0.98


@pytest.mark.parametrize("name,want", [("probe_s_per_gbp", 0.25), ("probe_roofline", 4.0)])
def test_probe_metric_files(name, want):
    assert _read(name, RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", ["probe_s_per_gbp", "probe_roofline"])
def test_a_program_without_the_probe_counters_reads_nothing(name):
    assert _read(name, dict(RECORD, stats={"post": 1.0})) is None


def test_the_probe_metrics_read_nothing_on_a_direct_table():
    """A direct-table index runs no stage "probe": its stats keep neither
    dev_probe nor probe_queries, and the probe's metrics read nothing,
    as from the parent's mapper, which keeps neither."""
    direct = {k: v for k, v in RECORD["stats"].items() if "probe" not in k}
    for name in ("probe_s_per_gbp", "probe_roofline"):
        assert _read(name, dict(RECORD, stats=direct)) is None
    assert _read("probe_roofline", dict(RECORD, stats=dict(direct, dev_probe=0.5))) is None
