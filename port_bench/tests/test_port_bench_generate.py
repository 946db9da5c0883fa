"""The input generator: deterministic in the seed, and its lengths,
errors and strands as the traffic file sets them."""

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from port_bench import generate

SEQS = [("a", 300000), ("b", 200000), ("c", 70000)]
SEED = 2**31 + 12345  # past 32 signed bits, as a run's --seed may be


def _mix(**kw):
    mix = json.loads((ROOT / "port_bench/traffic/ont.json").read_text())
    mix.update(reads_per_call=300, **kw)
    if "error_rate" in kw:
        mix.pop("identity")
    return mix


def _make(seed, mix, calls=2, truth=None):
    recs, codes = generate.genome(SEQS, seed, "cpu")
    return recs, generate.read_pool(codes, mix, seed, calls, "cpu", truth)


def test_same_seed_same_inputs_other_seed_other_inputs():
    mix = _mix()
    a, b, c = _make(SEED, mix), _make(SEED, mix), _make(SEED + 1, mix)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]
    assert [len(s) for _n, s in a[0]] == [n for _s, n in SEQS]
    assert set(b"".join(s for _n, s in a[0])) == set(b"ACGT")


MIXES = sorted(p.stem for p in (ROOT / "port_bench/traffic").glob("*.json"))
SPECS = [
    {"dist": "gamma", "mean": 15000, "stdev": 13000, "min": 1, "max": 10**9},
    {"dist": "lognormal", "median": 6000, "sigma": 0.9, "min": 1, "max": 10**9},
    {"dist": "uniform", "min": 500, "max": 1000},
]


@pytest.mark.parametrize("name", MIXES)
def test_every_call_holds_the_mix_lengths(name):
    mix = json.loads((ROOT / f"port_bench/traffic/{name}.json").read_text())
    lengths = generate.call_lengths(mix)
    spec = mix["lengths"]
    assert lengths.shape[0] == mix["reads_per_call"]
    assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]
    mix = dict(mix, reads_per_call=200)
    truth: list = []
    _make(SEED, mix, calls=2, truth=truth)
    want = np.sort(generate.call_lengths(mix))
    rates = np.sort(generate.call_error_rates(mix))
    for t in truth:
        assert np.array_equal(np.sort(t["span"].numpy()), want)
        assert np.array_equal(np.sort(t["err"].numpy()), rates)


@pytest.mark.parametrize("spec", SPECS, ids=[s["dist"] for s in SPECS])
def test_length_distributions_have_their_parameters(spec):
    got = generate.call_lengths({"lengths": spec, "reads_per_call": 20000, "length_seed": 3})
    assert got.min() >= spec["min"] and got.max() <= spec["max"]
    if spec["dist"] == "gamma":
        assert abs(got.mean() / spec["mean"] - 1) < 0.03
        assert abs(got.std() / spec["stdev"] - 1) < 0.05
    elif spec["dist"] == "lognormal":
        assert abs(np.median(got) / spec["median"] - 1) < 0.03
        assert abs(np.log(got).std() / spec["sigma"] - 1) < 0.03
    else:
        assert abs(got.mean() / ((spec["min"] + spec["max"]) / 2) - 1) < 0.01


def test_identity_is_badreads_beta():
    spec = {"dist": "beta", "mean": 0.95, "max": 0.99, "stdev": 0.025}
    ident = 1 - generate.call_error_rates({"identity": spec, "reads_per_call": 20000,
                                           "length_seed": 3})
    assert ident.max() <= spec["max"] and ident.min() > 0
    assert abs(ident.mean() - spec["mean"]) < 0.001
    assert abs(ident.std() / spec["stdev"] - 1) < 0.05
    fixed = generate.call_error_rates({"error_rate": 0.05, "reads_per_call": 7})
    assert np.array_equal(fixed, np.full(7, 0.05))


def test_error_free_reads_are_the_genome_or_its_reverse_complement():
    mix = _mix(error_rate=0.0)
    truth: list = []
    recs, pool = _make(SEED, mix, calls=1, truth=truth)
    t = truth[0]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for (_n, seq), rid, st, sp, rev in zip(pool[0], t["rid"], t["start"], t["span"], t["rev"]):
        src = recs[int(rid)][1][int(st):int(st) + int(sp)]
        assert int(st) + int(sp) <= len(recs[int(rid)][1])
        assert seq == (src.translate(comp)[::-1] if bool(rev) else src)
    n = len(pool[0])
    assert abs(t["rev"].float().mean().item() - 0.5) < 4 * (0.25 / n) ** 0.5


def test_errors_match_the_mix():
    mix = _mix()
    truth: list = []
    _recs, pool = _make(SEED, mix, calls=2, truth=truth)
    ind = mix["indel_share"]
    for t, call in zip(truth, pool):
        eb = float((t["err"] * t["span"]).sum())  # expected errors, read by read
        for key, p in (("sub", 1 - ind), ("dele", ind / 2), ("ins", ind / 2)):
            got = int(t[key].sum())
            assert abs(got - p * eb) < 5 * (p * eb) ** 0.5, key
        qlen = torch.tensor([len(s) for _n, s in call])
        assert torch.equal(qlen, t["span"] - t["dele"] + t["ins"])
