"""End-to-end parity of the port's Mapper.map_reads_paf on the CPU at even
k (the exact-scan sketch through the window-scan kernel's plain version)
and under MM2T_SKIP_PRUNE=1 (the pruned chain DPs) on the lite and
general paths: the PAF bytes equal the JAX Mapper's and the host
oracle's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models.mapper import Mapper as JaxMapper  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, revcomp, simulate_reads  # noqa: E402
from minimap2_rs_torch.models import mapper as tmapper  # noqa: E402
from minimap2_rs_torch.models import stages as tstages  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402

torch.set_num_threads(2)

KW = dict(buckets=(512, 1024), batch_size=16, mini_frac=0.6, anchor_frac=1.0)


@pytest.mark.parametrize("k", [14, 16])
def test_even_k_map_equals_jax_and_oracle(k):
    g = random_genome(120_000, seed=k, n_frac=0.001)
    idx = build_index_native([("chrE", g)], IndexParams(w=10, k=k))
    cp = ChainParams.defaults_for_k(k)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 16, read_len=(300, 900), seed=k + 1)]
    rl += [("frag", g[5000:5600]), ("rc", revcomp(g[9000:9700]))]
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **KW)
    blob = port.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **KW).map_reads_paf(rl)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, rl, cp, mp)
    assert len(lines) >= 14


@pytest.fixture(scope="module")
def repeats():
    """tests/test_chain_skip_prune.py:198-231's repeat-dense genome: a
    4 kb base and six 1.28 kb tandem arrays of one 160 bp unit between
    1.5 kb random spacers, w=5, k=15, where the pruning binds."""
    rng = np.random.default_rng(11)
    base = np.frombuffer(random_genome(4000, seed=12), dtype=np.uint8)
    unit = np.frombuffer(random_genome(160, seed=13), dtype=np.uint8)
    parts = [base]
    for _ in range(6):
        parts += [np.tile(unit, 8), np.frombuffer(
            random_genome(1500, seed=int(rng.integers(1 << 30))), dtype=np.uint8)]
    genome = b"".join(p.tobytes() for p in parts)
    idx = build_index([("chrR", genome)], IndexParams(w=5, k=15))
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 16, read_len=(300, 900), seed=14)]
    return idx, rl


@pytest.mark.parametrize("path", ["lite", "general"])
def test_skip_prune_map_equals_jax_and_oracle(repeats, path, monkeypatch):
    """MM2T_SKIP_PRUNE=1: every chain DP call runs pruned, and the bytes
    equal the JAX Mapper's and the (always-pruning) default oracle's."""
    idx, rl = repeats
    cp = ChainParams.defaults_for_k(15)
    if path == "general":
        cp = ChainParams.defaults_for_k(15, min_cnt=1, min_chain_score=10)
    mp = MapParams()
    kw = dict(buckets=(512, 1024), batch_size=8, mini_frac=0.6, anchor_frac=2.0)
    skips = []
    for mod, name in ((tstages, "chain_dp_aux_batch"), (tmapper, "chain_dp_batch")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, **k: (
            skips.append(a[7] if len(a) > 7 else k.get("max_chain_skip")), _fn(*a, **k))[1])
    monkeypatch.setenv("MM2T_SKIP_PRUNE", "1")
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **kw)
    assert port._lite_eligible() == (path == "lite")
    blob = port.map_reads_paf(rl)
    assert skips and set(skips) == {cp.max_chain_skip}
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **kw).map_reads_paf(rl)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, rl, cp, mp)
    assert len(lines) >= 10
