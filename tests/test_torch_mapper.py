"""End-to-end parity of the port's Mapper.map_reads_paf on the CPU: its
PAF bytes must equal the JAX Mapper's and the host oracle pipeline's,
including the 4x overflow tier, the device-resolved wide band, the lazy
wide-band pass of long-read shapes and the host fallback."""

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
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402

torch.set_num_threads(2)

W, K = 5, 11
SMALL = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)


@pytest.fixture(scope="module")
def small():
    genome = random_genome(60_000, seed=1)
    idx = build_index([("chrA", genome)], IndexParams(w=W, k=K))
    cp = ChainParams.defaults_for_k(K)
    return genome, idx, cp, MapParams()


def _corpus(genome):
    """Both strands, junk, empty and tiny reads, a reverse-complemented
    fragment."""
    rng = np.random.default_rng(4)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, 10, read_len=(150, 450), seed=3)]
    junk = bytes(rng.choice(list(b"ACGT"), size=300).astype(np.uint8))
    rl += [("junk", junk), ("empty", b""), ("tiny", b"ACGTACGTA"),
           ("frag", genome[1000:1400]), ("rc", revcomp(genome[2000:2400]))]
    return rl


def test_port_paf_equals_jax_mapper_and_oracle(small):
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    blob = port.map_reads_paf(rl)
    assert blob == JaxMapper.from_oracle_index(idx, cp, mp, **SMALL).map_reads_paf(rl)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, rl, cp, mp)
    names = {l.split("\t")[0] for l in lines}
    assert {"frag", "rc"} <= names and "junk" not in names
    assert next(l for l in lines if l.startswith("rc\t")).split("\t")[4] == "-"


def test_python_formatter_equals_native(small, monkeypatch):
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    native = port.map_reads_paf(rl)
    monkeypatch.setattr(tmapper, "native_format_lite", lambda *a, **kw: None)
    assert port.map_reads_paf(rl) == native


@pytest.mark.parametrize("missing", ["pack2", "pack2+pack4"])
def test_wire_fallbacks_equal_the_2bit_wire(small, monkeypatch, missing):
    """Without the 2-bit encoder (too many Ns) the batch takes the 4-bit
    wire; without the native runtime, the NumPy encoder."""
    genome, idx, cp, mp = small
    rl = _corpus(genome)
    port = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    want = port.map_reads_paf(rl)
    monkeypatch.setattr(tmapper, "native_encode_pack2", lambda *a, **kw: None)
    if missing == "pack2+pack4":
        monkeypatch.setattr(tmapper, "native_encode_pack4", lambda *a, **kw: None)
    assert port.map_reads_paf(rl) == want


def test_unported_paths_raise(small, monkeypatch):
    genome, idx, cp, mp = small
    rl = _corpus(genome)[:2]
    m = tmapper.Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(K, min_cnt=1),
                                         mp, device="cpu", **SMALL)
    with pytest.raises(NotImplementedError):
        m.map_reads_paf(rl)
    monkeypatch.setenv("MM2T_NO_LITE", "1")
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)
    with pytest.raises(NotImplementedError):
        m.map_reads_paf(rl)


def test_overflow_tier_and_wide_band_parity():
    """Undersized anchor slots force exact overflow flags and the 4x
    device tier; chimeras (halves 200 kb apart) fire the rescue flag and
    switch to the bw_long band on device."""
    g = random_genome(400_000, seed=42)
    idx = build_index_native([("chrR", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 240, read_len=(500, 1000), seed=43)]
    rng = np.random.default_rng(44)
    for ci in range(8):
        a = int(rng.integers(0, 150_000))
        rl.append((f"chim{ci}", g[a : a + 400] + g[a + 200_000 : a + 200_400]))
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", buckets=(1024,),
                                         batch_size=64, mini_frac=0.25, anchor_frac=0.04)
    assert m.map_reads(rl) == oracle_map(idx, rl, cp, mp)
    assert m.stats["tier2_reads"] >= 48   # ran the 4x device tier
    assert m.stats["wide_reads"] > 0
    assert m.stats.get("host_reads", 0) < len(rl)


def test_lazy_wide_pass_at_long_read_shapes():
    """An 8 kb bucket lands at A = 1536 >= 1024: single normal band,
    then the lazy phase-2.2 wide re-run of rescue-flagged chimeras."""
    g = random_genome(400_000, seed=45)
    idx = build_index_native([("chrL", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000), seed=46)]
    rng = np.random.default_rng(47)
    for ci in range(3):
        a = int(rng.integers(0, 80_000))
        rl.append((f"lchim{ci}", g[a : a + 3000] + g[a + 300_000 : a + 303_000]))
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", buckets=(8192,),
                                         batch_size=8)
    assert m._shapes_for(8192, 1)[1] >= 1024
    assert m.map_reads(rl) == oracle_map(idx, rl, cp, mp)
    assert m.stats["wide_reads"] > 0


def test_output_does_not_change_with_batch_size():
    g = random_genome(200_000, seed=33)
    idx = build_index_native([("c", g)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    rl = [(n, s) for n, s, *_ in simulate_reads(g, 48, read_len=(500, 1000), seed=34)]
    outs = [
        tmapper.Mapper.from_oracle_index(idx, cp, MapParams(), device="cpu",
                                         batch_size=bs).map_reads_paf(rl)
        for bs in (48, 8)
    ]
    assert outs[0] == outs[1]
    assert outs[0].count(b"\n") >= 40


def test_submit_thread_error_propagates(small):
    genome, idx, cp, mp = small
    m = tmapper.Mapper.from_oracle_index(idx, cp, mp, device="cpu", **SMALL)

    def _raise(*a, **kw):
        raise RuntimeError("injected submit failure")

    m._submit_groups = _raise
    with pytest.raises(RuntimeError, match="injected submit failure"):
        m.map_reads_paf(_corpus(genome))
