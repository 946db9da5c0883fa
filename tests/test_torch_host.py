"""The port's own host side against the JAX package's: its copy of the
oracle gives the same PAF bytes, and its native runtime, built from its
own copy of mm2t_host.cpp, gives the same arrays and bytes on the same
inputs."""

import numpy as np
import pytest

from minimap2_rs_tpu.config import ChainParams as JChainParams
from minimap2_rs_tpu.config import IndexParams as JIndexParams
from minimap2_rs_tpu.config import MapParams as JMapParams
from minimap2_rs_tpu.oracle.index import build_index as jbuild_index
from minimap2_rs_tpu.oracle.pipeline import map_reads as jmap_reads
from minimap2_rs_tpu.runtime import host as jhost
from minimap2_rs_tpu.utils.seqsim import random_genome as jrandom_genome
from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.oracle.index import build_index
from minimap2_rs_torch.oracle.lchain import chain_dp_scores
from minimap2_rs_torch.oracle.pipeline import map_reads
from minimap2_rs_torch.oracle.seeds import (
    build_anchors,
    collect_query_minimizers,
    filter_query_minimizers,
)
from minimap2_rs_torch.runtime import host as thost
from minimap2_rs_torch.utils.seqsim import random_genome, revcomp, simulate_reads


@pytest.fixture(scope="module")
def genome():
    g = random_genome(40_000, seed=41)
    assert g == jrandom_genome(40_000, seed=41)
    return g


def _corpus(genome, k):
    reads = [(n, s) for n, s, *_ in simulate_reads(genome, 6, read_len=(300, 900),
                                                    seed=k)]
    reads += [("fwd", genome[5000:5600]), ("rev", revcomp(genome[9000:9700])),
              ("empty", b""), ("junk", b"ACGT" * 120)]
    return reads


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("k", [15, 14])
def test_oracle_paf_equals_jax(genome, k, native, monkeypatch):
    """Index build, sketch, chain, rescue, merge, select and PAF of the
    port's oracle copy give the JAX package's bytes, through the native
    runtimes and through the pure-Python fallbacks."""
    if not native:
        monkeypatch.setenv("MM2T_NO_NATIVE", "1")
    reads = _corpus(genome, k)
    got = map_reads(build_index([("chrT", genome)], IndexParams(k=k)), reads,
                    ChainParams.defaults_for_k(k), MapParams())
    want = jmap_reads(jbuild_index([("chrT", genome)], JIndexParams(k=k)), reads,
                      JChainParams.defaults_for_k(k), JMapParams())
    assert got == want
    assert any("\t-\t" in l for l in got) and any("\t+\t" in l for l in got)
    names = {l.split("\t", 1)[0] for l in got}
    assert "empty" not in names and "junk" not in names and "rev" in names


def test_native_runtime_built_from_port_source():
    """The port's library is its own build of its own source, in the
    checkout's build/host/, and it loads."""
    import minimap2_rs_torch

    pkg = thost.SRC.parents[2]
    assert pkg == type(thost.SRC)(minimap2_rs_torch.__file__).parent
    assert thost.SRC.is_file() and thost.SRC.suffix == ".cpp"
    assert thost.native_available()
    lib = thost.build()
    assert lib == pkg.parent / "build" / "host" / "libmm2t_host.so"
    assert lib.stat().st_mtime >= thost.SRC.stat().st_mtime


def _seq(rng, n, alphabet=b"ACGTN", p=(0.24, 0.24, 0.24, 0.24, 0.04)):
    return bytes(rng.choice(list(alphabet), size=n, p=p).astype(np.uint8))


def test_native_sketch_equals_jax():
    rng = np.random.default_rng(43)
    for _ in range(30):
        seq = _seq(rng, int(rng.integers(20, 800)))
        w, k = int(rng.integers(1, 16)), int(rng.integers(2, 29))
        hpc = bool(rng.integers(0, 2))
        assert thost.native_sketch(seq, w, k, rid=3, is_hpc=hpc) == jhost.native_sketch(
            seq, w, k, rid=3, is_hpc=hpc)


@pytest.mark.parametrize("hpc", [False, True])
def test_native_build_index_equals_jax(genome, hpc):
    seqs = [genome[:25_000], genome[25_000:], b"ACGTNNNNACGT" * 40]
    raw = b"".join(seqs)
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    got = thost.native_build_index(raw, off, 10, 15, hpc, n_threads=2)
    want = jhost.native_build_index(raw, off, 10, 15, hpc, n_threads=2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_encode_pack_equals_jax():
    rng = np.random.default_rng(47)
    seqs = [_seq(rng, int(rng.integers(0, 250)), b"ACGTNacgtnX",
                 [0.2, 0.2, 0.2, 0.2, 0.04, 0.03, 0.03, 0.03, 0.03, 0.02, 0.02])
            for _ in range(19)]
    np.testing.assert_array_equal(thost.native_encode_pack4(seqs, 128),
                                  jhost.native_encode_pack4(seqs, 128))
    got = thost.native_encode_pack2(seqs, 64, 512)
    want = jhost.native_encode_pack2(seqs, 64, 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # more ambiguous bases than the exception list holds: both refuse
    assert thost.native_encode_pack2(seqs, 64, 2) is None
    assert jhost.native_encode_pack2(seqs, 64, 2) is None


def _read_inputs(genome, k=15):
    """(anchors, f, v, prev, mini_pos, mini_span, qlen) per read of a
    small corpus, from the oracle's sketch, seeds and DP."""
    idx = build_index([("chrT", genome), ("chrU", genome[:7000])], IndexParams(k=k))
    cp = ChainParams.defaults_for_k(k)
    out = []
    for _n, s in _corpus(genome, k):
        if not s:
            continue
        mv = collect_query_minimizers(s, idx.w, k)
        anchors = build_anchors(idx, filter_query_minimizers(mv, 10, 0.01), len(s), 50)
        f, v, prev = chain_dp_scores(anchors, cp)
        rps = np.array([r for _ks, r in mv], dtype=np.uint64)
        mini_pos = ((rps & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int32)
        mini_span = np.array([ks & 0xFF for ks, _r in mv], dtype=np.int32)
        out.append((anchors, f, v, prev, mini_pos, mini_span, len(s)))
    tlens = np.array([len(genome), 7000], dtype=np.int32)
    return cp, out, tlens


def test_native_postprocess_and_backtrack_equal_jax(genome):
    cp, reads, tlens = _read_inputs(genome)
    jcp = JChainParams.defaults_for_k(15)
    n_chains = 0
    for anchors, f, v, prev, mini_pos, mini_span, qlen in reads:
        got = thost.native_postprocess(anchors, f, v, prev, cp, qlen, 0.5, 0.8, 5,
                                       mini_pos, mini_span, tlens)
        want = jhost.native_postprocess(anchors, f, v, prev, jcp, qlen, 0.5, 0.8, 5,
                                        mini_pos, mini_span, tlens)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        chains, scores = thost.native_backtrack(anchors, f, None, prev, cp)
        assert (chains, scores) == jhost.native_backtrack(anchors, f, None, prev, jcp)
        n_chains += len(chains)
    assert n_chains > 0


def test_native_format_lite_equals_jax():
    from minimap2_rs_torch.ops.finalize_ops import FIELDS

    rng = np.random.default_rng(53)
    B = 24
    col = {c: i for i, c in enumerate(FIELDS)}
    fields = np.zeros((B, len(FIELDS)), dtype=np.int32)
    qs = rng.integers(0, 200, B)
    ts = rng.integers(0, 50_000, B)
    fields[:, col["qs"]] = qs
    fields[:, col["qe"]] = qs + rng.integers(1, 600, B)
    fields[:, col["ts"]] = ts
    fields[:, col["te"]] = ts + rng.integers(1, 700, B)
    rev = rng.integers(0, 2, B).astype(np.uint32) << np.uint32(31)
    fields[:, col["grp"]] = (rev | rng.integers(0, 2, B).astype(np.uint32)).view(np.int32)
    fields[:, col["score"]] = rng.integers(-5, 900, B)
    fields[:, col["cm"]] = rng.integers(0, 80, B)
    fields[:, col["n_anchors"]] = rng.integers(0, 4, B)
    fields[3, col["mini_ovf"]] = fields[5, col["anc_ovf"]] = fields[7, col["win_ovf"]] = 1
    dv = rng.random(B).astype(np.float32) / 10
    qlens = (fields[:, col["qe"]] + rng.integers(0, 300, B)).astype(np.int32)
    qnames = [f"q{i}-señal".encode() for i in range(B)]
    tname_blob = b"chrTchrU_long_name"
    tname_off = np.array([0, 4, len(tname_blob)], dtype=np.int64)
    tlens = np.array([60_000, 7000], dtype=np.int32)
    args = (fields, dv, qlens, qnames, tname_blob, tname_off, tlens, 60, col)
    got, want = thost.native_format_lite(*args), jhost.native_format_lite(*args)
    assert got[0] == want[0] and len(got[0]) > 0
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("hpc", [False, True])
def test_native_build_pairs_equals_jax(hpc):
    """The threaded exact-scan build's (key, rid_pos_strand) pairs of a
    60 kb genome in two sequences, whole and in 4 kb chunks with their
    halos, equal the JAX package's."""
    from minimap2_rs_torch.utils.packing import nt4_encode

    g = random_genome(60_000, seed=47)
    codes = nt4_encode(g)
    off = np.array([0, 35_000, 60_000], dtype=np.int64)
    for chunk in (1 << 22, 1 << 12):
        got = thost.native_build_pairs(codes, off, 10, 15, hpc, n_threads=2, chunk=chunk)
        want = jhost.native_build_pairs(codes, off, 10, 15, hpc, n_threads=2, chunk=chunk)
        assert got[0].shape[0] > 5000
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)


def test_native_mmi_selfcheck_equals_jax(tmp_path):
    """The golden .mmi passes the native self-check from a path and from
    its bytes; a copy with a flipped byte in each region fails it, with
    the JAX package's stage code."""
    from pathlib import Path

    gold = Path(__file__).parent / "golden" / "golden_w10k15.mmi"
    data = gold.read_bytes()
    assert thost.native_mmi_selfcheck(str(gold)) == 0
    assert thost.native_mmi_selfcheck(data) == 0
    for off in (2, 40, len(data) // 2, len(data) - 9):
        bad = bytearray(data)
        bad[off] ^= 0x5A
        code = thost.native_mmi_selfcheck(bytes(bad))
        assert code != 0 and code == jhost.native_mmi_selfcheck(bytes(bad)), off
    cut = tmp_path / "cut.mmi"
    cut.write_bytes(data[: len(data) // 3])
    assert thost.native_mmi_selfcheck(cut) == jhost.native_mmi_selfcheck(str(cut)) != 0


def test_native_sketch_array_equals_jax():
    rng = np.random.default_rng(53)
    for _ in range(20):
        seq = _seq(rng, int(rng.integers(0, 900)))
        w, k = int(rng.integers(1, 16)), int(rng.integers(2, 29))
        hpc = bool(rng.integers(0, 2))
        got = thost.native_sketch_array(seq, w, k, rid=5, is_hpc=hpc)
        want = jhost.native_sketch_array(seq, w, k, rid=5, is_hpc=hpc)
        assert got.dtype == np.uint64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_last_build_stage_s_after_native_build():
    """Each native index build records its four stages' seconds; the
    port reads the same keys as the JAX package."""
    g = random_genome(1_000_000, seed=59)
    off = np.array([0, len(g)], dtype=np.int64)
    thost.native_build_index(g, off, 10, 15, n_threads=2)
    st = thost.last_build_stage_s()
    assert list(st) == ["scan", "pack", "sort", "flatten"]
    # a 1 Mbp scan and sort take milliseconds, past the 1 ms rounding
    assert all(v >= 0.0 for v in st.values()) and st["scan"] + st["sort"] > 0.0
    jhost.native_build_index(g, off, 10, 15, n_threads=2)
    assert set(jhost.last_build_stage_s()) == set(st)
