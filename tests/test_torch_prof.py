"""The port's measuring scripts prof_pipeline_torch.py,
prof_longread_torch.py and prof_longread_stages_torch.py on the CPU at a
cut size, held to the JAX package: the batch-size sweep's PAF bytes
against the JAX oracle's, the long-read buckets' shapes against the JAX
Mapper's and the mapped bases against the JAX oracle's, and the three
timed stage calls at a lane bucket (A >= 1024) against the JAX stages
and the JAX plain chain DP; and the failures that must end a run."""

import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import prof_longread_stages_torch as pst  # noqa: E402
import prof_longread_torch as plr  # noqa: E402
import prof_pipeline_torch as ppl  # noqa: E402
import scaling_bench_torch as sbt  # noqa: E402
from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models import mapper as jmapper  # noqa: E402
from minimap2_rs_tpu.models import stages as jstages  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads  # noqa: E402
from minimap2_rs_torch import config as tconfig  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.models.mapper import Mapper  # noqa: E402
from minimap2_rs_torch.ops.sketch import KS_INVALID  # noqa: E402

torch.set_num_threads(2)

CP, MP = ChainParams.defaults_for_k(15), MapParams()
GENOME = 100_000
# short reads in a 512-base bucket, 16- and 32-read calls
PIPE_SIZES = dict(genome=GENOME, reads=48, read_len=(200, 400), passes=3,
                  mapper={"buckets": (512, 1024, 2048)})
PIPE_ARGV = ["--device", "cpu", "16", "32"]
# "long" reads over two buckets
LONG_SIZES = dict(genome=GENOME, read_len=(600, 1800), batch_size=16,
                  mapper={"buckets": (512, 1024, 2048)})
# a lane shape: A = 1024 at the 2048 bucket (anchor_frac 0.5), 8-row calls
LANE_MAPPER = {"buckets": (1024, 2048), "anchor_frac": 0.5}
STAGE_SIZES = dict(genome=GENOME, reads=12, read_len=(1100, 2000), batch_size=8,
                   buckets=(2048,), cap_unit=8, reps=1, mapper=LANE_MAPPER)


def _genome():
    return random_genome(GENOME, seed=0)


def _oracle_lines(reads):
    return oracle_map(build_index([("chrB", _genome())], IndexParams()), reads, CP, MP)


def _aligned(reads, lines):
    names = {l.split("\t", 1)[0] for l in lines}
    return sum(len(s) for n, s in reads if n in names)


@pytest.fixture(scope="module")
def pipeline():
    return ppl.main(PIPE_ARGV, sizes=PIPE_SIZES)


def test_pipeline_sizes_give_the_jax_oracle_bytes(pipeline):
    """Both batch sizes gave one PAF blob (the run fails otherwise), and
    it is the JAX oracle's, byte for byte."""
    rl = [(n, s) for n, s, *_ in simulate_reads(_genome(), 48, read_len=(200, 400), seed=1)]
    want = "".join(l + "\n" for l in _oracle_lines(rl)).encode()
    assert want and pipeline["paf_sha256"] == hashlib.sha256(want).hexdigest()
    assert pipeline["paf_bytes"] == len(want)
    assert [s["batch_size"] for s in pipeline["sizes"]] == [16, 32]


def test_pipeline_record_and_rows_a_call(pipeline):
    """Each size's passes, median and rate; the padded rows of each call
    are the JAX Mapper's (_shapes_for, _quantize_b) at that batch size."""
    idx = build_index([("chrB", _genome())], IndexParams())
    for s in pipeline["sizes"]:
        assert len(s["pass_times_s"]) == 3
        assert s["median_s"] == sorted(s["pass_times_s"])[1]
        assert s["bp_per_s"] == pipeline["total_bp"] / s["median_s"]
        assert s["launches"] == {} and "post" in s["stats"]
        jm = jmapper.Mapper.from_oracle_index(idx, CP, MP, batch_size=s["batch_size"],
                                              **PIPE_SIZES["mapper"])
        B_max = jm._shapes_for(512, 1)[3]
        want = [jm._quantize_b(min(B_max, 48 - c0), B_max) for c0 in range(0, 48, B_max)]
        assert s["rows_per_call"] == {512: want}
    assert pipeline["sizes"][0]["rows_per_call"] == {512: [16, 16, 16]}


def test_a_dropped_line_at_one_batch_size_fails_the_sweep(monkeypatch):
    orig = Mapper.map_reads_paf

    def drop_first(self, reads):
        blob = orig(self, reads)
        return blob[blob.index(b"\n") + 1:] if self.batch_size == 32 else blob

    monkeypatch.setattr(Mapper, "map_reads_paf", drop_first)
    with pytest.raises(AssertionError, match="batch 32 gave other PAF bytes than batch 16"):
        ppl.main(PIPE_ARGV, sizes={**PIPE_SIZES, "passes": 1})


def test_longread_buckets_equal_the_jax_mapper_and_bases_the_jax_oracle():
    rec = plr.main(["--device", "cpu", "8"], sizes=LONG_SIZES)
    jm = jmapper.Mapper.from_oracle_index(build_index([("chrB", _genome())], IndexParams()),
                                          CP, MP, batch_size=16, **LONG_SIZES["mapper"])
    lrl = [(n, s) for n, s, *_ in simulate_reads(_genome(), 8, read_len=(600, 1800), seed=3)]
    want_pop = {}
    for _, s in lrl:
        b = next(b for b in jm.buckets if len(s) <= b)
        want_pop[b] = want_pop.get(b, 0) + 1
    assert len(want_pop) == 2
    assert {r["bucket"]: r["population"] for r in rec["buckets"]} == want_pop
    for r in rec["buckets"]:
        M, A, window, B = jm._shapes_for(r["bucket"], 1)
        assert (r["M"], r["A"], r["window"], r["B"]) == (M, A, window, B)
        assert r["dual_band"] == jm._dual_band(A)
        assert r["lite_window"] == min(window, jm.lite_window_cap)
    want_bp = _aligned(lrl, _oracle_lines(lrl))
    assert want_bp > 0 and rec["total_bp"] == sum(len(s) for _, s in lrl)
    assert [p["mapped_bp"] for p in rec["passes"]] == [want_bp] * 3
    assert rec["warm_passes"] == 1 and rec["launches"] == {}


@pytest.fixture(scope="module")
def lane_stage():
    """The stage script's inputs at the 2048 bucket (A = 1024, window
    1024): the port mapper's statics, the codes of the bucket's reads
    packed to B_full rows, and the three calls' outputs."""
    genome = _genome()
    m = Mapper.from_oracle_index(
        build_index_native([("chrB", genome)], tconfig.IndexParams()),
        tconfig.ChainParams.defaults_for_k(15), tconfig.MapParams(), device="cpu",
        batch_size=8, **LANE_MAPPER)
    st = pst.lite_statics(m, 2048, "4bit")
    assert (st["A"], st["window"]) == (1024, 1024)
    seqs = [s for _n, s, *_ in simulate_reads(genome, 12, read_len=(1100, 2000), seed=3)
            if len(s) > 1024]
    codes, lengths = pst.pack_codes(seqs, m._shapes_for(2048, 1)[3], 2048)
    fns = pst.stage_fns(st, torch.from_numpy(codes), torch.from_numpy(lengths))
    return dict(m=m, st=st, codes=codes, lengths=lengths,
                out={k: fns[k]() for k in pst.STAGES})


def _jax_kw(st):
    return dict(w=st["w"], k=st["k"], hpc=False, q_occ_max=st["q_occ_max"],
                q_occ_frac=st["q_occ_frac"], M=st["M"])


def test_stage_sketch_equals_the_jax_stage(lane_stage):
    st, got = lane_stage["st"], lane_stage["out"]["sketch"]
    want = jstages.sketch_compact_filter(jnp.asarray(lane_stage["codes"]),
                                         jnp.asarray(lane_stage["lengths"]), **_jax_kw(st))
    # the key words: equal in the valid slots; the padding is the port's
    # KS_INVALID (int64 max) where the JAX pair is (U32 max, U32 max)
    ks = got["sks"].numpy()
    valid = np.arange(ks.shape[1])[None, :] < got["n_mini"].numpy()[:, None]
    hi, lo = np.asarray(want["sks_hi"]), np.asarray(want["sks_lo"])
    np.testing.assert_array_equal((ks >> 32)[valid], hi[valid])
    np.testing.assert_array_equal((ks & 0xFFFFFFFF)[valid], lo[valid])
    assert (ks[~valid] == KS_INVALID).all()
    assert (hi[~valid] == 0xFFFFFFFF).all() and (lo[~valid] == 0xFFFFFFFF).all()
    for name in ("sps", "cps"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]).astype(np.int64),
                                      err_msg=name)
    for name in ("keep", "n_mini", "mini_ovf"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert got["n_mini"].numpy().max() > 100


def _jax_anchors(lane_stage):
    m, st = lane_stage["m"], lane_stage["st"]
    idx = m.idx
    j_idx = jidx.DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                       key_bits=2 * idx.k,
                                       seq_lens=[s.length for s in idx.seq])
    return jstages.sketch_to_anchors(j_idx, jnp.asarray(lane_stage["codes"]),
                                     jnp.asarray(lane_stage["lengths"]),
                                     jnp.int32(st["mid_occ"]), A=st["A"], **_jax_kw(st))


def test_stage_anchors_and_chain_equal_the_jax_stage_and_plain_dp(lane_stage):
    """sketch_to_anchors equal to the JAX stage's arrays, and one lane
    band of the chain DP on them equal to the JAX plain scan DP
    (ops/chain_ops.chain_dp_aux_batch) at the lite window."""
    st, got = lane_stage["st"], lane_stage["out"]
    ja = _jax_anchors(lane_stage)
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "cps"):
        np.testing.assert_array_equal(got["anchors"][name].numpy(),
                                      np.asarray(ja[name]).astype(np.int64), err_msg=name)
    for name in ("n_anchors", "anc_ovf", "n_mini", "mini_ovf"):
        np.testing.assert_array_equal(got["anchors"][name].numpy(), np.asarray(ja[name]),
                                      err_msg=name)
    assert ja["n_anchors"].max() > 200
    jargs = (ja["x_hi"], ja["x_lo"].astype(jnp.int32), ja["y_lo"].astype(jnp.int32),
             (ja["y_hi"] & 0xFF).astype(jnp.int32))
    want = jchain.chain_dp_aux_batch(*jargs, jchain.chain_scalars_from_params(CP),
                                     st["window"])
    for name, g, w in zip(("f", "cnt", "sq", "sr"), got["chain"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_stages_record_times_both_batch_sizes():
    rec = pst.main(["--device", "cpu"], sizes=STAGE_SIZES)
    (row,) = rec["buckets"]
    assert (row["bucket"], row["A"], row["window"], row["B_full"]) == (2048, 1024, 1024, 8)
    assert row["B_cap"] == -(-row["reads"] // 8) * 8 and row["reads"] > 0
    assert [c["B"] for c in row["calls"]] == [row["B_full"], row["B_cap"]]
    for c in row["calls"]:
        assert all(c[f"{k}_ms"] > 0 for k in pst.STAGES)
        assert c["codes_bytes"] == c["B"] * 2048 * 4 and c["launches"] == {}


def test_an_empty_bucket_fails_the_stage_run():
    with pytest.raises(ValueError, match="bucket 1024 holds none"):
        pst.main(["--device", "cpu"], sizes={**STAGE_SIZES, "buckets": (1024, 2048)})


@pytest.mark.parametrize("mod", [ppl, plr, pst, sbt],
                         ids=lambda m: m.__name__)
def test_device_defaults_to_cuda_which_raises_without_a_card(mod):
    assert mod._parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
