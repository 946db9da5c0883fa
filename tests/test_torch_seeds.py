"""The port's sketch -> anchors front half (models/stages.sketch_to_anchors)
and the finalize step against the JAX package's, on both index layouts
(4-word direct table, fused single-gather table). Exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models import stages as jstages  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads  # noqa: E402
from minimap2_rs_torch.models import stages as tstages  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.ops import chain_ops as tchain  # noqa: E402
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402

torch.set_num_threads(2)

MP = MapParams()
CP = ChainParams.defaults_for_k(15)
L, M = 1024, 256


@pytest.fixture(scope="module", params=[50_000, 5_000_000])
def setup(request):
    g = random_genome(request.param, seed=5)
    idx = build_index_native([("chrS", g)], IndexParams())
    args = (idx.keys, idx.starts, idx.counts, idx.positions)
    kw = dict(key_bits=2 * idx.k, seq_lens=[s.length for s in idx.seq])
    reads = [s for _n, s, *_ in simulate_reads(g, 14, read_len=(300, L), seed=6)]
    # a chimera (best chain covers half the read: rescue) and junk
    reads += [g[1000:1400] + g[30_000:30_400], b"ACGT" * 100]
    codes = np.full((len(reads), L), 4, np.int32)
    for i, s in enumerate(reads):
        codes[i, : len(s)] = nt4_encode(s)
    lengths = np.array([len(s) for s in reads], np.int32)
    mid_occ = max(idx.calc_mid_occ(MP.frac_top_repetitive), MP.mid_occ_floor)
    return (idx, tidx.DeviceIndex.from_host(*args, **kw, device="cpu"),
            jidx.DeviceIndex.from_host(*args, **kw), codes, lengths, mid_occ)


def _anchors(setup, A):
    _idx, t, j, codes, lengths, mid_occ = setup
    kw = dict(w=10, k=15, q_occ_max=MP.q_occ_max, q_occ_frac=MP.q_occ_frac, M=M, A=A)
    ta = tstages.sketch_to_anchors(t, torch.from_numpy(codes), torch.from_numpy(lengths),
                                   mid_occ, **kw)
    ja = jstages.sketch_to_anchors(j, jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.int32(mid_occ), hpc=False, **kw)
    return ta, ja


@pytest.mark.parametrize("A", [256, 64])
def test_sketch_to_anchors_matches_jax(setup, A):
    ta, ja = _anchors(setup, A)
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "cps"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]).astype(np.int64),
                                      err_msg=name)
    for name in ("n_anchors", "anc_ovf", "n_mini", "mini_ovf"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]), err_msg=name)
    assert ta["n_anchors"].numpy().max() > 50
    assert ta["anc_ovf"].any() == (A == 64)


def test_chain_finalize_lite_matches_jax(setup):
    """Chain DP + finalize (both bands, merged rescue column, per-band
    win_ovf) on the port's anchors vs the JAX stage on JAX's anchors."""
    idx, _t, _j, _codes, lengths, _mid = setup
    A, window = 256, 64
    ta, ja = _anchors(setup, A)
    tlens = np.array([s.length for s in idx.seq], np.int32)
    tab = tchain.log2_table(CP.bw_long + 1)
    wide = ChainParams.defaults_for_k(15, bw=CP.bw_long)
    got = tstages.chain_finalize_lite(
        ta, torch.from_numpy(lengths), tchain.chain_scalars_from_params(CP),
        tchain.chain_scalars_from_params(wide), torch.from_numpy(tlens),
        CP.rmq_rescue_size, CP.rmq_rescue_ratio, k=15, window=window,
        log2_tab=tab, flag_window_ovf=True, wide=True,
    )
    ja = dict(ja, mini_span=None)
    want = jstages.chain_finalize_lite(
        ja, jnp.asarray(lengths), jchain.chain_scalars_from_params(CP),
        jchain.chain_scalars_from_params(wide), jnp.asarray(tlens),
        jnp.int32(CP.rmq_rescue_size), jnp.float32(CP.rmq_rescue_ratio),
        k=15, hpc=False, window=window, flag_window_ovf=True, wide=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from minimap2_rs_torch.ops.finalize_ops import FIELDS, unpack_fields_wire

    rows = unpack_fields_wire(got.numpy())
    assert rows[:, FIELDS.index("rescue")].any()   # the chimera
    assert rows[:, FIELDS.index("win_ovf")].any()  # window 64 truncates
