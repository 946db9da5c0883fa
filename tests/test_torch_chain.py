"""The port's plain chain DP (minimap2_rs_torch.ops.chain_ops) against the
JAX package's scan formulation and its Pallas kernels (interpret mode on
the CPU, as tests/test_chain_lane.py runs them). Exact equality: the DP
is integer arithmetic plus a truncated f32 penalty."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_tpu.ops.chain_pallas import chain_dp_aux_batch_pallas  # noqa: E402
from minimap2_rs_torch.kernels.chain_dp import chain_dp_aux_batch  # noqa: E402
from minimap2_rs_torch.ops.chain_ops import (  # noqa: E402
    chain_dp_aux_batch_ref,
    chain_scalars_from_params,
    log2_table,
)

torch.set_num_threads(2)

CP = ChainParams.defaults_for_k(15)


def chain_anchors(B, A, seed):
    """Anchors sorted like the mapper's: per read a few colinear chains
    (indel-jittered diagonals) on two strands, random noise anchors and
    exact duplicates (tie-breaks), padding (grp -1, coords -1, span 255)
    at the end."""
    rng = np.random.default_rng(seed)
    grp = np.full((B, A), -1, np.int32)
    rpos = np.full((B, A), -1, np.int32)
    qpos = np.full((B, A), -1, np.int32)
    span = np.full((B, A), 255, np.int32)
    for b in range(B):
        n = int(rng.integers(A // 3, A + 1))
        g, r, q = [], [], []
        while len(g) < n:
            m = int(rng.integers(5, 60))
            strand = int(rng.integers(0, 2)) << 31
            r0, q0 = int(rng.integers(0, 100_000)), int(rng.integers(0, 20_000))
            steps_r = rng.integers(1, 40, size=m)
            steps_q = np.maximum(steps_r + rng.integers(-3, 4, size=m), 1)
            g += [strand] * m
            r += list(r0 + np.cumsum(steps_r))
            q += list(q0 + np.cumsum(steps_q))
            if rng.random() < 0.3:  # noise
                g.append(strand)
                r.append(int(rng.integers(0, 100_000)))
                q.append(int(rng.integers(0, 20_000)))
        g, r, q = np.array(g[:n]), np.array(r[:n]), np.array(q[:n])
        dup = rng.random(n) < 0.05
        g, r, q = np.r_[g, g[dup]][:n], np.r_[r, r[dup]][:n], np.r_[q, q[dup]][:n]
        order = np.lexsort((q, r, g.astype(np.uint32)))
        grp[b, :n] = g[order].astype(np.uint32).view(np.int32)
        rpos[b, :n] = r[order]
        qpos[b, :n] = q[order]
        span[b, :n] = np.where(rng.random(n) < 0.9, 15, rng.integers(11, 30, size=n))
    return grp, rpos, qpos, span


def _torch_args(arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _jax_args(arrs):
    grp, rpos, qpos, span = arrs
    return (jnp.asarray(grp.view(np.uint32)), jnp.asarray(rpos),
            jnp.asarray(qpos), jnp.asarray(span))


@pytest.mark.parametrize("A,window", [(256, 256), (1024, 1024), (1024, 128)])
@pytest.mark.parametrize("bw", [CP.bw, CP.bw_long])
def test_chain_ref_matches_jax_scan_and_pallas(A, window, bw):
    B = 8
    arrs = chain_anchors(B, A, seed=A + window + bw)
    cp = ChainParams.defaults_for_k(15, bw=bw)
    tab = log2_table(max(CP.bw, CP.bw_long) + 1)
    got = chain_dp_aux_batch_ref(*_torch_args(arrs), chain_scalars_from_params(cp),
                                 window, tab)
    jscal = jchain.chain_scalars_from_params(cp)
    want_scan = jchain.chain_dp_aux_batch(*_jax_args(arrs), jscal, window)
    want_pallas = chain_dp_aux_batch_pallas(*_jax_args(arrs), jscal, window)
    for name, g, ws, wp in zip(("f", "cnt", "sq", "sr"), got, want_scan, want_pallas):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(ws), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp), err_msg=name)
    # the corpus really chains (cnt > 1 somewhere)
    assert (got[1].numpy() > 1).sum() > A


def test_wrapper_on_cpu_is_the_plain_version():
    arrs = chain_anchors(4, 128, seed=5)
    scal = chain_scalars_from_params(CP)
    tab = log2_table(CP.bw_long + 1)
    a = chain_dp_aux_batch(*_torch_args(arrs), scal, 64, tab)
    b = chain_dp_aux_batch_ref(*_torch_args(arrs), scal, 64, tab)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_log2_table_is_the_oracle_mg_log2():
    from minimap2_rs_tpu.oracle.lchain import mg_log2

    tab = log2_table(600)
    assert tab.dtype == torch.float32
    for dd in (0, 1, 2, 7, 100, 599):
        assert tab[dd].item() == float(mg_log2(dd + 1))


def test_chain_scalars_apply_the_max_dist_adjustment():
    cp = ChainParams.defaults_for_k(15, bw=20000)
    s = chain_scalars_from_params(cp)
    j = jchain.chain_scalars_from_params(cp)
    assert (s.max_dist_x, s.max_dist_y, s.bw) == (20000, 20000, 20000)
    assert s.max_dist_x == int(j.max_dist_x) and s.max_dist_y == int(j.max_dist_y)
    assert np.float32(s.chn_pen_gap) == np.asarray(j.chn_pen_gap)
