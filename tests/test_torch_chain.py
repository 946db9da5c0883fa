"""The port's plain chain DPs (minimap2_rs_torch.ops.chain_ops), both the
aux (f, cnt, sq, sr) and the (f, prev) form, against the JAX package's
scan formulation and its Pallas kernels (interpret mode on the CPU, as
tests/test_chain_lane.py runs them) at the static-sublane, lane and
dynamic-sublane shapes. Exact equality: the DP is integer arithmetic
plus a truncated f32 penalty."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_tpu.ops.chain_pallas import (  # noqa: E402
    chain_dp_aux_batch_pallas,
    chain_dp_batch_pallas,
)
from minimap2_rs_torch.kernels import chain_dp as kchain  # noqa: E402
from minimap2_rs_torch.kernels.chain_dp import chain_dp_aux_batch, chain_dp_batch  # noqa: E402
from minimap2_rs_torch.ops.chain_ops import (  # noqa: E402
    chain_dp_aux_batch_ref,
    chain_dp_batch_ref,
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


# (A, window): the static sublane kernel (A < 1024, full window), the
# lane kernel (A >= 1024) at a full and a sliding window, and the dynamic
# sublane kernel (A < 1024, window < A)
SHAPES = [(256, 256), (1024, 1024), (1024, 128), (256, 64)]


@pytest.mark.parametrize("A,window", SHAPES)
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


@pytest.mark.parametrize("A,window", SHAPES)
@pytest.mark.parametrize("bw", [CP.bw, CP.bw_long])
def test_prev_ref_matches_jax_scan_and_pallas(A, window, bw):
    """chain_dp_batch_ref's (f, prev) equals the JAX scan chain_dp_batch
    and chain_dp_batch_pallas (_static_kernel, _chain_kernel_lane,
    _chain_kernel by shape)."""
    B = 8
    arrs = chain_anchors(B, A, seed=A + window + bw + 1)
    cp = ChainParams.defaults_for_k(15, bw=bw)
    tab = log2_table(max(CP.bw, CP.bw_long) + 1)
    got = chain_dp_batch_ref(*_torch_args(arrs), chain_scalars_from_params(cp),
                             window, tab)
    jscal = jchain.chain_scalars_from_params(cp)
    want_scan = jchain.chain_dp_batch(*_jax_args(arrs), jscal, window)
    want_pallas = chain_dp_batch_pallas(*_jax_args(arrs), jscal, window)
    for name, g, ws, wp in zip(("f", "prev"), got, want_scan, want_pallas):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(ws), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp), err_msg=name)
    prev = got[1].numpy()
    # the corpus really chains, and padding rows start no chain
    assert (prev >= 0).sum() > A
    assert (prev[arrs[0] == -1] == -1).all()


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


def test_prev_wrapper_on_cpu_is_the_plain_version():
    arrs = chain_anchors(4, 128, seed=6)
    scal = chain_scalars_from_params(CP)
    tab = log2_table(CP.bw_long + 1)
    a = chain_dp_batch(*_torch_args(arrs), scal, 64, tab)
    b = chain_dp_batch_ref(*_torch_args(arrs), scal, 64, tab)
    assert len(a) == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("A,window,want", [
    (256, 256, "static"), (256, 5000, "static"), (256, 64, "dynamic"),
    (1024, 128, "lane"), (2304, 2304, "lane"),
])
def test_shape_class_follows_the_pallas_dispatch(A, window, want):
    assert kchain.shape_class(A, window) == want


def test_cpu_calls_neither_count_nor_capture():
    """Only a kernel launch counts; the plain version on the CPU does
    not, and keeps no inputs."""
    arrs = chain_anchors(2, 128, seed=9)
    kchain.reset_launches()
    kchain.captured = {}
    try:
        for skip in (None, CP.max_chain_skip):
            chain_dp_batch(*_torch_args(arrs), chain_scalars_from_params(CP), 128,
                           log2_table(CP.bw_long + 1), skip)
        assert kchain.captured == {}
    finally:
        kchain.captured = None
    assert set(kchain.launches) == {
        f"{v}{p}/{s}" for v in ("chain_dp_aux", "chain_dp") for p in ("", "_prune")
        for s in kchain.SHAPES}
    assert not any(kchain.launches.values())


def test_prev_and_aux_forms_agree():
    """Both plain versions run the same DP: equal f, and cnt/sq/sr follow
    the prev pointers."""
    arrs = chain_anchors(4, 192, seed=8)
    scal = chain_scalars_from_params(CP)
    tab = log2_table(CP.bw_long + 1)
    f, prev = chain_dp_batch_ref(*_torch_args(arrs), scal, 192, tab)
    f2, cnt, sq, _sr = chain_dp_aux_batch_ref(*_torch_args(arrs), scal, 192, tab)
    assert torch.equal(f, f2)
    qpos = torch.from_numpy(arrs[2])
    rows = torch.arange(4)
    for i in range(192):
        p = prev[:, i]
        has = p >= 0
        want_cnt = torch.where(has, cnt[rows, p.clamp(min=0)] + 1, 1)
        want_sq = torch.where(has, sq[rows, p.clamp(min=0)], qpos[:, i])
        assert torch.equal(cnt[:, i], want_cnt) and torch.equal(sq[:, i], want_sq)
