"""The port's pruned chain DPs (max_chain_skip, the reference's
order-dependent early break, lchain.rs:79-88) against the JAX package's
`_skip_prune_mask` and pruned scan DPs and against the oracle's scalar
chain_dp_scores, on the adversarial decoy corpora of
tests/test_chain_skip_prune.py, with and without boosters. Exact
equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_tpu.oracle.lchain import chain_dp_scores  # noqa: E402
from minimap2_rs_torch.kernels import chain_dp as kchain  # noqa: E402
from minimap2_rs_torch.ops import chain_ops as tchain  # noqa: E402

torch.set_num_threads(2)

CP = ChainParams.defaults_for_k(15)
SKIP = CP.max_chain_skip


def _adversarial(B, n_blocks, seed, boosters=False):
    """Rows of [backbone, decoys, backbone, decoys, ...] blocks: decoys
    sit on a far diagonal inside the band, so they are admissible but
    never beat, and the backbone's marks make them count as skips
    (tests/test_chain_skip_prune.py:41-80). boosters=True plants an
    on-diagonal beat mid-cluster (the counter's floored decrement)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _b in range(B):
        rp, qp = [], []
        r0 = 1000
        for t in range(n_blocks):
            n_decoy = int(rng.integers(28, 40))
            rp.append(r0)
            qp.append(r0)
            diag = int(rng.integers(420, 480))
            for u in range(n_decoy):
                rp.append(r0 + 10 + u)
                qp.append(r0 + 10 + u + diag)
            if boosters and t % 2 == 0:
                mid = r0 + 10 + n_decoy // 2
                rp.append(mid)
                qp.append(mid)
            r0 += 10 + n_decoy + int(rng.integers(450, 520))
        order = np.argsort(np.array(rp), kind="stable")
        rows.append((np.array(rp)[order], np.array(qp)[order]))
    A = max(len(r) for r, _ in rows)
    grp = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    span = np.zeros((B, A), np.int32)
    for b, (rp, qp) in enumerate(rows):
        n = len(rp)
        grp[b, :n] = 0
        rpos[b, :n] = rp
        qpos[b, :n] = qp
        span[b, :n] = 15
    return grp, rpos, qpos, span


def _torch(cols):
    return [torch.from_numpy(np.ascontiguousarray(c).view(np.int32)) for c in cols]


def _jax(cols):
    return [jnp.asarray(c) for c in cols]


TAB = tchain.log2_table(CP.bw + 1)
TS = tchain.chain_scalars_from_params(CP)
JS = jchain.chain_scalars_from_params(CP)


@pytest.mark.parametrize("boosters", [False, True])
def test_skip_prune_mask_equals_jax(boosters):
    """Window by window on the pruned DP's own (f, prev): the port's mask
    equals the JAX package's."""
    cols = _adversarial(3, 5, seed=7, boosters=boosters)
    g, rp, qp, sp = (t.to(torch.int64) for t in _torch(cols))
    f, prev = (t.to(torch.int64) for t in tchain.chain_dp_batch_ref(
        *_torch(cols), TS, cols[0].shape[1], TAB, max_chain_skip=SKIP))
    pens = tuple(torch.tensor(v, dtype=torch.float32) for v in (TS.chn_pen_gap, TS.chn_pen_skip))
    A = g.shape[1]
    masked = 0
    for H in (A, 48):
        for i in range(1, A, 3):
            scores, ok, off = tchain._window_scores(g, rp, qp, sp, f, i, min(H, A), TS, TAB, pens)
            pv = prev[:, off : off + scores.shape[1]]
            got = tchain._skip_prune_mask(scores, ok, pv, off, sp[:, i], SKIP)
            for b in range(g.shape[0]):
                want = jchain._skip_prune_mask(
                    jnp.asarray(scores[b].numpy().astype(np.int32)), jnp.asarray(ok[b].numpy()),
                    jnp.asarray(pv[b].numpy().astype(np.int32)), off,
                    jnp.int32(sp[b, i].item()), SKIP)
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
            masked += int((got != scores).sum())
    assert masked > 0  # the break really cuts windows


@pytest.mark.parametrize("boosters", [False, True])
@pytest.mark.parametrize("aux", [False, True], ids=["f_prev", "aux"])
def test_pruned_dp_equals_jax_and_oracle(aux, boosters):
    cols = _adversarial(4, 5, seed=3, boosters=boosters)
    A = cols[0].shape[1]
    for window in (A, 64):
        if aux:
            got = kchain.chain_dp_aux_batch(*_torch(cols), TS, window, TAB, max_chain_skip=SKIP)
            want = jchain.chain_dp_aux_batch(*_jax(cols), JS, window, max_chain_skip=SKIP)
        else:
            got = kchain.chain_dp_batch(*_torch(cols), TS, window, TAB, max_chain_skip=SKIP)
            want = jchain.chain_dp_batch(*_jax(cols), JS, window, max_chain_skip=SKIP)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    exact = tchain.chain_dp_batch_ref(*_torch(cols), TS, A, TAB)
    assert (exact[0] != got[0]).any(), "the corpus must make the pruning bind"
    if aux:
        return
    grp, rpos, qpos, span = cols
    for b in range(grp.shape[0]):
        n = int((grp[b] != 0xFFFFFFFF).sum())
        x = (grp[b, :n].astype(np.uint64) << np.uint64(32)) | rpos[b, :n].astype(np.uint64)
        y = (span[b, :n].astype(np.uint64) << np.uint64(32)) | qpos[b, :n].astype(np.uint64)
        fo, _vo, po = chain_dp_scores(np.stack([x, y], axis=1), CP)
        f, prev = kchain.chain_dp_batch(*_torch(cols), TS, A, TAB, max_chain_skip=SKIP)
        np.testing.assert_array_equal(f[b, :n].numpy(), fo)
        np.testing.assert_array_equal(prev[b, :n].numpy(), po)


def test_prune_wrapper_rejects_negative_skip():
    cols = _torch(_adversarial(1, 2, seed=1))
    with pytest.raises(ValueError):
        kchain.chain_dp_batch(*cols, TS, 16, TAB, max_chain_skip=-1)
