"""The port's banded extension functions (ops/extend_ops.py) against the
JAX package's (minimap2_rs_tpu/ops/extend_ops.py) on random pairs with
mutations, empty and out-of-band pairs: exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.ops import extend_ops as jext  # noqa: E402
from minimap2_rs_torch.ops import extend_ops as text  # noqa: E402

torch.set_num_threads(2)


def _pairs(B=48, N=96, Nr=104, seed=0):
    """nt4 queries (with some 4s), references that copy them with 10%
    substitutions, and lengths: most pairs near the diagonal, some with
    length gaps wider than the band, one empty query, one empty ref."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, size=(B, N)).astype(np.int32)
    r = np.concatenate([q, rng.integers(0, 4, size=(B, Nr - N))], axis=1).astype(np.int32)
    mut = rng.random((B, Nr)) < 0.1
    r[mut] = rng.integers(0, 4, size=int(mut.sum()))
    qlen = rng.integers(40, N + 1, size=B).astype(np.int32)
    rlen = np.clip(qlen + rng.integers(-6, 7, size=B), 0, Nr).astype(np.int32)
    rlen[-8:] = rng.integers(0, Nr + 1, size=8)
    qlen[0], rlen[1] = 0, 0
    return q, qlen, r, rlen


@pytest.mark.parametrize("band", [3, 8])
def test_banded_edit_batch_equals_jax(band):
    q, qlen, r, rlen = _pairs()
    got = text.banded_edit_batch(*map(torch.from_numpy, (q, qlen, r, rlen)), band)
    want = jext.banded_edit_batch(*map(jnp.asarray, (q, qlen, r, rlen)), band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and (got.numpy() < np.maximum(qlen, rlen)).any()


@pytest.mark.parametrize("band", [3, 8])
def test_banded_affine_extend_equals_jax(band):
    q, qlen, r, rlen = _pairs(seed=1)
    got = text.banded_affine_extend(*map(torch.from_numpy, (q, qlen, r, rlen)), band)
    want = jext.banded_affine_extend(*map(jnp.asarray, (q, qlen, r, rlen)), band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] > 0).any()
