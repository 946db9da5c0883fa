"""The port's H2D wire unpackers and D2H field wire against the JAX
package's (models/stages.py, ops/finalize_ops.py): exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.models import stages as jstages  # noqa: E402
from minimap2_rs_tpu.ops import finalize_ops as jfin  # noqa: E402
from minimap2_rs_tpu.runtime.host import native_encode_pack2, native_encode_pack4  # noqa: E402
from minimap2_rs_torch.ops.sketch import unpack_codes2, unpack_codes4  # noqa: E402
from minimap2_rs_torch.ops import finalize_ops as tfin  # noqa: E402

torch.set_num_threads(2)


def _reads(rng, B, L):
    """Random reads of random lengths with scattered N bases and N runs."""
    out = []
    for _ in range(B):
        n = int(rng.integers(0, L + 1))
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
        s[rng.random(n) < 0.01] = ord("N")
        if n > 40 and rng.random() < 0.5:
            a = int(rng.integers(0, n - 20))
            s[a : a + int(rng.integers(1, 20))] = ord("N")
        out.append(s.tobytes())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_codes2_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L = 16, 256
    seqs = _reads(rng, B, L)
    wire = native_encode_pack2(seqs, L // 4, 2048)
    if wire is None:
        # no native runtime: a random wire and exception list
        codes2 = rng.integers(0, 256, size=(B, L // 4), dtype=np.uint8)
        nex = np.full(64, B * L, np.int32)
        nex[:40] = rng.integers(0, B * L, size=40)
    else:
        codes2, nex = wire
    assert (nex < B * L).any() and (nex == B * L).any()  # N scatter + padding
    lengths = np.array([len(s) for s in seqs], np.int32)
    got = unpack_codes2(torch.from_numpy(codes2), torch.from_numpy(lengths),
                        torch.from_numpy(nex))
    want = jstages.unpack_codes2(jnp.asarray(codes2), jnp.asarray(lengths), jnp.asarray(nex))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_codes4_matches_jax():
    rng = np.random.default_rng(2)
    B, L = 8, 128
    packed = native_encode_pack4(_reads(rng, B, L), L // 2)
    if packed is None:
        packed = rng.integers(0, 256, size=(B, L // 2), dtype=np.uint8)
    got = unpack_codes4(torch.from_numpy(packed))
    want = jstages.unpack_codes4(jnp.asarray(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_fields(rng, B):
    f = np.zeros((B, len(tfin.FIELDS)), np.int32)
    c = {n: i for i, n in enumerate(tfin.FIELDS)}
    for n in ("score", "qs", "qe", "ts", "te", "sum_span"):
        f[:, c[n]] = rng.integers(-(2**31), 2**31, size=B, dtype=np.int64)
    f[:, c["grp"]] = rng.integers(0, 2**32, size=B, dtype=np.uint64).astype(np.uint32).view(np.int32)
    for n in ("cm", "n_anchors", "n_mini", "st", "n_tot"):
        f[:, c[n]] = rng.integers(0, 1 << 16, size=B)
    f[:, c["n_match"]] = f[:, c["cm"]]
    for n in ("dv_found", "rescue", "mini_ovf", "anc_ovf", "win_ovf"):
        f[:, c[n]] = rng.integers(0, 2, size=B)
    return f


def test_field_wire_pack_matches_jax_and_roundtrips():
    assert tfin.FIELDS == jfin.FIELDS and tfin.WIRE_WORDS == jfin.WIRE_WORDS
    fields = _random_fields(np.random.default_rng(3), 64)
    got = tfin.pack_fields_wire(torch.from_numpy(fields))
    want = jfin.pack_fields_wire(jnp.asarray(fields))
    assert got.dtype == torch.int32 and got.shape == (64, tfin.WIRE_WORDS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfin.unpack_fields_wire(got.numpy()), fields)
    assert tfin.wire_packable(256, 256) == jfin.wire_packable(256, 256)
    assert tfin.wire_packable(1 << 16, 256) == jfin.wire_packable(1 << 16, 256)
