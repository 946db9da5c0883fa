"""Query seeding and anchor generation oracle
(reference src/seeds.rs).

Anchor encoding (seeds.rs:63-78):
  x = rev << 63 | rid << 32 | rpos          (target axis)
  y = qspan << 32 | qpos'                   (query axis)
where qpos' is the raw query position for forward-matching anchors and the
reverse-complement-flipped position qlen - (qpos+1-qspan) - 1 otherwise.
"""

from __future__ import annotations

import numpy as np

from .index import OracleIndex
from .sketch import sketch_sequence, sketch_sequence_fast


def collect_query_minimizers(seq: bytes, w: int, k: int) -> list[tuple[int, int]]:
    """Query sketch in the exact scan's emission order (seeds.rs:7-11) —
    the order matters for the dv estimate (paf.rs:156-199). Dispatches to
    the native runtime when available (bit- and order-exact; fuzz-verified
    in tests/test_native_runtime.py)."""
    import os

    if len(seq) and not os.environ.get("MM2T_NO_NATIVE"):
        from ..runtime.host import native_sketch

        out = native_sketch(seq, w, k, rid=0, is_hpc=False)
        if out is not None:
            return out
    return sketch_sequence(seq, w, k, rid=0, is_hpc=False)


def collect_query_minimizers_fast(seq: bytes, w: int, k: int) -> np.ndarray:
    """Position-sorted query minimizer set (vectorized)."""
    return sketch_sequence_fast(seq, w, k, rid=0, is_hpc=False)


def filter_query_minimizers(
    mv: list[tuple[int, int]], q_occ_max: int, q_occ_frac: float
) -> list[tuple[int, int]]:
    """Drop over-represented query minimizer keys (seeds.rs:13-36): a key
    is dropped when its count exceeds both q_occ_max and
    floor(len * q_occ_frac); no-op when len <= q_occ_max."""
    if len(mv) == 0 or q_occ_frac <= 0.0 or q_occ_max <= 0:
        return mv
    if len(mv) <= q_occ_max:
        return mv
    if isinstance(mv, np.ndarray):
        keys = (mv[:, 0] >> np.uint64(8)).astype(np.uint64)
    else:
        keys = np.array([m[0] >> 8 for m in mv], dtype=np.uint64)
    cutoff = int(len(mv) * q_occ_frac)
    _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    keep = ~((cnt > q_occ_max) & (cnt > cutoff))[inv]
    if isinstance(mv, np.ndarray):
        return mv[keep]
    return [m for m, kp in zip(mv, keep) if kp]


def build_anchors(
    idx: OracleIndex,
    mv: list[tuple[int, int]] | np.ndarray,
    qlen: int,
    mid_occ: int = np.iinfo(np.int32).max,
) -> np.ndarray:
    """Anchors for a query's minimizers (build_anchors_filtered,
    seeds.rs:42-60). Keys with occurrence count > mid_occ are skipped
    unless they are singletons (the reference always keeps singletons,
    seeds.rs:48-50). Returns an (n, 2) uint64 array sorted by (x, y)."""
    if isinstance(mv, np.ndarray):
        pairs = mv.reshape(-1, 2)
    else:
        pairs = np.array(mv, dtype=np.uint64).reshape(-1, 2)
    if pairs.shape[0] == 0 or idx.keys.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    # vectorized over all minimizers at once: one searchsorted into the
    # flat sorted key table, then a repeat-expansion of the occurrence
    # blocks (the per-key Python loop cost ~4 ms/read; this is ~0.2 ms)
    key_span = pairs[:, 0].astype(np.uint64)
    qrps = pairs[:, 1].astype(np.uint64)
    minier = key_span >> np.uint64(8)
    nk = idx.keys.shape[0]
    pos = np.searchsorted(idx.keys, minier)
    posc = np.minimum(pos, nk - 1)
    found = idx.keys[posc] == minier
    count = np.where(found, idx.counts[posc], 0).astype(np.int64)
    start = idx.starts[posc].astype(np.int64)
    keep = found & ((count == 1) | (count <= mid_occ))
    cnt = np.where(keep, count, 0)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    rep = np.repeat(np.arange(cnt.shape[0]), cnt)
    cumprev = np.cumsum(cnt) - cnt
    occ = idx.positions[start[rep] + (np.arange(total) - cumprev[rep])]
    x, y = _encode_anchors(occ, key_span[rep], qrps[rep], qlen)
    order = np.lexsort((y, x))
    return np.stack([x[order], y[order]], axis=1)


def _encode_anchors(r: np.ndarray, key_span, qrps, qlen: int):
    """Vectorized push_anchor (seeds.rs:63-78); key_span/qrps may be
    scalars (one key's occurrence block) or arrays parallel to r.

    NOTE: the reference extracts rpos as (r >> 1) & 0xffffffff
    (seeds.rs:65), which leaks rid's low bit into rpos bit 31 for
    odd-numbered target sequences and corrupts their coordinates (it was
    only ever exercised on a single-sequence reference, README.md:8-27).
    We extract the position correctly: low 32 bits first, then shift."""
    key_span = np.asarray(key_span, dtype=np.uint64)
    qrps = np.asarray(qrps, dtype=np.uint64)
    rid = (r >> np.uint64(32)) & np.uint64(0xFFFFFFFF)
    rpos = (r & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
    rstrand = r & np.uint64(1)
    qpos = (qrps >> np.uint64(1)) & np.uint64(0xFFFFFFFF)
    qstrand = qrps & np.uint64(1)
    qspan = key_span & np.uint64(0xFF)
    forward = rstrand == qstrand
    x = (rid << np.uint64(32)) | rpos
    x = np.where(forward, x, x | np.uint64(1 << 63))
    qp_fwd = (qspan << np.uint64(32)) | qpos
    qp_rev = (qspan << np.uint64(32)) | (
        (np.uint64(qlen) - (qpos + np.uint64(1) - qspan) - np.uint64(1))
        & np.uint64(0xFFFFFFFF)
    )
    y = np.where(forward, qp_fwd, qp_rev)
    return x, y
