"""One read through the reference, written from minimap2_rs's main.rs:
sketch the read, drop its over-represented minimizers (seeds.rs:13-36),
look its keys up, skipping those above mid_occ unless they occur once
(seeds.rs:42-60), place the anchors (seeds.rs:63-78), chain, rescue with
the wide band, merge, select and write PAF (main.rs:193-219)."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import chain as ch
from .index import RefIndex
from .paf import paf_line
from .sketch import query_minimizers


@dataclasses.dataclass(frozen=True)
class MapParams:
    """minimap2_rs's mapping defaults (main.rs:55-89, 195-197)."""

    q_occ_max: int = 10
    q_occ_frac: float = 0.01
    frac_top_repetitive: float = 2e-4
    mid_occ_floor: int = 10
    mask_level: float = 0.5
    pri_ratio: float = 0.8
    best_n: int = 5


def filter_minimizers(mv: list, q_occ_max: int, q_occ_frac: float) -> list:
    """Drop a key that occurs more than q_occ_max times in the read and
    more than floor(len * q_occ_frac) times (seeds.rs:13-36)."""
    if not mv or q_occ_frac <= 0.0 or q_occ_max <= 0 or len(mv) <= q_occ_max:
        return mv
    keys = np.array([m[0] >> 8 for m in mv], dtype=np.uint64)
    _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    drop = ((cnt > q_occ_max) & (cnt > int(len(mv) * q_occ_frac)))[inv]
    return [m for m, d in zip(mv, drop) if not d]


def anchors_for(idx: RefIndex, mv: list, qlen: int) -> np.ndarray:
    """(n, 2) uint64 anchors x = rev << 63 | rid << 32 | rpos, y = span
    << 32 | qpos (the read's position flipped on the reverse strand),
    sorted by (x, y)."""
    if not mv or idx.keys.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    pairs = np.array(mv, dtype=np.uint64).reshape(-1, 2)
    key_span, qrps = pairs[:, 0], pairs[:, 1]
    key = key_span >> np.uint64(8)
    at = np.minimum(np.searchsorted(idx.keys, key), idx.keys.shape[0] - 1)
    found = idx.keys[at] == key
    cnt = np.where(found, idx.counts[at], 0)
    cnt = np.where((cnt == 1) | (cnt <= idx.mid_occ), cnt, 0)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    rep = np.repeat(np.arange(cnt.shape[0]), cnt)
    r = idx.positions[idx.starts[at][rep] + np.arange(total) - (np.cumsum(cnt) - cnt)[rep]]
    u = np.uint64
    rid = r >> u(32)
    rpos = (r & u(0xFFFFFFFF)) >> u(1)
    qpos = (qrps[rep] >> u(1)) & u(0xFFFFFFFF)
    qspan = key_span[rep] & u(0xFF)
    fwd = (r & u(1)) == (qrps[rep] & u(1))
    x = (rid << u(32)) | rpos
    x = np.where(fwd, x, x | u(1 << 63))
    qflip = (u(qlen) - (qpos + u(1) - qspan) - u(1)) & u(0xFFFFFFFF)
    y = (qspan << u(32)) | np.where(fwd, qpos, qflip)
    order = np.lexsort((y, x))
    return np.stack([x[order], y[order]], axis=1)


def map_read(idx: RefIndex, qname: str, qseq: bytes, cp: ch.ChainParams, mp: MapParams,
             mode: str = "prune", pen_dtype: str = "float32") -> list[str]:
    """The read's PAF lines. mode: the chain DP's, "prune" (the
    reference's) or "exact" (reference/chain.py)."""
    if not qseq:
        return []
    mv = query_minimizers(qseq, idx.w, idx.k)
    anchors = anchors_for(idx, filter_minimizers(mv, mp.q_occ_max, mp.q_occ_frac), len(qseq))
    chains, scores = ch.chain_all(anchors, cp, cp.bw, mode, pen_dtype)
    if not chains:
        return []
    chains, scores = ch.rescue(anchors, chains, scores, cp, len(qseq), mode, pen_dtype)
    merged = ch.merge_with_gap(anchors, chains, cp.max_dist_y, cp.max_dist_y)
    # main.rs:217 pairs the merged chains with the scores from before the merge
    sel, s1, s2 = ch.select(anchors, merged, scores[: len(merged)],
                            mp.mask_level, mp.pri_ratio, mp.best_n)
    return [paf_line(anchors, c, qname, len(qseq), idx.names, idx.lengths, mv, idx.k,
                     n == 0, s1, s2) for n, c in enumerate(sel)]
