"""Colinear chaining, written from minimap2_rs's lchain.rs.

The DP (lchain.rs:59-91) runs a Python loop over the anchors with the
predecessor window of each one as NumPy vectors, in one of two modes:

* "prune": the reference's own walk, newest predecessor first, with its
  order-dependent max_chain_skip break (lchain.rs:79-88). The walk is
  worked out over the whole window at once: a mark (t[j] == i) falls on
  j when j is the predecessor of an admissible j' > j in the window; a
  beat is a score above the running best, seeded with the anchor's span;
  the skip counter (+1 on a marked non-beat, -1 on a beat, never below 0)
  is a reflected random walk, so its value at each step is its running
  sum less the running minimum of that sum (when negative); the walk
  stops at the first step where it passes max_chain_skip.
* "exact": every admissible predecessor of the window is scored, as the
  mapper's device DP does by default (a superset of the pruned walk).

Scores are integers; the penalty is float32 with one rounding per
operation and truncation, as Rust's f32 `as i32` (lchain.rs:17-34).
`pen_dtype="bfloat16"` is the control that a lower precision fails: the
penalty in bfloat16, and every score f[j] + sc rounded to bfloat16. (A
bfloat16 penalty alone differs from float32 only at gaps dd > 50, which
chains seldom hold.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_LN2_F32 = np.float32(0.6931472)  # std::f32::consts::LN_2


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """minimap2_rs's chaining defaults (main.rs:105-123) for k."""

    k: int
    max_dist_x: int = 5000
    max_dist_y: int = 5000
    bw: int = 500
    max_chain_iter: int = 5000
    min_chain_score: int = 40
    min_cnt: int = 3
    chn_pen_skip: float = 0.0
    max_chain_skip: int = 25
    max_drop: int = 500
    bw_long: int = 20000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1

    @property
    def chn_pen_gap(self) -> float:
        return 0.01 * 0.8 * float(self.k)  # main.rs:106-107


def mg_log2(x: int) -> np.float32:
    """f32 log2 with the x <= 1 guard (lchain.rs:14-15)."""
    if x <= 1:
        return np.float32(0.0)
    return np.float32(np.log(np.float32(x))) / _LN2_F32


_LOG2: dict[int, np.ndarray] = {}


def _log2_table(n: int) -> np.ndarray:
    """Entry dd: mg_log2(dd + 1) as float32, each worked out one by one."""
    if n not in _LOG2:
        _LOG2[n] = np.array([mg_log2(d + 1) for d in range(n)], dtype=np.float32)
    return _LOG2[n]


def _penalty(dd: np.ndarray, dg: np.ndarray, bw: int, p: ChainParams,
             pen_dtype: str) -> np.ndarray:
    """int(gap * dd + skip * dg + 0.5 * log2(dd + 1)) for admissible pairs."""
    logp = _log2_table(max(p.bw, p.bw_long) + 1)[np.minimum(dd, bw)]
    if pen_dtype == "float32":
        f32 = np.float32
        lin = f32(p.chn_pen_gap) * dd.astype(f32) + f32(p.chn_pen_skip) * dg.astype(f32)
        return (lin + f32(0.5) * logp).astype(np.int64)
    if pen_dtype != "bfloat16":
        raise ValueError(pen_dtype)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(torch.bfloat16)  # noqa: E731
    lin = t(p.chn_pen_gap) * t(dd) + t(p.chn_pen_skip) * t(dg)
    return (lin + t(0.5) * t(logp)).to(torch.int64).numpy()


def chain_dp(anchors: np.ndarray, p: ChainParams, bw: int, mode: str,
             pen_dtype: str = "float32"):
    """(f, v, prev) of the DP over (n, 2) uint64 anchors sorted by (x, y)."""
    n = anchors.shape[0]
    f = np.zeros(n, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    prev = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return f, v, prev
    x = anchors[:, 0]
    y = anchors[:, 1]
    rpos = (x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qpos = (y & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    mdx = max(p.max_dist_x, bw)
    mdy = max(p.max_dist_y, bw)
    # the window's oldest slot: the first anchor of i's target and strand
    # within mdx bases of it (lchain.rs:68-72), at most max_chain_iter back
    thr = x - np.minimum(rpos, mdx).astype(np.uint64)
    start = np.maximum(np.searchsorted(x, thr, side="left"),
                       np.arange(n) - p.max_chain_iter)
    for i in range(n):
        s0 = int(start[i])
        best, jb = int(span[i]), -1
        if s0 < i:
            dq = qpos[i] - qpos[s0:i]
            dr = rpos[i] - rpos[s0:i]
            dd = np.abs(dr - dq)
            ok = (dq > 0) & (dq <= mdx) & (dr != 0) & (dq <= mdy) & (dd <= bw)
            js = np.nonzero(ok)[0]
            if js.size:
                dd, dg = dd[js], np.minimum(dr[js], dq[js])
                sp = span[s0:i][js]
                sc = np.minimum(sp, dg)
                need = (dd != 0) | (dg > sp)
                sc = np.where(need, sc - _penalty(dd, dg, bw, p, pen_dtype), sc)
                cand = sc + f[s0:i][js]
                if pen_dtype == "bfloat16":
                    cand = torch.from_numpy(cand.astype(np.float32)).to(
                        torch.bfloat16).to(torch.int64).numpy()
                js = js + s0
                if mode == "exact":
                    top = int(cand.max())
                    if top > best:
                        best, jb = top, int(js[np.nonzero(cand == top)[0][-1]])
                elif mode == "prune":
                    cd, jd = cand[::-1], js[::-1]  # newest first
                    pj = prev[js]
                    mark = np.isin(jd, pj[pj >= 0])
                    run = np.maximum.accumulate(np.concatenate([[best], cd]))
                    beat = cd > run[:-1]
                    skip = mark & ~beat
                    walk = np.cumsum(skip.astype(np.int64) - beat.astype(np.int64))
                    counter = walk - np.minimum(np.minimum.accumulate(walk), 0)
                    over = np.nonzero(skip & (counter > p.max_chain_skip))[0]
                    seen = int(over[0]) if over.size else cd.size
                    if seen:
                        t = int(np.argmax(cd[:seen]))
                        if cd[t] > best:
                            best, jb = int(cd[t]), int(jd[t])
                else:
                    raise ValueError(mode)
        f[i] = best
        prev[i] = jb
        v[i] = v[jb] if jb >= 0 and v[jb] > best else best
    return f, v, prev


def backtrack(anchors: np.ndarray, f, v, prev, p: ChainParams):
    """The backtrack over the anchors by score and the greedy fallback
    (lchain.rs:92-176); (chains, scores) sorted as sort_chains.
    mg_chain_bk_end's loop sets t[i] = 2 and then tests t[i] == 0, so it
    runs one step (or breaks on max_drop)."""
    n = anchors.shape[0]
    if n == 0:
        return [], []
    z = sorted(((int(f[i]), i) for i in range(n) if f[i] > 0), key=lambda e: e[0])
    if not z:
        return [], []
    t = np.zeros(n, dtype=np.int64)

    def bk_end(i0: int, zscore: int) -> int:
        i, end_i, max_s, max_i = i0, -1, 0, i0
        if t[i] == 0:
            while True:
                t[i] = 2
                end_i = prev[i]
                s = zscore if end_i < 0 else zscore - int(f[end_i])
                if s > max_s:
                    max_s, max_i = s, end_i
                elif max_s - s > p.max_drop:
                    break
                if not (i >= 0 and t[i] == 0 and end_i >= 0):
                    break
                i = end_i
            ii = i0
            while ii >= 0 and ii != end_i:
                t[ii] = 0
                ii = prev[ii]
        return max_i

    # the reference's first pass only counts (its n_u is never read)
    chains: list[list[int]] = []
    scores: list[int] = []
    for zscore, i0 in reversed(z):
        if t[i0] != 0:
            continue
        end_i = bk_end(i0, zscore)
        idxs: list[int] = []
        i = i0
        while i >= 0 and i != end_i:
            idxs.append(i)
            t[i] = 1
            i = prev[i]
        sc = zscore if i < 0 else zscore - int(f[i])
        if sc >= p.min_chain_score and len(idxs) >= p.min_cnt:
            chains.append(idxs[::-1])
            scores.append(sc)
    if not chains:
        # Rust's max_by_key keeps the last of equal maxima
        best_i = n - 1 - int(np.argmax(np.asarray(f)[::-1]))
        idxs = []
        i = best_i
        while i >= 0:
            idxs.append(i)
            i = prev[i]
        chains.append(idxs[::-1])
        scores.append(int(v[best_i]))
    return sort_chains(anchors, chains, scores)


def qrange(anchors: np.ndarray, chain) -> tuple[int, int]:
    """(qstart, qend) of a chain (lchain.rs:178-188)."""
    if not len(chain):
        return 0, -1
    ay = anchors[np.asarray(chain, dtype=np.int64), 1]
    qp = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sp = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    return max(int((qp - (sp - 1)).min()), 0), int(qp.max()) + 1


def trange(anchors: np.ndarray, chain) -> tuple[int, int]:
    """(tstart, tend) of a chain (lchain.rs:190-200)."""
    if not len(chain):
        return 0, -1
    ch = np.asarray(chain, dtype=np.int64)
    rp = (anchors[ch, 0] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sp = ((anchors[ch, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    return max(int((rp - (sp - 1)).min()), 0), int(rp.max()) + 1


def sort_chains(anchors, chains, scores):
    """Stable sort by (score desc, qstart, tstart) (lchain.rs:202-218)."""
    keyed = sorted(range(len(chains)), key=lambda c: (
        -scores[c], qrange(anchors, chains[c])[0], trange(anchors, chains[c])[0]))
    return [chains[c] for c in keyed], [scores[c] for c in keyed]


def _grp(anchors, a: int) -> int:
    return int(anchors[a, 0]) >> 32  # rev << 31 | rid


def merge_with_gap(anchors, chains, max_gap_q: int, max_gap_t: int):
    """Join qstart-sorted chains of one target and strand within the gaps
    (lchain.rs:288-314)."""
    items = sorted(((qrange(anchors, ch)[0], c) for c, ch in enumerate(chains)),
                   key=lambda e: e[0])
    merged: list[list[int]] = []
    for _qs, c in items:
        ch = chains[c]
        if merged:
            last = merged[-1]
            q_gap = qrange(anchors, ch)[0] - qrange(anchors, last)[1]
            t_gap = trange(anchors, ch)[0] - trange(anchors, last)[1]
            if (_grp(anchors, last[-1]) == _grp(anchors, ch[0])
                    and 0 <= q_gap <= max_gap_q and 0 <= t_gap <= max_gap_t):
                last.extend(ch)
                continue
        merged.append(list(ch))
    return merged


def select(anchors, chains, scores, mask_level: float, pri_ratio: float, best_n: int):
    """The primary, up to best_n secondaries at pri_ratio of s1 and not
    masked by a kept primary, and (s1, s2) (lchain.rs:220-260)."""
    if not chains:
        return [], 0, 0
    chains, scores = sort_chains(anchors, list(chains), list(scores))
    primaries: list[tuple[int, int]] = []
    is_pri = []
    for ch in chains:
        qs, qe = qrange(anchors, ch)
        masked = any(
            np.float32(max(min(qe, pe) - max(qs, ps), 0)) / np.float32(max(qe - qs, 1))
            >= np.float32(mask_level)
            for ps, pe in primaries)
        is_pri.append(not masked)
        if not masked:
            primaries.append((qs, qe))
    out = [chains[0]]
    s1, s2, kept = scores[0], 0, 0
    for c in range(1, len(chains)):
        if not is_pri[c]:
            continue
        if np.float32(scores[c]) >= np.float32(pri_ratio) * np.float32(s1) and kept < best_n:
            out.append(chains[c])
            kept += 1
        if s2 == 0:
            s2 = scores[c]
    return out, s1, s2


def chain_all(anchors, p: ChainParams, bw: int, mode: str, pen_dtype: str = "float32"):
    """DP and backtrack at band bw: (chains, scores)."""
    f, v, prev = chain_dp(anchors, p, bw, mode, pen_dtype)
    return backtrack(anchors, f, v, prev, p)


def rescue(anchors, chains, scores, p: ChainParams, qlen: int, mode: str,
           pen_dtype: str = "float32"):
    """The wide-band re-run when the best chain covers too little of the
    read (lchain.rs:321-330)."""
    if not chains:
        return chains, scores
    qs, qe = qrange(anchors, chains[0])
    cov = max(qe - qs, 0)
    if max(qlen - cov, 0) > p.rmq_rescue_size or np.float32(cov) < np.float32(qlen) * (
            np.float32(1.0) - np.float32(p.rmq_rescue_ratio)):
        return chain_all(anchors, p, p.bw_long, mode, pen_dtype)
    return chains, scores
