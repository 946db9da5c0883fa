"""Colinear chaining DP oracle — exact transcription of the reference's
semantics (reference src/lchain.rs), including:

- the minimap2-style score function with f32 penalty arithmetic and
  truncation (comput_sc, lchain.rs:17-34);
- the sliding predecessor window, max_chain_iter cap and the
  order-dependent max_chain_skip pruning with t[] marking
  (lchain.rs:74-91);
- the two-pass backtracking (lchain.rs:92-160). Note: the reference's
  mg_chain_bk_end walk always terminates after one step (it sets t[i]=2
  then immediately tests t[i]==0), so with min_cnt > 1 every candidate is
  rejected and the greedy best-chain fallback (lchain.rs:161-173) is what
  actually produces output — reproduced here faithfully, it explains the
  reference's s2:i:0 vs C minimap2 (README.md:21-26);
- chain selection, merge, and long-join rescue (lchain.rs:178-330).

Scores are exact integers; penalties are evaluated in float32 to match
Rust f32 arithmetic bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..config import ChainParams

_LN2_F32 = np.float32(0.6931472)  # std::f32::consts::LN_2
_I32_MIN = -(2**31)


def _qpos(y: int) -> int:
    return y & 0xFFFFFFFF


def _qspan(y: int) -> int:
    return (y >> 32) & 0xFF


def _rpos(x: int) -> int:
    return x & 0xFFFFFFFF


def _rev(x: int) -> bool:
    return (x >> 63) != 0


def _rid(x: int) -> int:
    return (x >> 32) & 0x7FFFFFFF


def mg_log2(x: int) -> np.float32:
    """f32 log2 with the x<=1 guard (lchain.rs:14-15)."""
    if x <= 1:
        return np.float32(0.0)
    return np.float32(np.log(np.float32(x))) / _LN2_F32


def comput_sc(
    xi: int, yi: int, xj: int, yj: int,
    max_dist_x: int, max_dist_y: int, bw: int,
    chn_pen_gap: float, chn_pen_skip: float,
) -> int | None:
    """Pairwise chaining score (lchain.rs:17-34); None when the pair is
    unchainable."""
    dq = _qpos(yi) - _qpos(yj)
    if dq <= 0 or dq > max_dist_x:
        return None
    dr = _rpos(xi) - _rpos(xj)
    if dr == 0 or dq > max_dist_y:
        return None
    dd = abs(dr - dq)
    if dd > bw:
        return None
    dg = min(dr, dq)
    q_span = _qspan(yj)
    sc = min(q_span, dg)
    if dd != 0 or dg > q_span:
        lin_pen = np.float32(chn_pen_gap) * np.float32(dd) + np.float32(chn_pen_skip) * np.float32(dg)
        log_pen = mg_log2(dd + 1) if dd >= 1 else np.float32(0.0)
        sc -= int(lin_pen + np.float32(0.5) * log_pen)  # `as i32` truncates
    return sc


def chain_dp_scores(anchors: np.ndarray, p: ChainParams):
    """The O(n*h) DP (lchain.rs:59-91). Returns (f, v, prev) arrays."""
    n = anchors.shape[0]
    f = np.zeros(n, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    t = np.zeros(n, dtype=np.int64)
    prev = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return f, v, prev
    max_dist_x = max(p.max_dist_x, p.bw)
    max_dist_y = max(p.max_dist_y, p.bw)
    ax = anchors[:, 0].tolist()
    ay = anchors[:, 1].tolist()
    st = 0
    for i in range(n):
        xi, yi = ax[i], ay[i]
        while st < i and (
            _rid(ax[st]) != _rid(xi)
            or _rev(ax[st]) != _rev(xi)
            or _rpos(xi) > _rpos(ax[st]) + max_dist_x
        ):
            st += 1
        max_j = -1
        max_f = _qspan(yi)
        start_j = max(st, i - p.max_chain_iter)
        n_skip = 0
        for j in range(i - 1, start_j - 1, -1):
            xj, yj = ax[j], ay[j]
            if _rid(xj) != _rid(xi) or _rev(xj) != _rev(xi):
                continue
            sc0 = comput_sc(xi, yi, xj, yj, max_dist_x, max_dist_y, p.bw,
                            p.chn_pen_gap, p.chn_pen_skip)
            if sc0 is None:
                continue
            sc = sc0 + f[j]
            if sc > max_f:
                max_f = sc
                max_j = j
                if n_skip > 0:
                    n_skip -= 1
            elif t[j] == i:
                n_skip += 1
                if n_skip > p.max_chain_skip:
                    break
            if prev[j] >= 0:
                t[prev[j]] = i
        f[i] = max_f
        prev[i] = max_j
        v[i] = v[max_j] if max_j >= 0 and v[max_j] > max_f else max_f
    return f, v, prev


def backtrack(anchors: np.ndarray, f, v, prev, p: ChainParams):
    """Two-pass backtracking + greedy fallback (lchain.rs:92-176).
    Returns (chains, scores) sorted by (score desc, qstart, tstart).

    v may be None: it is only read by the greedy fallback, where
    v[best_i] equals the maximum f along the backtracked path
    (lchain.rs:90) and is recomputed from f/prev."""
    n = anchors.shape[0]
    if n == 0:
        return [], []
    z = [(int(f[i]), i) for i in range(n) if f[i] > 0]
    if not z:
        return [], []
    z.sort(key=lambda x: x[0])  # stable, ties keep ascending index order
    t = np.zeros(n, dtype=np.int64)

    def bk_end(i0: int, zscore: int) -> int:
        """mg_chain_bk_end (lchain.rs:108-119,138-149): the loop sets
        t[i]=2 then tests t[i]==0, so it runs exactly one iteration (or
        breaks on max_drop) — returning prev[i0] when the one-step score
        is positive, else i0."""
        i = i0
        end_i = -1
        max_s = 0
        max_i = i
        if t[i] == 0:
            while True:
                t[i] = 2
                end_i = prev[i]
                s = zscore if end_i < 0 else zscore - int(f[end_i])
                if s > max_s:
                    max_s = s
                    max_i = end_i
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

    # first pass: count
    n_v = 0
    n_u = 0
    for zscore, i0 in reversed(z):
        if t[i0] != 0:
            continue
        end_i = bk_end(i0, zscore)
        len0 = n_v
        i = i0
        while i >= 0 and i != end_i:
            n_v += 1
            t[i] = 1
            i = prev[i]
        sc = zscore if i < 0 else zscore - int(f[i])
        if sc >= p.min_chain_score and n_v > len0 and (n_v - len0) >= p.min_cnt:
            n_u += 1
        else:
            n_v = len0
    # second pass: populate
    chains: list[list[int]] = []
    scores: list[int] = []
    t[:] = 0
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
            idxs.reverse()
            chains.append(idxs)
            scores.append(sc)
    # fallback: single greedy best chain (lchain.rs:161-173). Rust's
    # max_by_key returns the LAST maximal element on ties.
    if not chains:
        frev = np.asarray(f)[::-1]
        best_i = n - 1 - int(np.argmax(frev))
        idxs = []
        i = best_i
        while i >= 0:
            idxs.append(i)
            i = prev[i]
        idxs.reverse()
        if idxs:
            chains.append(idxs)
            score = int(v[best_i]) if v is not None else int(max(f[j] for j in idxs))
            scores.append(score)
    return sort_chains_stable(anchors, chains, scores)


def chain_dp_all(anchors: np.ndarray, p: ChainParams):
    """Full chaining (lchain.rs:59-176): DP + backtracking. Dispatches to
    the native runtime when available (bit-exact; see
    tests/test_native_runtime.py)."""
    import os

    if not os.environ.get("MM2T_NO_NATIVE"):
        from ..runtime.host import native_backtrack, native_chain_dp

        fvp = native_chain_dp(anchors, p)
        if fvp is not None:
            out = native_backtrack(anchors, *fvp, p)
            if out is not None:
                return out
    f, v, prev = chain_dp_scores(anchors, p)
    return backtrack(anchors, f, v, prev, p)


def chain_dp(anchors: np.ndarray, p: ChainParams) -> list[int]:
    """Best chain only (lchain.rs:54-57)."""
    chains, _ = chain_dp_all(anchors, p)
    return chains[0] if chains else []


def chain_qrange(anchors: np.ndarray, chain: list[int]) -> tuple[int, int]:
    """(qstart, qend) over a chain's anchors (lchain.rs:178-188)."""
    if not len(chain):
        return 0, -1
    ay = anchors[np.asarray(chain, dtype=np.int64), 1]
    qpos_v = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span_v = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    return max(int((qpos_v - (span_v - 1)).min()), 0), int(qpos_v.max()) + 1


def chain_trange(anchors: np.ndarray, chain: list[int]) -> tuple[int, int]:
    """(tstart, tend) over a chain's anchors (lchain.rs:190-200)."""
    if not len(chain):
        return 0, -1
    ch = np.asarray(chain, dtype=np.int64)
    ax = anchors[ch, 0]
    ay = anchors[ch, 1]
    rpos_v = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span_v = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    return max(int((rpos_v - (span_v - 1)).min()), 0), int(rpos_v.max()) + 1


def sort_chains_stable(anchors: np.ndarray, chains, scores):
    """Stable sort by (score desc, qstart asc, tstart asc)
    (lchain.rs:202-218)."""
    def keyfn(i):
        qs, _ = chain_qrange(anchors, chains[i])
        ts, _ = chain_trange(anchors, chains[i])
        return (-scores[i], qs, ts)

    idxs = sorted(range(len(chains)), key=keyfn)
    return [chains[i] for i in idxs], [scores[i] for i in idxs]


def select_primary_secondary(anchors, chains, scores, mask_level: float):
    """Mark secondaries by query-range overlap with kept primaries
    (lchain.rs:220-235)."""
    primaries: list[tuple[int, int]] = []
    is_primary = [True] * len(chains)
    for ci, chain in enumerate(chains):
        qs, qe = chain_qrange(anchors, chain)
        overlapped = False
        for pqs, pqe in primaries:
            ov = np.float32(max(min(qe, pqe) - max(qs, pqs), 0))
            ln = np.float32(max(qe - qs, 1))
            if ov / ln >= np.float32(mask_level):
                overlapped = True
                break
        if overlapped:
            is_primary[ci] = False
        else:
            primaries.append((qs, qe))
    return is_primary


def select_and_filter_chains(
    anchors, chains, scores, mask_level: float, pri_ratio: float, best_n: int
):
    """Keep the top chain + up to best_n secondaries above pri_ratio*s1;
    compute (s1, s2) (lchain.rs:237-260)."""
    if not chains:
        return [], [], [], 0, 0
    chains, scores = sort_chains_stable(anchors, list(chains), list(scores))
    is_primary = select_primary_secondary(anchors, chains, scores, mask_level)
    out_chains, out_scores, out_pri = [], [], []
    s1 = scores[0]
    s2 = 0
    sec_kept = 0
    for i, chain in enumerate(chains):
        if i == 0:
            out_chains.append(chain)
            out_scores.append(scores[i])
            out_pri.append(True)
        else:
            if not is_primary[i]:
                continue
            if np.float32(scores[i]) >= np.float32(pri_ratio) * np.float32(s1):
                if sec_kept < best_n:
                    out_chains.append(chain)
                    out_scores.append(scores[i])
                    out_pri.append(False)
                    sec_kept += 1
            if s2 == 0:
                s2 = scores[i]
    return out_chains, out_scores, out_pri, s1, s2


def merge_adjacent_chains_with_gap(anchors, chains, max_gap_q: int, max_gap_t: int):
    """Concatenate qstart-sorted chains on the same rid/strand within the
    gap thresholds (lchain.rs:288-314)."""
    items = sorted(
        ((chain_qrange(anchors, ch)[0], i) for i, ch in enumerate(chains)),
        key=lambda x: x[0],
    )
    merged: list[list[int]] = []
    for _qs, idx in items:
        ch = chains[idx]
        if not merged:
            merged.append(list(ch))
            continue
        last = merged[-1]
        a_last = int(anchors[last[-1], 0])
        a_first = int(anchors[ch[0], 0])
        same = _rid(a_last) == _rid(a_first) and _rev(a_last) == _rev(a_first)
        _, last_qe = chain_qrange(anchors, last)
        ch_qs, _ = chain_qrange(anchors, ch)
        _, last_te = chain_trange(anchors, last)
        ch_ts, _ = chain_trange(anchors, ch)
        q_gap = ch_qs - last_qe
        t_gap = ch_ts - last_te
        if same and 0 <= q_gap <= max_gap_q and 0 <= t_gap <= max_gap_t:
            last.extend(ch)
        else:
            merged.append(list(ch))
    return merged


def merge_adjacent_chains(anchors, chains):
    """No-gap variant (lchain.rs:262-286); present for parity, unused by
    the align pipeline."""
    items = sorted(
        ((chain_qrange(anchors, ch)[0], i) for i, ch in enumerate(chains)),
        key=lambda x: x[0],
    )
    merged: list[list[int]] = []
    for _qs, idx in items:
        ch = chains[idx]
        if not merged:
            merged.append(list(ch))
            continue
        last = merged[-1]
        a_last = int(anchors[last[-1], 0])
        a_first = int(anchors[ch[0], 0])
        same = _rid(a_last) == _rid(a_first) and _rev(a_last) == _rev(a_first)
        _, last_qe = chain_qrange(anchors, last)
        ch_qs, _ = chain_qrange(anchors, ch)
        if same and ch_qs <= last_qe:
            last.extend(ch)
        else:
            merged.append(list(ch))
    return merged


def chain_query_coverage(anchors, chain) -> int:
    qs, qe = chain_qrange(anchors, chain)
    return max(qe - qs, 0)


def rescue_long_join(anchors, chains, scores, p: ChainParams, qlen: int):
    """Re-run the DP with the wide band when the best chain covers too
    little of the query (lchain.rs:321-330)."""
    if not chains:
        return list(chains), list(scores)
    best_cov = chain_query_coverage(anchors, chains[0])
    uncovered = max(qlen - best_cov, 0)
    rescue = uncovered > p.rmq_rescue_size or np.float32(best_cov) < np.float32(qlen) * (
        np.float32(1.0) - np.float32(p.rmq_rescue_ratio)
    )
    if not rescue:
        return list(chains), list(scores)
    import dataclasses

    p2 = dataclasses.replace(p, bw=p.bw_long)
    return chain_dp_all(anchors, p2)
