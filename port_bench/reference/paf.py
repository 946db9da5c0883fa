"""PAF lines, written from minimap2_rs's paf.rs:130-248, with its dv
estimate (paf.rs:156-199), which reads the read's minimizers in the
scan's emission order."""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _rust_binary_search(arr: list[int], target: int) -> int | None:
    """core::slice::binary_search_by over a list that may be out of
    order in places, as paf.rs:178 calls it."""
    size = len(arr)
    left, right = 0, size
    while left < right:
        mid = left + size // 2
        if arr[mid] < target:
            left = mid + 1
        elif arr[mid] > target:
            right = mid
        else:
            return mid
        size = right - left
    return None


def _dv(mv, qfwd: list[int], qlen: int, qs: int, qe: int, ts: int, te: int,
        tlen: int, strand: str, k: int) -> np.float32:
    mini_pos = [(r >> 1) & 0xFFFFFFFF for _, r in mv]
    avg_k = _F32(sum(ks & 0xFF for ks, _ in mv)) / _F32(len(mv)) if mv else _F32(k)
    if not (mini_pos and qfwd):
        return _F32(0.0)
    st = _rust_binary_search(mini_pos, qfwd[0])
    if st is None:
        return _F32(0.0)
    while st > 0 and mini_pos[st - 1] == qfwd[0]:
        st -= 1
    j, kk, en, n_match = st, 1, st, 1
    while j + 1 < len(mini_pos) and kk < len(qfwd):
        j += 1
        if mini_pos[j] == qfwd[kk]:
            n_match += 1
            en = j
            kk += 1
    n_tot = en - st + 1
    wqs, wqe = (qlen - qe, qlen - qs) if strand == "-" else (qs, qe)
    if wqs > int(avg_k) and ts > int(avg_k):
        n_tot += 1
    if qlen - wqe > int(avg_k) and tlen - te > int(avg_k):
        n_tot += 1
    frac = _F32(n_match) / _F32(n_tot)
    if frac >= _F32(1.0):
        return _F32(0.0)
    return _F32(1.0) - frac ** (_F32(1.0) / max(avg_k, _F32(1.0)))


def paf_line(anchors: np.ndarray, chain: list[int], qname: str, qlen: int,
             names: list[str], lengths: list[int], mv, k: int, primary: bool,
             s1: int, s2: int) -> str:
    """One chain's PAF line (paf.rs:130-236): query coordinates flip to
    the forward strand for '-', mapq is 60, s1 and s2 the read's."""
    ch = np.asarray(chain, dtype=np.int64)
    ax, ay = anchors[ch, 0], anchors[ch, 1]
    strand = "-" if int(ax[0]) >> 63 else "+"
    qp = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sp = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rp = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qs = max(int((qp - (sp - 1)).min()), 0)
    qe = int(qp.max()) + 1
    ts = max(int((rp - (sp - 1)).min()), 0)
    te = int(rp.max()) + 1
    rid = (int(ax[0]) >> 32) & 0x7FFFFFFF
    rev = (ax >> np.uint64(63)) != 0
    qfwd = np.where(rev, qlen - 1 - (qp + 1 - sp), qp)
    qfwd = qfwd[::-1].tolist() if strand == "-" else qfwd.tolist()
    dv = _dv(mv, qfwd, qlen, qs, qe, ts, te, lengths[rid], strand, k)
    wqs, wqe = (qlen - qe, qlen - qs) if strand == "-" else (qs, qe)
    return (
        f"{qname}\t{qlen}\t{wqs}\t{wqe}\t{strand}\t{names[rid] or '*'}\t"
        f"{lengths[rid]}\t{ts}\t{te}\t{max(qe - qs, 0)}\t{max(te - ts, 0)}\t"
        f"60\ttp:A:{'P' if primary else 'S'}\tcm:i:{len(chain)}\ts1:i:{max(s1, 0)}\t"
        f"s2:i:{max(s2, 0)}\tdv:f:{float(dv):.4f}\trl:i:0"
    )
