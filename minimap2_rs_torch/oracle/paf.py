"""PAF record construction and formatting oracle
(reference src/paf.rs).

Includes the reference's dv estimate (mm_est_err style, paf.rs:156-199)
which re-sketches the query and counts chain minimizers matched in the
query minimizer stream — emission *order* matters here, so the exact scan
oracle is used. Also carries the reference's auxiliary alignment helpers
(banded edit distance, mismatch-rate dv, greedy end extension,
reverse-complement; paf.rs:35-124) for API parity — they are dead code in
the reference's pipeline (SURVEY.md 2.13) but part of its library surface.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .index import OracleIndex
from .seeds import collect_query_minimizers

_F32 = np.float32


@dataclasses.dataclass
class PafRecord:
    """One PAF line (paf.rs:4-24)."""

    qname: str
    qlen: int
    qstart: int
    qend: int
    strand: str
    tname: str
    tlen: int
    tstart: int
    tend: int
    nm: int
    blen: int
    mapq: int
    tp: str
    cm: int
    s1: int
    s2: int
    dv: float
    rl: int


def _qpos(y: int) -> int:
    return y & 0xFFFFFFFF


def _qspan(y: int) -> int:
    return (y >> 32) & 0xFF


def _rpos(x: int) -> int:
    return x & 0xFFFFFFFF


def _rev(x: int) -> bool:
    return (x >> 63) != 0


def _rust_binary_search(arr: list[int], target: int) -> int | None:
    """Rust's core::slice::binary_search_by over a (possibly imperfectly
    sorted) list — the reference calls it on the emission-order minimizer
    positions (paf.rs:178)."""
    size = len(arr)
    left, right = 0, size
    while left < right:
        mid = left + size // 2
        v = arr[mid]
        if v < target:
            left = mid + 1
        elif v > target:
            right = mid
        else:
            return mid
        size = right - left
    return None


def paf_from_chain(
    idx: OracleIndex,
    anchors: np.ndarray,
    chain: list[int],
    qname: str,
    qseq: bytes,
    is_primary: bool = True,
    mv: list[tuple[int, int]] | None = None,
) -> PafRecord | None:
    """Build a PAF record from a chain (paf_from_chain_with_primary,
    paf.rs:130-222). `mv` optionally supplies precomputed query
    minimizers for the dv estimate (the reference re-sketches the query
    on every record, paf.rs:156; the device pipeline passes its own)."""
    if not chain:
        return None
    strand = "-" if _rev(int(anchors[chain[0], 0])) else "+"
    ch = np.asarray(chain, dtype=np.int64)
    ax = anchors[ch, 0]
    ay = anchors[ch, 1]
    qpos_v = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span_v = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rpos_v = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    cm = int(ch.shape[0])
    qs = int((qpos_v - (span_v - 1)).min())
    qe = int(qpos_v.max()) + 1
    ts = int((rpos_v - (span_v - 1)).min())
    te = int(rpos_v.max()) + 1
    qs = max(qs, 0)
    ts = max(ts, 0)
    rid0 = (int(anchors[chain[0], 0]) >> 32) & 0x7FFFFFFF
    tname = idx.seq[rid0].name or "*"
    tlen = idx.seq[rid0].length
    mlen = max(qe - qs, 0)
    blen = max(te - ts, 0)
    qlen = len(qseq)

    # dv estimate (paf.rs:156-199)
    if mv is None:
        mv = collect_query_minimizers(qseq, idx.w, idx.k)
    mini_pos = [(r >> 1) & 0xFFFFFFFF for _, r in mv]
    sum_k = sum(ks & 0xFF for ks, _ in mv)
    avg_k = _F32(sum_k) / _F32(len(mv)) if mv else _F32(idx.k)

    rev_v = (ax >> np.uint64(63)) != 0
    qfwd = np.where(rev_v, qlen - 1 - (qpos_v + 1 - span_v), qpos_v)
    chain_qs_fwd = qfwd[::-1].tolist() if strand == "-" else qfwd.tolist()

    dv = _F32(0.0)
    if mini_pos and chain_qs_fwd:
        first = chain_qs_fwd[0]
        st = _rust_binary_search(mini_pos, first)
        if st is not None:
            while st > 0 and mini_pos[st - 1] == first:
                st -= 1
            j = st
            kk = 1
            en = st
            n_match = 1
            while j + 1 < len(mini_pos) and kk < len(chain_qs_fwd):
                j += 1
                if mini_pos[j] == chain_qs_fwd[kk]:
                    n_match += 1
                    en = j
                    kk += 1
            n_tot = (en - st) + 1
            # edge adjustment with printed (forward-strand) coordinates
            r_qs_final = qlen - qe if strand == "-" else qs
            r_qe_final = qlen - qs if strand == "-" else qe
            if r_qs_final > int(avg_k) and ts > int(avg_k):
                n_tot += 1
            if (qlen - r_qe_final) > int(avg_k) and (tlen - te) > int(avg_k):
                n_tot += 1
            frac = _F32(n_match) / _F32(n_tot)
            if frac >= _F32(1.0):
                dv = _F32(0.0)
            else:
                dv = _F32(1.0) - frac ** (_F32(1.0) / max(avg_k, _F32(1.0)))

    return PafRecord(
        qname=qname, qlen=qlen, qstart=qs, qend=qe, strand=strand,
        tname=tname, tlen=tlen, tstart=ts, tend=te, nm=mlen, blen=blen,
        mapq=60, tp="P" if is_primary else "S", cm=cm, s1=0, s2=0,
        dv=float(dv), rl=0,
    )


def write_paf(rec: PafRecord) -> str:
    """Format one PAF line; query coords flip to forward strand for '-'
    at write time (paf.rs:224-236)."""
    if rec.strand == "-":
        qs, qe = rec.qlen - rec.qend, rec.qlen - rec.qstart
    else:
        qs, qe = rec.qstart, rec.qend
    return (
        f"{rec.qname}\t{rec.qlen}\t{qs}\t{qe}\t{rec.strand}\t{rec.tname}\t"
        f"{rec.tlen}\t{rec.tstart}\t{rec.tend}\t{rec.nm}\t{rec.blen}\t"
        f"{rec.mapq}\ttp:A:{rec.tp}\tcm:i:{rec.cm}\ts1:i:{rec.s1}\t"
        f"s2:i:{rec.s2}\tdv:f:{rec.dv:.4f}\trl:i:{rec.rl}"
    )


def write_paf_many_with_scores(
    idx: OracleIndex,
    anchors: np.ndarray,
    chains: list[list[int]],
    top_s1: int,
    top_s2: int,
    qname: str,
    qseq: bytes,
    mv: list[tuple[int, int]] | None = None,
) -> list[str]:
    """Emit all chains, stamping the global s1/s2 (paf.rs:238-248)."""
    out = []
    for ci, chain in enumerate(chains):
        rec = paf_from_chain(idx, anchors, chain, qname, qseq, is_primary=(ci == 0), mv=mv)
        if rec is not None:
            rec.s1 = max(top_s1, 0)
            rec.s2 = max(top_s2, 0)
            out.append(write_paf(rec))
    return out


# ---- auxiliary alignment helpers (reference API parity; paf.rs:35-124) --


def banded_edit_distance(q: bytes, r: bytes, band: int) -> tuple[int, int]:
    """Banded Levenshtein distance; returns (edits, max(len)) or the
    worst case when the end cell falls outside the band (paf.rs:35-79)."""
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return max(n, m), max(n, m)
    if abs(m - n) > band:
        return max(n, m), max(n, m)
    qa = np.frombuffer(q.upper(), dtype=np.uint8)
    ra = np.frombuffer(r.upper(), dtype=np.uint8)
    inf = n + m + 1
    width = 2 * band + 1
    prev = np.full(width, inf, dtype=np.int64)
    prev[band] = 0
    for i in range(0, n + 1):
        if i == 0:
            # row 0: curr[k] = j for j = k - band... only insertions
            curr = prev
            for j in range(1, min(band, m) + 1):
                curr[j + band] = j
            continue
        curr = np.full(width, inf, dtype=np.int64)
        j_lo = max(i - band, 0)
        j_hi = min(i + band, m)
        for j in range(j_lo, j_hi + 1):
            kd = j - i + band
            best = inf
            if kd + 1 < width:
                best = min(best, prev[kd + 1] + 1)  # deletion from q
            if kd - 1 >= 0 and j > 0:
                best = min(best, curr[kd - 1] + 1)  # insertion
            if j > 0:
                cost = 0 if qa[i - 1] == ra[j - 1] else 1
                best = min(best, prev[kd] + cost)
            elif j == 0:
                best = min(best, i)  # deletions only
            curr[kd] = best
        prev = curr
    kd = m - n + band
    if 0 <= kd < width:
        return int(prev[kd]), max(n, m)
    return max(n, m), max(n, m)


def estimate_dv_by_mismatch(q: bytes, r: bytes) -> float:
    """Hamming-style divergence over the common prefix (paf.rs:81-87)."""
    if not q or not r:
        return 0.0
    n = min(len(q), len(r))
    qa = np.frombuffer(q[:n].upper(), dtype=np.uint8)
    ra = np.frombuffer(r[:n].upper(), dtype=np.uint8)
    return float(np.count_nonzero(qa != ra)) / n


def end_extend(
    idx: OracleIndex, qseq: bytes, rid: int, qs: int, qe: int, ts: int, te: int,
    max_ext: int,
) -> tuple[int, int, int, int]:
    """Greedy exact-match extension of both ends (paf.rs:89-109)."""
    tlen = idx.seq[rid].length
    qlen = len(qseq)
    q_up = qseq.upper()
    ext = 0
    while ext < max_ext and qs > 0 and ts > 0:
        rb = idx.get_ref_subseq(rid, ts - 1, ts)
        if not rb or q_up[qs - 1] != rb.upper()[0]:
            break
        qs -= 1
        ts -= 1
        ext += 1
    ext = 0
    while ext < max_ext and qe < qlen and te < tlen:
        rb = idx.get_ref_subseq(rid, te, te + 1)
        if not rb or q_up[qe] != rb.upper()[0]:
            break
        qe += 1
        te += 1
        ext += 1
    return qs, qe, ts, te


def write_paf_many(
    idx: OracleIndex,
    anchors: np.ndarray,
    chains: list[list[int]],
    qname: str,
    qseq: bytes,
) -> list[str]:
    """Emit all chains without s1/s2 stamping (paf.rs:250-258; unused by
    the reference's align pipeline, kept for API parity)."""
    out = []
    for ci, chain in enumerate(chains):
        rec = paf_from_chain(idx, anchors, chain, qname, qseq, is_primary=(ci == 0))
        if rec is not None:
            out.append(write_paf(rec))
    return out
