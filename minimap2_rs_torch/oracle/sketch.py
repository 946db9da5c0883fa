"""Minimizer sketching oracles.

Two implementations of (w,k)-minimizer extraction:

- ``sketch_sequence``: an exact transcription of the reference's sequential
  scan semantics (reference src/sketch.rs:29-100), including emission
  order, tie handling, N-resets and the HPC span queue. Pure Python, used as
  the ground-truth oracle and wherever emission *order* matters (the dv
  estimate re-sketches the query, paf.rs:156).

- ``sketch_sequence_fast``: a fully vectorized NumPy formulation based on a
  window-minimum *set characterization*; it is the prototype for the TPU
  kernel (ops/sketch.py). Derivation (validated by fuzzing in
  tests/test_sketch.py):

    * a record at position j (k-mer ending at j) is valid iff the last k
      bases are ACGT (l >= k since the previous reset), the k-mer is not
      strand-symmetric, and span < 256 (sketch.rs:63-74);
    * a window ending at e is "complete" iff l[e] >= w+k-1 (sketch.rs:80);
    * j is emitted iff valid and key_span[j] attains the window minimum of
      some complete window containing j;
    * run-end drop: at every N reset, the currently tracked minimum (the
      newest tied occurrence of the window minimum ending at the run's last
      position) slides out during the dead zone where the l >= w+k-1
      emission gates are false (sketch.rs:85,88,92) and is silently lost;
    * final emission: the scan flushes the running minimum at sequence end
      unconditionally (sketch.rs:99) — the newest tied occurrence of the
      minimum over the last w positions.

  Known, documented deviations from the exact scan (rare, tie-dependent;
  none arise for random 4-letter sequences with odd k): the scan can emit a
  record *twice* (multiset) after certain rescans, and ties arriving exactly
  at a window-completion step can swap which tied copy is emitted. For even
  k, strand-symmetric k-mers interact with the l counter in corner cases.
  The fast path produces a set; downstream stages (index build, anchor
  sort) are order- and duplicate-insensitive for all parity targets.

Encodings (sketch.rs:16-19):
  key_span       = hash64(canonical_kmer) << 8 | span
  rid_pos_strand = rid << 32 | last_base_pos << 1 | strand
"""

from __future__ import annotations

import numpy as np

from ..utils.packing import nt4_encode

U64 = 0xFFFFFFFFFFFFFFFF
_U64 = np.uint64(U64)


def hash64(key: int, mask: int) -> int:
    """Invertible integer hash finalizer (sketch.rs:4-13), scalar."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_np(keys: np.ndarray, mask: int) -> np.ndarray:
    """Vectorized hash64 over a uint64 array."""
    m = np.uint64(mask)
    k = keys.astype(np.uint64)
    with np.errstate(over="ignore"):
        k = (~k + (k << np.uint64(21))) & m
        k ^= k >> np.uint64(24)
        k = (k + (k << np.uint64(3)) + (k << np.uint64(8))) & m
        k ^= k >> np.uint64(14)
        k = (k + (k << np.uint64(2)) + (k << np.uint64(4))) & m
        k ^= k >> np.uint64(28)
        k = (k + (k << np.uint64(31))) & m
    return k


def sketch_sequence(
    seq: bytes | np.ndarray,
    w: int,
    k: int,
    rid: int = 0,
    is_hpc: bool = False,
) -> list[tuple[int, int]]:
    """Exact reference scan (sketch.rs:29-100). Returns a list of
    (key_span, rid_pos_strand) in the reference's emission order."""
    codes = nt4_encode(seq)
    n = len(codes)
    assert n > 0
    assert 0 < w < 256
    assert 0 < k <= 28

    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    kmer = [0, 0]

    l = 0
    buf_pos = 0
    min_pos = 0
    kmer_span = 0
    buf: list[tuple[int, int]] = [(U64, U64)] * w
    mn = (U64, U64)
    out: list[tuple[int, int]] = []

    # HPC span queue (sketch.rs:21-27; the 32-slot ring only holds k <= 28
    # entries so a plain list is equivalent)
    tq: list[int] = []

    for i in range(n):
        c = int(codes[i])
        info = (U64, U64)
        if c < 4:
            if is_hpc:
                skip_len = 1
                if i + 1 < n and int(codes[i + 1]) == c:
                    t = i + 2
                    while t < n and int(codes[t]) == c:
                        t += 1
                    skip_len = t - i
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.pop(0)
            else:
                kmer_span = l + 1 if l + 1 < k else k
            kmer[0] = ((kmer[0] << 2) | c) & mask
            kmer[1] = (kmer[1] >> 2) | ((3 ^ c) << shift1)
            if kmer[0] != kmer[1]:  # skip strand-symmetric k-mers
                z = 0 if kmer[0] < kmer[1] else 1
                l += 1
                if l >= k and kmer_span < 256:
                    key_span = (hash64(kmer[z], mask) << 8) | kmer_span
                    rps = (rid << 32) | (i << 1) | z
                    info = (key_span, rps)
        else:
            l = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        # first full window of a run: emit all ties of the tracked minimum
        if l == w + k - 1 and mn[0] != U64:
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos)):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            # new (or tying, newer) minimum displaces the tracked one
            if l >= w + k and mn[0] != U64:
                out.append(mn)
            mn = info
            min_pos = buf_pos
        elif buf_pos == min_pos:
            # the tracked minimum slid out of the window: emit + rescan
            if l >= w + k - 1 and mn[0] != U64:
                out.append(mn)
            mn = (U64, U64)
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                if mn[0] >= buf[j][0]:
                    mn = buf[j]
                    min_pos = j
            if l >= w + k - 1 and mn[0] != U64:
                for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if mn[0] != U64:
        out.append(mn)
    return out


def kmer_info(codes: np.ndarray, w: int, k: int, rid: int, is_hpc: bool):
    """Per-position arrays for the vectorized sketch.

    Returns (key_span, rid_pos_strand, l_eff) where position i describes the
    k-mer ending at i; invalid positions carry key_span == U64. l_eff[i] is
    the reference's `l` counter (valid non-symmetric updates since the last
    N reset, sketch.rs:69,77)."""
    n = codes.shape[0]
    mask = np.uint64((1 << (2 * k)) - 1)
    is_base = codes < 4
    idx = np.arange(n, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(~is_base, idx, np.int64(-1)))

    # Odd k only: symmetric registers are impossible (a self-reverse-
    # complement word needs a middle base equal to its own complement),
    # and register values at valid positions (l >= k, fully in-run) are
    # identical whether Ns are substituted with A or skipped, so the
    # cheap N-as-A substitution is exact. Even k (where the reference's
    # stale-register semantics across N resets become parity-relevant,
    # sketch.rs:65-78) is handled by the exact scan — the only caller
    # (sketch_sequence_fast) delegates before reaching here, and the
    # device even-k path lives in ops/sketch_scan.py.
    assert k % 2 == 1, "kmer_info characterizes odd k only"
    c = np.where(is_base, codes, 0).astype(np.uint64)

    # Rolling k-mers via log-step span doubling:
    #   fwd_s[i] = last s bases ending at i (newest base in the low bits)
    #   rev_s[i] = their reverse complement (newest base in the high bits)
    # Combination rules:
    #   fwd_{s+t}[i] = (fwd_s[i-t] << 2t) | (fwd_s[i] & (4^t - 1))
    #   rev_{s+t}[i] = ((rev_s[i] >> 2(s-t)) << 2s) | rev_s[i-t]
    fwd_c = c.copy()
    rev_c = (np.uint64(3) ^ c)
    s = 1
    with np.errstate(over="ignore"):
        while s < k:
            t = min(s, k - s)
            tmask = np.uint64((1 << (2 * t)) - 1)
            fwd_prev = np.zeros_like(fwd_c)
            rev_prev = np.zeros_like(rev_c)
            fwd_prev[t:] = fwd_c[:-t]
            rev_prev[t:] = rev_c[:-t]
            fwd_c = (fwd_prev << np.uint64(2 * t)) | (fwd_c & tmask)
            rev_c = ((rev_c >> np.uint64(2 * (s - t))) << np.uint64(2 * s)) | rev_prev
            s += t
    fwd = fwd_c & mask
    rev = rev_c & mask

    sym = fwd == rev
    z = (fwd > rev).astype(np.uint64)
    canon = np.where(fwd > rev, rev, fwd)

    # l_eff: count of non-symmetric valid-base positions since the reset.
    inc = (is_base & ~sym).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(inc)])
    l_eff = np.where(is_base, cs[idx + 1] - cs[last_bad + 1], 0)

    if is_hpc:
        # skip_len[i]: for a homopolymer run [a, b), skip_len[a] = b - a and
        # skip_len[t] = b - t for t in (a, b) (sketch.rs:52-58); single
        # bases get 1. That is simply run_end - i.
        new_run = np.ones(n, dtype=bool)
        new_run[1:] = ~((codes[1:] == codes[:-1]) & is_base[1:] & is_base[:-1])
        starts = np.nonzero(new_run)[0]
        run_of = np.cumsum(new_run) - 1
        run_end = np.append(starts[1:], n)[run_of]
        skip_len = np.where(is_base, run_end - idx, 0)
        # kmer_span[i] = sum of skip_len over the last k valid-base
        # positions since the reset (the TinyQueue, sketch.rs:59-61).
        css = np.concatenate([[0], np.cumsum(skip_len)])
        lo = np.maximum(idx + 1 - k, last_bad + 1)
        kspan = css[idx + 1] - css[lo]
    else:
        # span = min(l + 1, k) evaluated before the l increment
        # (sketch.rs:63); always k for valid records.
        kspan = np.minimum(idx - last_bad, k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)

    key = hash64_np(canon, int(mask))
    key_span = np.where(valid, (key << np.uint64(8)) | kspan.astype(np.uint64), _U64)
    rps = (np.uint64(rid) << np.uint64(32)) | (idx.astype(np.uint64) << np.uint64(1)) | z
    rps = np.where(valid, rps, _U64)
    return key_span, rps, l_eff


def window_min(ks: np.ndarray, w: int) -> np.ndarray:
    """wmin[e] = min(ks[max(0, e-w+1) : e+1]) via log-step folding."""
    wmin = ks.copy()
    span = 1
    while span < w:
        step = min(span, w - span)
        shifted = np.full_like(wmin, _U64)
        shifted[step:] = wmin[:-step]
        wmin = np.minimum(wmin, shifted)
        span += step
    return wmin


def sketch_sequence_fast(
    seq: bytes | np.ndarray,
    w: int,
    k: int,
    rid: int = 0,
    is_hpc: bool = False,
) -> np.ndarray:
    """Vectorized minimizer extraction (see module docstring for the
    characterization). Returns an (m, 2) uint64 array of
    (key_span, rid_pos_strand) sorted by position."""
    codes = nt4_encode(seq)
    n = codes.shape[0]
    if n == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    assert 0 < w < 256 and 0 < k <= 28

    if k % 2 == 0:
        # Even k admits strand-symmetric k-mers, which pause the scan's l
        # counter (sketch.rs:67-69): window-completion steps are then no
        # longer unique per run, and the completion/tie rules below no
        # longer characterize the scan exactly. Delegate to the exact scan
        # and normalize to the fast path's contract (position-sorted set).
        recs = sketch_sequence(seq, w, k, rid=rid, is_hpc=is_hpc)
        if not recs:
            return np.zeros((0, 2), dtype=np.uint64)
        arr = np.unique(np.asarray(recs, dtype=np.uint64), axis=0)
        pos = (arr[:, 1] >> np.uint64(1)) & np.uint64(0x7FFFFFFF)
        return arr[np.argsort(pos, kind="stable")]

    ks, rps, l_eff = kmer_info(codes, w, k, rid, is_hpc)
    wmin = window_min(ks, w)
    complete = l_eff >= (w + k - 1)
    hit = complete & (wmin != _U64)

    # emitted[j] = exists e in [j, j+w-1]: hit[e] and ks[j] == wmin[e]
    emitted = np.zeros(n, dtype=bool)
    for d in range(min(w, n)):
        if d == 0:
            emitted |= hit & (ks == wmin)
        else:
            emitted[: n - d] |= hit[d:] & (ks[:-d] == wmin[d:])

    # Completion-step rules. At the unique step e of each run where
    # l == w+k-1 (the first full window), with m1 the minimum over the
    # previous buffer [e-w+1, e-1] and M its newest tied occurrence (the
    # tracked minimum):
    #  * the completion tie-loop (sketch.rs:81-82) emits every tie of m1 in
    #    [e-w+1, e-1] except M itself (the loop skips the slot just written,
    #    so position e is never emitted here) — even when m1 is not the
    #    minimum of any complete window;
    #  * if ks[e] <= m1 the arriving record then displaces M with the
    #    l >= w+k emission gate (sketch.rs:85) still false, so M is
    #    silently lost.
    for e in np.nonzero(l_eff == (w + k - 1))[0]:
        lo = max(0, e - w + 1)
        if e > lo:
            m1 = ks[lo:e].min()
            if m1 != _U64:
                prev = lo + np.nonzero(ks[lo:e] == m1)[0]
                emitted[prev[:-1]] = True
                emitted[prev[-1]] = ks[e] > m1

    # run-end drops: the tracked minimum at each N reset is silently lost
    # (the l >= w+k-1 gates are false throughout the dead zone).
    is_base = codes < 4
    run_end_mask = np.zeros(n, dtype=bool)
    run_end_mask[:-1] = is_base[:-1] & ~is_base[1:]
    for e in np.nonzero(run_end_mask)[0]:
        if wmin[e] == _U64:
            continue
        lo = max(0, e - w + 1)
        cand = lo + np.nonzero(ks[lo : e + 1] == wmin[e])[0]
        if cand.size:
            emitted[cand[-1]] = False  # newest tied occurrence is tracked

    # final emission (sketch.rs:99): newest tied occurrence of the minimum
    # over the last w positions.
    if wmin[n - 1] != _U64:
        lo = max(0, n - w)
        cand = lo + np.nonzero(ks[lo:] == wmin[n - 1])[0]
        emitted[cand[-1]] = True

    out_idx = np.nonzero(emitted)[0]
    return np.stack([ks[out_idx], rps[out_idx]], axis=1)
