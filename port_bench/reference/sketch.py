"""Minimizers, written from minimap2_rs's sketch.rs (sketch.rs:4-100).

Two forms of one definition:

* `query_minimizers`: the sequential scan, record for record and in the
  order the scan emits them (the dv estimate reads that order,
  paf.rs:156-199). A read is a few kb, so a Python loop over its
  positions is cheap; the k-mers and their hashes are worked out as
  whole arrays first.
* `genome_minimizers`: the set the scan emits over a whole reference
  sequence, as torch on any device, a chunk at a time, for references of
  billions of bases. A position j is kept when its record is the minimum
  of some complete window that holds it, with the scan's two rules at a
  sequence's ends: the first complete window emits every older tie of
  its minimum and drops the newest when the arriving record ties or
  beats it; the last w positions always emit the newest tie of their
  minimum. The index of minimap2_rs holds that set (duplicates and the
  scan's order do not reach it).

Both take odd k from 1 to 27 and bases A, C, G, T only: the benchmark's
genomes and reads hold no other letter, and with odd k no k-mer is its
own reverse complement, so the scan's counter `l` is the count of bases
since the sequence's start.
"""

from __future__ import annotations

import numpy as np
import torch

U64 = (1 << 64) - 1
_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c + 32] = _i


def nt4(seq: bytes) -> np.ndarray:
    """ASCII bases -> uint8 codes A=0 C=1 G=2 T=3; refuses any other letter."""
    codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
    if codes.size and int(codes.max()) > 3:
        raise ValueError("the reference takes A, C, G and T only")
    return codes


def _check_k(w: int, k: int) -> None:
    if not (0 < w < 256 and 0 < k <= 27 and k % 2 == 1):
        raise ValueError(f"the reference takes odd k <= 27 and 0 < w < 256 (w={w}, k={k})")


def _hash(x: torch.Tensor, mask: int) -> torch.Tensor:
    """hash64 (sketch.rs:4-13) of int64 keys under `mask`. Every right
    shift acts on a masked, non-negative value, so int64 gives the bits
    that uint64 gives."""
    x = (~x + (x << 21)) & mask
    x = x ^ (x >> 24)
    x = (x + (x << 3) + (x << 8)) & mask
    x = x ^ (x >> 14)
    x = (x + (x << 2) + (x << 4)) & mask
    x = x ^ (x >> 28)
    return (x + (x << 31)) & mask


def _records(codes: torch.Tensor, k: int):
    """(hash of the canonical k-mer, strand) at each position of int64
    base codes, the k-mer ending there; positions < k - 1 hold partial
    k-mers, which the callers mark invalid."""
    fwd = torch.zeros_like(codes)
    rev = torch.zeros_like(codes)
    for d in range(min(k, codes.shape[0])):  # the base d positions back
        c = torch.zeros_like(codes)
        c[d:] = codes[: codes.shape[0] - d]
        fwd |= c << (2 * d)
        rev |= (3 - c) << (2 * (k - 1 - d))
    strand = (fwd > rev).to(torch.int64)
    return _hash(torch.minimum(fwd, rev), (1 << (2 * k)) - 1), strand


def query_minimizers(seq: bytes, w: int, k: int) -> list[tuple[int, int]]:
    """The scan's records of a read (rid 0), in emission order:
    (hash << 8 | span, pos << 1 | strand)."""
    _check_k(w, k)
    codes = torch.from_numpy(nt4(seq).astype(np.int64))
    n = codes.shape[0]
    if n == 0:
        return []
    key, strand = _records(codes, k)
    ks = ((key << 8) | k).tolist()
    rps = ((torch.arange(n, dtype=torch.int64) << 1) | strand).tolist()
    none = (U64, U64)
    buf = [none] * w
    order_tie = [list(range(b + 1, w)) + list(range(b)) for b in range(w)]
    order_scan = [list(range(b + 1, w)) + list(range(b + 1)) for b in range(w)]
    mn = none
    min_pos = 0
    buf_pos = 0
    out: list[tuple[int, int]] = []
    for i in range(n):
        l = i + 1  # bases since the start: odd k, A/C/G/T only
        info = (ks[i], rps[i]) if l >= k else none
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != U64:
            for j in order_tie[buf_pos]:
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != U64:
                out.append(mn)
            mn = info
            min_pos = buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != U64:
                out.append(mn)
            mn = none
            for j in order_scan[buf_pos]:
                if mn[0] >= buf[j][0]:
                    mn = buf[j]
                    min_pos = j
            if l >= w + k - 1 and mn[0] != U64:
                for j in order_scan[buf_pos]:
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if mn[0] != U64:
        out.append(mn)
    return out


_BIG = (1 << 63) - 1  # an invalid record: above every hash << 8 | span for k <= 27


def genome_minimizers(codes: torch.Tensor, lo: int, n: int, keep: tuple[int, int],
                      w: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The minimizer set of one reference sequence of length n, at the
    positions keep = [a, b), from codes = the sequence's bases [lo, hi)
    as an int64 tensor, where lo <= max(a - w - k, 0) and hi >=
    min(b + w, n). Returns (hash, pos << 1 | strand) int64 tensors, in
    position order."""
    _check_k(w, k)
    hi = lo + codes.shape[0]
    a, b = keep
    if not (lo <= max(a - w - k, 0) and hi >= min(b + w, n) and hi <= n):
        raise ValueError("the chunk lacks the halo its kept positions need")
    dev = codes.device
    gpos = torch.arange(lo, hi, device=dev, dtype=torch.int64)
    key, z = _records(codes, k)
    # a record needs k bases in this chunk and from the sequence's start
    valid = (gpos >= k - 1) & (gpos - lo >= k - 1)
    ks = torch.where(valid, (key << 8) | k, _BIG)
    # wmin[e]: the minimum of the window of w records ending at e (in
    # this chunk; the kept positions' windows lie wholly inside it)
    wmin = ks.clone()
    for d in range(1, w):
        wmin[d:] = torch.minimum(wmin[d:], ks[:-d])
    # a complete window ends where l >= w + k - 1 (sketch.rs:80)
    hit = (gpos >= w + k - 2) & (wmin != _BIG)
    m = ks.shape[0]
    emitted = hit & (ks == wmin)
    for d in range(1, min(w, m)):
        emitted[: m - d] |= hit[d:] & (ks[: m - d] == wmin[d:])
    e0 = w + k - 2  # the first complete window's end
    if lo == 0 and w > 1 and e0 < hi:  # else no kept position is near it
        seg = ks[e0 - w + 1 - lo : e0 - lo]
        m1 = int(seg.min())
        if m1 != _BIG:
            ties = torch.nonzero(seg == m1).flatten() + (e0 - w + 1 - lo)
            emitted[ties[:-1]] = True
            emitted[ties[-1]] = bool(ks[e0 - lo] > m1)
    if hi == n and m:
        last = int(wmin[m - 1])
        if last != _BIG:
            tail = max(0, m - w)
            cand = torch.nonzero(ks[tail:] == last).flatten() + tail
            emitted[cand[-1]] = True
    sel = emitted & (gpos >= a) & (gpos < b)
    idx = torch.nonzero(sel).flatten()
    return key[idx], (gpos[idx] << 1) | z[idx]
