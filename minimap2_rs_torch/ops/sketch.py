"""Batched minimizer sketch in PyTorch (odd k <= 27, non-HPC).

Counterpart of minimap2_rs_tpu/ops/sketch.py (its u32 fast path for
k <= 15 and its u64 path for larger k): the reference's per-base scan
(sketch.rs:29-100) as masked elementwise work on (B, L) tensors —
k-mers by log-step span doubling, hash64, window-minimum folds, and the
three exactness rules (completion-step ties, run-end drops, final
emission) of sketch.py:290-351.

Every word lives in an int64 tensor. Canonical keys are < 2^54 and the
comparison word key << 8 | span is < 2^62, so signed int64 orders them
as the JAX package's uint64 pairs and needs no sign flip; hash64 drops
the bits a left shift would push past the key mask before shifting, so
no intermediate leaves int64. Keys leave as one `key << 8 | span` word
(KS_INVALID for invalid slots, which sorts last). Even k (the exact scan
of sketch_scan.py) and HPC queries raise NotImplementedError.
"""

from __future__ import annotations

import torch

INV32 = 0xFFFFFFFF   # invalid position sentinel (uint32 max)
KS_INVALID = (1 << 63) - 1  # invalid key_span sentinel (int64 max)
MAX_K = 27  # 2k + 8 <= 62: key << 8 | span stays a non-negative int64


def _shift_right(a: torch.Tensor, t: int, fill) -> torch.Tensor:
    """a shifted toward higher indices by t along the last axis."""
    if t == 0:
        return a
    L = a.shape[-1]
    out = torch.full_like(a, fill)
    if t < L:
        out[..., t:] = a[..., : L - t]
    return out


def _shift_left(a: torch.Tensor, t: int, fill) -> torch.Tensor:
    if t == 0:
        return a
    L = a.shape[-1]
    out = torch.full_like(a, fill)
    if t < L:
        out[..., : L - t] = a[..., t:]
    return out


def _hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """hash64 (sketch.rs:4-13) for mask < 2^62 on non-negative int64
    words: each left shift first drops the bits it would push past the
    mask, and every sum is masked, so int64 arithmetic gives the
    reference's low bits without overflow."""

    def shl(x, s):
        return (x & (mask >> s)) << s

    key = ((~key & mask) + shl(key, 21)) & mask
    key = key ^ (key >> 24)
    key = (key + shl(key, 3) + shl(key, 8)) & mask
    key = key ^ (key >> 14)
    key = (key + shl(key, 2) + shl(key, 4)) & mask
    key = key ^ (key >> 28)
    key = (key + shl(key, 31)) & mask
    return key


def kmer_keys(codes: torch.Tensor, k: int):
    """Canonical k-mer per position for 2k <= 62, by span doubling:
      fwd_{s+t}[i] = (fwd_s[i-t] << 2t) | (fwd_s[i] & (4^t-1))
      rev_{s+t}[i] = ((rev_s[i] >> 2(s-t)) << 2s) | rev_s[i-t]
    Returns (canon int64, strand bool, sym bool)."""
    c = torch.where(codes < 4, codes, 0).to(torch.int64)
    fwd = c
    rev = 3 ^ c
    s = 1
    while s < k:
        t = min(s, k - s)
        fwd_prev = _shift_right(fwd, t, 0)
        rev_prev = _shift_right(rev, t, 0)
        fwd = (fwd_prev << (2 * t)) | (fwd & ((1 << (2 * t)) - 1))
        rev = ((rev >> (2 * (s - t))) << (2 * s)) | rev_prev
        s += t
    mask = (1 << (2 * k)) - 1
    fwd = fwd & mask
    rev = rev & mask
    sym = fwd == rev
    strand = rev < fwd
    return torch.where(strand, rev, fwd), strand, sym


def window_fold_min(kv: torch.Tensor, idx: torch.Tensor, w: int):
    """(min key, newest tied index) over the w-window ending at each
    position, by log-step folding (ties keep the newer window); invalid
    slots hold KS_INVALID."""
    wmin, widx = kv, idx
    span = 1
    while span < w:
        step = min(span, w - span)
        sh = _shift_right(wmin, step, KS_INVALID)
        sh_idx = _shift_right(widx, step, -1)
        better = sh < wmin
        wmin = torch.where(better, sh, wmin)
        widx = torch.where(better, sh_idx, widx)
        span += step
    return wmin, widx


def sketch_positions(codes: torch.Tensor, lengths: torch.Tensor, w: int, k: int,
                     is_hpc: bool = False):
    """Per-position minimizer emission for (B, L) nt4 codes (padded with
    4) and (B,) true lengths.

    Returns (key_span (B, L) int64 = key<<8|k or KS_INVALID,
    pos_strand (B, L) int64 = pos<<1|strand or INV32, emitted (B, L)
    bool)."""
    if is_hpc or k % 2 == 0 or not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"sketch_positions is ported for odd k <= {MAX_K} without HPC only"
        )
    B, L = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    idx = torch.arange(L, device=dev).expand(B, L)
    lengths = lengths.to(torch.int64)
    is_base = (codes < 4) & (idx < lengths[:, None])

    last_bad = torch.where(~is_base, idx, -1).cummax(dim=1).values
    depth = idx - last_bad  # bases since reset

    canon, strand, sym = kmer_keys(torch.where(is_base, codes, 4), k)
    # l_eff: non-symmetric valid bases since the last reset
    cs = (is_base & ~sym).to(torch.int64).cumsum(dim=1)
    cs_at_bad = torch.where(~is_base, cs, -1).cummax(dim=1).values.clamp(min=0)
    l_eff = torch.where(is_base, cs - cs_at_bad, 0)
    kspan = depth.clamp(max=k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)
    # every valid kspan is k (non-HPC), so the window comparisons on
    # key << 8 | span order the slots as the bare keys
    key = _hash64(canon, (1 << (2 * k)) - 1)
    ksc = torch.where(valid, (key << 8) | kspan, KS_INVALID)
    pos_strand = torch.where(valid, (idx << 1) | strand.to(torch.int64), INV32)

    wmin, widx = window_fold_min(ksc, idx, w)
    if w > 1:
        wmin1, widx1 = window_fold_min(ksc, idx, w - 1)
    valid_w = wmin != KS_INVALID

    hit = (l_eff >= (w + k - 1)) & valid_w

    # base rule: emitted[j] iff a complete window [e-w+1, e] covering j
    # has wmin[e] == ks[j]
    emitted = hit & (ksc == wmin)
    for d in range(1, min(w, L)):
        emitted[:, : L - d] |= hit[:, d:] & (ksc[:, : L - d] == wmin[:, d:])

    if w > 1:
        # completion-step rules: at e with l_eff == w+k-1, m1 = min over
        # [e-w+1, e-1], M its newest tie: ties of m1 except M are
        # emitted; emitted[M] = ks[e] > m1
        compl_e = l_eff == (w + k - 1)
        m1 = _shift_right(wmin1, 1, KS_INVALID)
        M = _shift_right(widx1, 1, -1)
        m1_valid = compl_e & (m1 != KS_INVALID)
        for d in range(1, min(w, L)):
            emitted[:, : L - d] |= (
                m1_valid[:, d:]
                & (ksc[:, : L - d] == m1[:, d:])
                & (idx[:, : L - d] != M[:, d:])
            )
        m_val = ksc > m1
        set_mask = torch.zeros_like(emitted)
        set_val = torch.zeros_like(emitted)
        for d in range(1, min(w, L)):  # M[e] = e - d
            src = m1_valid[:, d:] & (M[:, d:] == idx[:, : L - d])
            set_mask[:, : L - d] |= src
            set_val[:, : L - d] |= src & m_val[:, d:]
        emitted = torch.where(set_mask, set_val, emitted)

    # run-end drops: the newest tie of the window min at each N reset is
    # lost (widx[e] is within w-1 of e)
    next_base = _shift_left(is_base, 1, False)
    run_end = is_base & ~next_base & (idx != lengths[:, None] - 1)
    drop_src = run_end & valid_w
    drop_mask = drop_src & (widx == idx)
    for d in range(1, min(w, L)):
        drop_mask[:, : L - d] |= drop_src[:, d:] & (widx[:, d:] == idx[:, : L - d])
    emitted = emitted & ~drop_mask

    # final emission at each read's true end (sketch.rs:99)
    last = (lengths - 1).clamp(min=0)[:, None]
    fin_valid = valid_w.gather(1, last)[:, 0] & (lengths > 0)
    fin_idx = torch.where(fin_valid, widx.gather(1, last)[:, 0], 0)
    rows = torch.arange(B, device=dev)
    emitted[rows, fin_idx] |= fin_valid

    return ksc, pos_strand, emitted


def compact_minimizers(ks: torch.Tensor, pos_strand: torch.Tensor,
                       emitted: torch.Tensor, max_out: int):
    """Pack emitted minimizers to the front (stable, so position-sorted),
    padded to max_out slots. Returns (ks, pos_strand, n_valid, overflow)
    with padding KS_INVALID / INV32."""
    B, L = emitted.shape
    dev = emitted.device
    dest = emitted.to(torch.int64).cumsum(dim=1) - 1
    # entries past the capacity (and non-emitted ones) land in a discard
    # column max_out, cut off below
    dest = torch.where(emitted & (dest < max_out), dest, max_out)
    out_ks = torch.full((B, max_out + 1), KS_INVALID, dtype=torch.int64, device=dev)
    out_ps = torch.full((B, max_out + 1), INV32, dtype=torch.int64, device=dev)
    out_ks.scatter_(1, dest, ks)
    out_ps.scatter_(1, dest, pos_strand)
    n = emitted.sum(dim=1)
    return (
        out_ks[:, :max_out].contiguous(), out_ps[:, :max_out].contiguous(),
        n.clamp(max=max_out).to(torch.int32), n > max_out,
    )
