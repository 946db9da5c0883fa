"""Batched minimizer sketch in PyTorch.

Counterpart of minimap2_rs_tpu/ops/sketch.py (its u32 fast path for
k <= 15 and its u64 path for larger k): the reference's per-base scan
(sketch.rs:29-100) as masked elementwise work on (B, L) tensors —
k-mers by log-step span doubling, hash64, window-minimum folds, and the
three exactness rules (completion-step ties, run-end drops, final
emission) of sketch.py:290-351. HPC spans (sketch.py:222-237) change
only the span byte: the reference does not skip homopolymers. Even k
goes to the exact scan of ops/sketch_scan.py, as in the JAX package.

Every word lives in an int64 tensor. For odd k <= 27 canonical keys are
< 2^54 and the comparison word key << 8 | span is < 2^62, so signed
int64 orders them as the JAX package's uint64 pairs; hash64 drops the
bits a left shift would push past the key mask before shifting, so no
intermediate leaves int64. Keys leave as one `key << 8 | span` word
(KS_INVALID for invalid slots). At even k = 28 that word reaches 2^64:
it is kept as the uint64's bit pattern (negative as int64), and every
comparison of such words goes through `ordered_ks`.

The map programs' H2D wire (unpack_codes2, unpack_codes4: JAX
models/stages.py:32-58) is unpacked here too, ahead of the sketch; at odd
k the mapper's query sketch runs as one kernel from the wire on the card
(kernels/sketch.py), with this module's functions as its plain version.
"""

from __future__ import annotations

import torch

INV32 = 0xFFFFFFFF   # invalid position sentinel (uint32 max)
KS_INVALID = (1 << 63) - 1  # invalid key_span sentinel (int64 max)
MAX_K = 28  # sketch.rs:32
KEY_MASK = (1 << 56) - 1  # the hashed key of ks >> 8, for every k <= 28
_SIGN = -(1 << 63)


def ordered_ks(ks: torch.Tensor) -> torch.Tensor:
    """key_span words (uint64 bit patterns in int64, KS_INVALID for
    invalid slots) -> int64 whose signed order is the JAX package's
    uint64 order with invalid slots last (its all-ones sentinel). Flips
    the sign bit, a monotone map, so it changes no order for k <= 27."""
    return torch.where(ks == KS_INVALID, KS_INVALID, ks ^ _SIGN)


def ks_keys(ks: torch.Tensor) -> torch.Tensor:
    """The hashed keys (ks >> 8 as a uint64) of key_span words."""
    return (ks >> 8) & KEY_MASK


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


def hpc_kspan(codes: torch.Tensor, is_base: torch.Tensor, idx: torch.Tensor,
              k: int) -> torch.Tensor:
    """HPC k-mer spans (JAX sketch.py:222-237): the bases covered by the
    last k homopolymer runs' heads, css[i] - css[max(i-k, last N)] over
    the running sum css of each base's distance to its run's end."""
    nxt = _shift_left(codes, 1, 4)
    boundary = (codes != nxt) | ~is_base
    bpos = torch.where(boundary, idx, 1 << 30)
    next_boundary = bpos.flip(1).cummin(dim=1).values.flip(1)
    skip_len = torch.where(is_base, next_boundary - idx + 1, 0)
    css = skip_len.cumsum(dim=1)
    cand_k = _shift_right(css, k, -1)  # css[idx-k], -1 when out of range
    cand_bad = torch.where(~is_base, css, -1).cummax(dim=1).values
    css_lo = torch.maximum(cand_k, cand_bad).clamp(min=0)
    return css - css_lo


def sketch_positions(codes: torch.Tensor, lengths: torch.Tensor, w: int, k: int,
                     is_hpc: bool = False, emit_final: torch.Tensor | None = None):
    """Per-position minimizer emission for (B, L) nt4 codes (padded with
    4) and (B,) true lengths.

    Returns (key_span (B, L) int64 = key<<8|span or KS_INVALID,
    pos_strand (B, L) int64 = pos<<1|strand or INV32, emitted (B, L)
    bool). emit_final (B,) bool, default all true, suppresses the
    sequence-end flush (sketch.rs:99) on rows that are interior chunks
    of a longer sequence (ops/index_build.py)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if k % 2 == 0:
        # symmetric k-mers pause the reference's l counter, which the
        # window-min characterization below does not model
        from .sketch_scan import sketch_positions_exact

        return sketch_positions_exact(codes, lengths, w, k, is_hpc, emit_final)
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
    kspan = hpc_kspan(codes, is_base, idx, k) if is_hpc else depth.clamp(max=k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)
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
    if emit_final is not None:
        fin_valid = fin_valid & emit_final
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


def unpack_codes4(codes4: torch.Tensor) -> torch.Tensor:
    """(B, L//2) uint8 two-nibble packed nt4 codes -> (B, L) int32."""
    B, L2 = codes4.shape
    c = codes4.to(torch.int32)
    return torch.stack([c & 0xF, c >> 4], dim=-1).reshape(B, 2 * L2)


def unpack_codes2(codes2: torch.Tensor, lengths: torch.Tensor,
                  nex: torch.Tensor) -> torch.Tensor:
    """2-bit H2D wire -> (B, L) int32 nt4 codes, equal to the 4-bit
    wire's: (B, L//4) uint8 rows of 4 codes/byte; positions past each
    read's length become the nt4=4 sentinel; the flat N-exception list
    `nex` (padded with the out-of-range B*L) scatters 4 back."""
    B, L4 = codes2.shape
    L = 4 * L4
    c = codes2.to(torch.int32)
    codes = torch.stack([(c >> (2 * s)) & 3 for s in range(4)], dim=-1).reshape(B, L)
    pos = torch.arange(L, device=codes.device)
    codes = torch.where(pos[None, :] < lengths[:, None], codes, 4)
    # one spare slot takes the out-of-range padding entries
    flat = torch.cat([codes.reshape(-1), codes.new_zeros(1)])
    # a fill kernel: `flat[idx] = 4` would copy the 4 from host memory,
    # which a captured program cannot do
    flat.index_fill_(0, nex.to(torch.int64).clamp(0, B * L), 4)
    return flat[: B * L].reshape(B, L)


# positions an element of each wire's rows holds: the 2-bit and 4-bit H2D
# wires (uint8 rows), and plain (B, L) int32 nt4 codes
WIRE_CODES = {"2bit": 4, "4bit": 2, "nt4": 1}


def wire_codes(rows: torch.Tensor, lengths: torch.Tensor, nex: torch.Tensor | None,
               wire: str) -> torch.Tensor:
    """The batch as `wire` holds it (WIRE_CODES; `nex` the 2-bit wire's N
    list) -> (B, L) int32 nt4 codes."""
    if wire not in WIRE_CODES:
        raise ValueError(f"unknown wire {wire!r}")
    if rows.shape[-1] * WIRE_CODES[wire] > 1 << 22:
        raise ValueError("reads longer than 4M bases are unsupported")
    if wire == "4bit":
        return unpack_codes4(rows)
    if wire == "2bit":
        return unpack_codes2(rows, lengths, nex)
    return rows
