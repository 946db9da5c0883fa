"""Exact reference-order sketch: the even-k path.

Counterpart of minimap2_rs_tpu/ops/sketch_scan.py. Even k admits
strand-symmetric k-mers, which pause the reference scan's `l` counter
(sketch.rs:67-69); the window-min characterization of ops/sketch.py
relies on window-completion steps being unique per run, which the pause
breaks. So this path runs the scan's window recurrence itself:

- everything per position is computed vectorially first
  (`_kmer_info_even`): registers, the l counter, spans, hashes. The
  registers are never cleared at an N (sketch.rs:76-78), so the k-mer
  at a warm-up position mixes pre- and post-reset bases, and the
  strand-symmetry test on that stale content gates the l counter. That
  is reproduced by rolling the k-mers over the N-compacted sequence
  (a cumsum + scatter) and gathering them back.
- the sequential part is the reference's w-slot ring buffer and tracked
  minimum (sketch.rs:80-96). On the card it is the window-scan kernel
  (kernels/window_scan.py, csrc/window_scan.cu); `_window_scan_ref`
  below is its plain version, a loop over positions vectorised over the
  batch, which sets `emitted` at the emitted positions directly.

At k = 28 the word key << 8 | span reaches 2^64; it stays the uint64's
bit pattern in int64, and the scan compares the words unsigned (the
sign-flipped int64 here, `unsigned long long` in the kernel). The output
contract is ops/sketch.sketch_positions'.
"""

from __future__ import annotations

import torch

from .sketch import INV32, KS_INVALID, _SIGN, _hash64, hpc_kspan, kmer_keys


def _kmer_info_even(codes: torch.Tensor, lengths: torch.Tensor, k: int, is_hpc: bool):
    """Per-position (key_span, pos_strand, l_eff), each (B, L) int64,
    with the reference's even-k register semantics (JAX
    sketch_scan.py:46-106): k-mers rolled over the N-compacted bases,
    symmetric k-mers pause l."""
    B, L = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    idx = torch.arange(L, device=dev).expand(B, L)
    is_base = (codes < 4) & (idx < lengths.to(torch.int64)[:, None])

    # registers over the N-compacted base stream, gathered back; column L
    # takes the non-bases and is cut off
    rank = is_base.to(torch.int64).cumsum(dim=1) - 1
    comp = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    comp.scatter_(1, torch.where(is_base, rank, L), torch.where(is_base, codes, 0))
    canon_c, strand_c, sym_c = kmer_keys(comp[:, :L], k)
    g = rank.clamp(min=0)
    canon = canon_c.gather(1, g)
    strand = strand_c.gather(1, g)
    sym = sym_c.gather(1, g) & is_base

    last_bad = torch.where(~is_base, idx, -1).cummax(dim=1).values
    cs = (is_base & ~sym).to(torch.int64).cumsum(dim=1)
    cs_at_bad = torch.where(~is_base, cs, -1).cummax(dim=1).values.clamp(min=0)
    l_eff = torch.where(is_base, cs - cs_at_bad, 0)
    kspan = hpc_kspan(codes, is_base, idx, k) if is_hpc else (idx - last_bad).clamp(max=k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)
    key = _hash64(canon, (1 << (2 * k)) - 1)
    # at k = 28 the shift wraps into the sign bit: the uint64 bit pattern
    ks = torch.where(valid, (key << 8) | kspan, KS_INVALID)
    ps = torch.where(valid, (idx << 1) | strand.to(torch.int64), INV32)
    return ks, ps, l_eff


def _window_scan_ref(ks: torch.Tensor, ps: torch.Tensor, l_eff: torch.Tensor,
                     lengths: torch.Tensor, w: int, k: int,
                     emit_final: torch.Tensor) -> torch.Tensor:
    """The plain version of the window-scan kernel: the reference's
    window recurrence (sketch.rs:80-99; JAX sketch_scan.py:122-241), one
    Python step per position over the (B, w) ring. Returns the (B, L)
    bool mask of emitted positions (the final flush included)."""
    B, L = ps.shape
    dev = ps.device
    umax = KS_INVALID  # the ordered words' invalid sentinel (sorts last)
    o = torch.where(ps != INV32, ks ^ _SIGN, umax)
    buf = torch.full((B, w), umax, dtype=torch.int64, device=dev)
    buf_y = torch.full((B, w), INV32, dtype=torch.int64, device=dev)
    mn = torch.full((B,), umax, dtype=torch.int64, device=dev)
    mn_y = torch.full((B,), INV32, dtype=torch.int64, device=dev)
    min_pos = torch.zeros(B, dtype=torch.int64, device=dev)
    # column L takes the writes of rows that emit nothing
    emitted = torch.zeros((B, L + 1), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    slots = torch.arange(w, device=dev)
    lengths = lengths.to(torch.int64)
    fin_ok = torch.zeros(B, dtype=torch.bool, device=dev)
    fin_pos = torch.zeros(B, dtype=torch.int64, device=dev)
    wk = w + k - 1
    for i in range(int(lengths.max()) if B else 0):
        bp = i % w
        x, y, l = o[:, i], ps[:, i], l_eff[:, i].to(torch.int64)
        buf[:, bp] = x
        buf_y[:, bp] = y
        age = (bp - slots) % w
        pos = i - age  # absolute position each slot holds (< 0: never written)
        mn_valid = mn != umax

        # first-full-window ties (sketch.rs:81-82): every tie of the
        # tracked min in the previous buffer
        tie = (buf == mn[:, None]) & (buf_y != mn_y[:, None]) & (slots != bp)
        emit = ((l == wk) & mn_valid)[:, None] & tie

        le = x <= mn
        slide = ~le & (min_pos == bp)
        emit_mn = mn_valid & ((le & (l >= wk + 1)) | (slide & (l >= wk)))
        col = torch.where(emit_mn, mn_y >> 1, L)
        emitted[rows, col] |= emit_mn

        # rescan (sketch.rs:88-96): min over the slots, ties to the newest
        bmin = buf.min(dim=1).values
        at_min = buf == bmin[:, None]
        bslot = torch.where(at_min, pos, -1 - w).argmax(dim=1)
        by = buf_y[rows, bslot]
        tie2 = at_min & (buf_y != by[:, None])
        emit |= (slide & (l >= wk) & (bmin != umax))[:, None] & tie2
        nl = min(i + 1, w)  # slots 0..i hold positions >= 0 while i < w
        emitted[:, pos[:nl]] |= emit[:, :nl]

        mn = torch.where(le, x, torch.where(slide, bmin, mn))
        mn_y = torch.where(le, y, torch.where(slide, by, mn_y))
        min_pos = torch.where(le, bp, torch.where(slide, bslot, min_pos))
        at_end = lengths - 1 == i
        fin_ok = torch.where(at_end, mn != umax, fin_ok)
        fin_pos = torch.where(at_end, mn_y >> 1, fin_pos)

    # the final flush at each read's true end (sketch.rs:99)
    fin_ok = fin_ok & (lengths > 0) & emit_final
    emitted[rows, torch.where(fin_ok, fin_pos, L)] |= fin_ok
    return emitted[:, :L].contiguous()


def sketch_positions_exact(codes: torch.Tensor, lengths: torch.Tensor, w: int, k: int,
                           is_hpc: bool = False, emit_final: torch.Tensor | None = None):
    """sketch_positions' contract through the exact scan recurrence;
    valid for any k (the production path for even k)."""
    from ..kernels.window_scan import window_scan

    B = codes.shape[0]
    ks, ps, l_eff = _kmer_info_even(codes, lengths, k, is_hpc)
    if emit_final is None:
        emit_final = torch.ones(B, dtype=torch.bool, device=codes.device)
    emitted = window_scan(
        ks, ps, l_eff.to(torch.int32), lengths.to(torch.int32).contiguous(),
        w, k, emit_final.contiguous(),
    )
    # padding slots must stay inert downstream
    return ks, ps, emitted & (ps != INV32)
