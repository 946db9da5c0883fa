"""Chaining DP scalars and the plain PyTorch versions of the chain DP.

Counterpart of minimap2_rs_tpu/ops/chain_ops.py. The exact-window
colinear chaining DP (lchain.rs:74-91): for each anchor i take the best
f[j] + comput_sc(i, j) over the admissible j in [max(0, i-H), i); ties
go to the largest j; when the best does not beat span[i], f[i] = span[i]
and i starts a chain. With max_chain_skip set, both DPs first apply the
reference's order-dependent early break (`_skip_prune_mask`,
lchain.rs:79-88), as the JAX DPs do under MM2T_SKIP_PRUNE.
`chain_dp_batch_ref` returns (f, prev) for the host backtrack of the
general path; the aux form `chain_dp_aux_batch_ref` carries (cnt, sq,
sr) = (chain length, chain-start qpos, chain-start rpos) along the
chosen predecessor instead, so the lite path never backtracks
(ops/finalize_ops.py). Both score the window with one helper.

They are the plain versions of the CUDA kernel's two variants, and of
their pruned instances, in kernels/chain_dp.py: the CPU path, and the reference the kernel is held
against on the card. Both read log2(dd+1) from the same host-built f32
table of the oracle's mg_log2, so they compute the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..oracle.lchain import mg_log2

NEG_INF = -(2**30)


@dataclasses.dataclass(frozen=True)
class ChainScalars:
    """Chaining parameters as the DP reads them (max_dist already max'd
    with bw, lchain.rs:63-66); the penalties are used as float32."""

    max_dist_x: int
    max_dist_y: int
    bw: int
    chn_pen_gap: float
    chn_pen_skip: float


def chain_scalars_from_params(p) -> ChainScalars:
    """ChainScalars from a config.ChainParams, applying the max_dist
    adjustment (lchain.rs:63-66)."""
    return ChainScalars(
        max_dist_x=max(p.max_dist_x, p.bw),
        max_dist_y=max(p.max_dist_y, p.bw),
        bw=p.bw,
        chn_pen_gap=float(np.float32(p.chn_pen_gap)),
        chn_pen_skip=float(np.float32(p.chn_pen_skip)),
    )


def log2_table(n: int) -> torch.Tensor:
    """(n,) float32 CPU table: entry dd is the oracle's mg_log2(dd + 1)
    (oracle/lchain.py:51-55, the f32 log2 of comput_sc's log penalty).
    Size it max(bw, bw_long) + 1: an admissible pair has dd <= bw."""
    return torch.from_numpy(
        np.array([mg_log2(dd + 1) for dd in range(n)], dtype=np.float32)
    )


def _dp_inputs(grp, rpos, qpos, span, scalars: ChainScalars, log2_tab):
    """The (B, A) inputs as int64, the log2 table and the two f32
    penalties on grp's device."""
    if log2_tab.shape[0] <= scalars.bw:
        raise ValueError("log2 table shorter than bw + 1")
    dev = grp.device
    pens = tuple(
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in (scalars.chn_pen_gap, scalars.chn_pen_skip)
    )
    cols = tuple(t.to(torch.int64) for t in (grp, rpos, qpos, span))
    return cols, log2_tab.to(dev), pens


def _window_scores(g, rp, qp, sp, f, i: int, H: int, scalars: ChainScalars,
                   tab: torch.Tensor, pens):
    """The masked window scores (comput_sc, lchain.rs:17-34, plus f[j])
    of anchor i against its H predecessor slots [off, off + H): returns
    (scores (B, H), NEG_INF where not admissible; ok (B, H); off).
    Inputs are (B, A) int64; f holds rows < i."""
    A = g.shape[1]
    off = min(max(i - H, 0), A - H)
    w = slice(off, off + H)
    jr = torch.arange(off, off + H, device=g.device)
    dq = qp[:, i : i + 1] - qp[:, w]
    dr = rp[:, i : i + 1] - rp[:, w]
    dd = (dr - dq).abs()
    dg = torch.minimum(dr, dq)
    p = scalars
    ok = (
        (jr < i)
        & (g[:, w] == g[:, i : i + 1])
        & (dq > 0) & (dq <= p.max_dist_x) & (dq <= p.max_dist_y)
        & (dr != 0) & (dr <= p.max_dist_x)
        & (dd <= p.bw)
    )
    span_w = sp[:, w]
    sc = torch.minimum(span_w, dg)
    # f32, one rounding per op as in oracle/lchain.py:78-80; the cast
    # truncates toward zero like `as i32`
    gap, skip = pens
    lin = gap * dd.to(torch.float32) + skip * dg.to(torch.float32)
    pen = (lin + 0.5 * tab[dd.clamp(0, tab.shape[0] - 1)]).to(torch.int64)
    sc = torch.where((dd != 0) | (dg > span_w), sc - pen, sc)
    return torch.where(ok, sc + f[:, w], NEG_INF), ok, off


def _best(scores: torch.Tensor, off: int):
    """(best score, its slot) per read, ties to the largest j
    (lchain.rs:80-84 scans j descending and needs strict improvement)."""
    H = scores.shape[1]
    best = scores.max(dim=1).values
    jb = off + (H - 1) - scores.flip(1).argmax(dim=1)
    return best, jb


def _skip_prune_scanned(scores, ok, prev_w, off: int, span_i, max_skip: int):
    """The reference's max_chain_skip early break (lchain.rs:79-88;
    JAX chain_ops.py:80-137) over one (B, H) window: the (B, H) mask, in
    window order, of the slots the walk scans, up to and including the
    break point.

    Walking j newest-first, a beat (sc > running max, seeded with
    span_i) decrements the skip counter (floored at 0), a non-beat with
    t[j] == i increments it, and the walk breaks past max_skip; t marks
    prev[j'] of every scanned in-band j'. prev[j'] < j', so a mark lands
    before the walk reaches it: one scatter of the window's prev values
    gives every mark. The counter maps compose as f(n) = max(n + a, b),
    so its value at each slot is max(A, B) with A the running sum of a
    and B = A + running max of (b - A); the walk scans up to and
    including the first slot where it passes max_skip."""
    B, H = scores.shape
    rel = prev_w - off
    in_win = ok & (prev_w >= 0) & (rel >= 0) & (rel < H)
    marks = torch.zeros((B, H + 1), dtype=torch.bool, device=scores.device)
    marks.scatter_(1, torch.where(in_win, rel, H), True)
    # newest first
    s_d, ok_d, mark_d = scores.flip(1), ok.flip(1), marks[:, :H].flip(1)
    run = torch.maximum(s_d.cummax(dim=1).values, span_i[:, None])
    run_excl = torch.cat([span_i[:, None], run[:, :-1]], dim=1)
    beat = ok_d & (s_d > run_excl)
    skip = ok_d & ~beat & mark_d
    a = skip.to(torch.int64) - beat.to(torch.int64)
    b = torch.where(beat, 0, NEG_INF)
    cum_a = a.cumsum(dim=1)
    counter = torch.maximum(cum_a, cum_a + (b - cum_a).cummax(dim=1).values)
    crossed = (counter > max_skip).to(torch.int64)
    scanned = (crossed.cumsum(dim=1) - crossed) == 0
    return scanned.flip(1)


def _skip_prune_mask(scores, ok, prev_w, off: int, span_i, max_skip: int):
    """The window's scores with every slot older than the break point
    (_skip_prune_scanned) masked to NEG_INF."""
    keep = _skip_prune_scanned(scores, ok, prev_w, off, span_i, max_skip)
    return torch.where(keep, scores, NEG_INF)


def _row_best(g, rp, qp, sp, f, prev, i, H, scalars, tab, pens, max_chain_skip):
    """(best, jb) of row i, pruned when max_chain_skip is set."""
    scores, ok, off = _window_scores(g, rp, qp, sp, f, i, H, scalars, tab, pens)
    if max_chain_skip is not None:
        scores = _skip_prune_mask(scores, ok, prev[:, off : off + H], off, sp[:, i],
                                  max_chain_skip)
    return _best(scores, off)


def chain_dp_batch_ref(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32, see log2_table
    max_chain_skip: int | None = None,
):
    """Returns (f, prev), each (B, A) int32 — the contract of the JAX
    chain_dp_batch: prev is the chosen predecessor, or -1 where i starts
    a chain. A Python loop over i, vectorised over the (B, H) window.
    max_chain_skip=None scores the window exactly; an int applies the
    reference's pruning (_skip_prune_mask)."""
    (g, rp, qp, sp), tab, pens = _dp_inputs(grp, rpos, qpos, span, scalars, log2_tab)
    B, A = grp.shape
    H = min(window, A)
    f = torch.zeros((B, A), dtype=torch.int64, device=grp.device)
    prev = torch.full_like(f, -1)
    for i in range(A):
        best, jb = _row_best(g, rp, qp, sp, f, prev, i, H, scalars, tab, pens,
                             max_chain_skip)
        win = best > sp[:, i]
        f[:, i] = torch.where(win, best, sp[:, i])
        prev[:, i] = torch.where(win, jb, -1)
    return f.to(torch.int32), prev.to(torch.int32)


def chain_dp_aux_batch_ref(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32, see log2_table
    max_chain_skip: int | None = None,
):
    """Returns (f, cnt, sq, sr), each (B, A) int32 — the contract of the
    JAX chain_dp_aux_batch: the DP of chain_dp_batch_ref, carrying the
    chain statistics along the chosen predecessor instead of prev (kept
    internally for the pruning's marks). max_chain_skip as in
    chain_dp_batch_ref."""
    (g, rp, qp, sp), tab, pens = _dp_inputs(grp, rpos, qpos, span, scalars, log2_tab)
    B, A = grp.shape
    H = min(window, A)
    f = torch.zeros((B, A), dtype=torch.int64, device=grp.device)
    cnt = torch.zeros_like(f)
    sq = torch.zeros_like(f)
    sr = torch.zeros_like(f)
    prev = torch.full_like(f, -1)
    rows = torch.arange(B, device=grp.device)
    for i in range(A):
        best, jb = _row_best(g, rp, qp, sp, f, prev, i, H, scalars, tab, pens,
                             max_chain_skip)
        win = best > sp[:, i]
        f[:, i] = torch.where(win, best, sp[:, i])
        prev[:, i] = torch.where(win, jb, -1)
        cnt[:, i] = torch.where(win, cnt[rows, jb] + 1, 1)
        sq[:, i] = torch.where(win, sq[rows, jb], qp[:, i])
        sr[:, i] = torch.where(win, sr[rows, jb], rp[:, i])
    return tuple(t.to(torch.int32) for t in (f, cnt, sq, sr))


def scanned_pairs(grp, rpos, qpos, span, f, prev, scalars: ChainScalars, window: int,
                  log2_tab: torch.Tensor, max_chain_skip: int | None) -> torch.Tensor:
    """(B,) int64: the predecessor slots j in [max(0, i-H), i) that the
    walk of each read visits, summed over its rows i < n (n one past its
    last valid anchor, the rows a kernel walks), given the DP's own (f,
    prev), chain_dp_batch_ref's outputs at the same max_chain_skip. With
    max_chain_skip the walk stops at its break (_skip_prune_scanned);
    without it every slot of the window counts."""
    (g, rp, qp, sp), tab, pens = _dp_inputs(grp, rpos, qpos, span, scalars, log2_tab)
    f, prev = f.to(torch.int64), prev.to(torch.int64)
    B, A = grp.shape
    H = min(window, A)
    n = torch.where(g != -1, torch.arange(1, A + 1, device=grp.device), 0).amax(dim=1)
    total = torch.zeros(B, dtype=torch.int64, device=grp.device)
    for i in range(A):
        scores, ok, off = _window_scores(g, rp, qp, sp, f, i, H, scalars, tab, pens)
        walk = (torch.arange(off, off + H, device=grp.device) < i)[None, :] & (i < n)[:, None]
        if max_chain_skip is not None:
            walk &= _skip_prune_scanned(scores, ok, prev[:, off : off + H], off, sp[:, i],
                                        max_chain_skip)
        total += walk.sum(dim=1)
    return total
