"""Chaining DP scalars and the plain PyTorch version of the aux chain DP.

Counterpart of minimap2_rs_tpu/ops/chain_ops.py. The exact-window
colinear chaining DP (lchain.rs:74-91, without the max_chain_skip
heuristic): for each anchor i take the best f[j] + comput_sc(i, j) over
the admissible j in [max(0, i-H), i); ties go to the largest j; when the
best does not beat span[i], f[i] = span[i] and i starts a chain. The
aux form also carries (cnt, sq, sr) = (chain length, chain-start qpos,
chain-start rpos) along the chosen predecessor, so the lite path never
backtracks (ops/finalize_ops.py).

`chain_dp_aux_batch_ref` is the plain version of the CUDA kernel in
kernels/chain_dp.py: the CPU path, and the reference the kernel is held
against on the card. Both read log2(dd+1) from the same host-built f32
table of the oracle's mg_log2, so they compute the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minimap2_rs_tpu.oracle.lchain import mg_log2

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


def chain_dp_aux_batch_ref(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32, see log2_table
):
    """Returns (f, cnt, sq, sr), each (B, A) int32 — the contract of the
    JAX chain_dp_aux_batch. A Python loop over i, vectorised over the
    (B, H) predecessor window; differences are taken in int64."""
    B, A = grp.shape
    H = min(window, A)
    dev = grp.device
    if log2_tab.shape[0] <= scalars.bw:
        raise ValueError("log2 table shorter than bw + 1")
    g, rp, qp, sp = (t.to(torch.int64) for t in (grp, rpos, qpos, span))
    tab = log2_tab.to(dev)
    t_hi = tab.shape[0] - 1
    gap = torch.tensor(scalars.chn_pen_gap, dtype=torch.float32, device=dev)
    skip = torch.tensor(scalars.chn_pen_skip, dtype=torch.float32, device=dev)
    mdx, mdy, bw = scalars.max_dist_x, scalars.max_dist_y, scalars.bw
    f = torch.zeros((B, A), dtype=torch.int64, device=dev)
    cnt = torch.zeros_like(f)
    sq = torch.zeros_like(f)
    sr = torch.zeros_like(f)
    rows = torch.arange(B, device=dev)
    jr = torch.arange(H, device=dev)
    for i in range(A):
        off = min(max(i - H, 0), A - H)
        w = slice(off, off + H)
        dq = qp[:, i : i + 1] - qp[:, w]
        dr = rp[:, i : i + 1] - rp[:, w]
        dd = (dr - dq).abs()
        dg = torch.minimum(dr, dq)
        ok = (
            (jr + off < i)
            & (g[:, w] == g[:, i : i + 1])
            & (dq > 0) & (dq <= mdx) & (dq <= mdy)
            & (dr != 0) & (dr <= mdx)
            & (dd <= bw)
        )
        span_w = sp[:, w]
        sc = torch.minimum(span_w, dg)
        # f32, one rounding per op as in oracle/lchain.py:78-80; the cast
        # truncates toward zero like `as i32`
        lin = gap * dd.to(torch.float32) + skip * dg.to(torch.float32)
        pen = (lin + 0.5 * tab[dd.clamp(0, t_hi)]).to(torch.int64)
        sc = torch.where((dd != 0) | (dg > span_w), sc - pen, sc)
        scores = torch.where(ok, sc + f[:, w], NEG_INF)
        best = scores.max(dim=1).values
        # ties take the largest j (lchain.rs:80-84 scans j descending
        # and needs strict improvement)
        jb = off + (H - 1) - scores.flip(1).argmax(dim=1)
        win = best > sp[:, i]
        f[:, i] = torch.where(win, best, sp[:, i])
        cnt[:, i] = torch.where(win, cnt[rows, jb] + 1, 1)
        sq[:, i] = torch.where(win, sq[rows, jb], qp[:, i])
        sr[:, i] = torch.where(win, sr[rows, jb], rp[:, i])
    return tuple(t.to(torch.int32) for t in (f, cnt, sq, sr))
