"""Banded alignment and extension in PyTorch (beyond the reference).

Counterpart of minimap2_rs_tpu/ops/extend_ops.py:43-150. The band is a
window of W = 2b+1 diagonal offsets o = j - i + b; iterating rows i,
each row is branch-free (B, W) tensor work: the diagonal and the deletion
come from the previous row, and the within-row insertion recurrence uses
the decay-cummax identity (re-opening a gap out of a cell that itself
ended a gap is never optimal for open >= 0). No mapping path calls these
functions; they are device-agnostic, and they are not Pallas kernels in
the JAX package, so the port has no CUDA kernel for them.
"""

from __future__ import annotations

import torch

_NEG = -(2**24)  # -inf surrogate safe for int32-range adds


def _row_codes(rpad: torch.Tensor, i: int, offs: torch.Tensor) -> torch.Tensor:
    """r codes for columns j = i + (o - b) at row i (1-based); rpad is r
    padded with b + 1 codes of 4 on both sides."""
    W = offs.shape[0]
    idx = (i + offs + W // 2).clamp(0, rpad.shape[1] - 1)
    return rpad[:, idx]


def _pad(r: torch.Tensor, band: int) -> torch.Tensor:
    return torch.nn.functional.pad(r, (band + 1, band + 1), value=4)


def _query_code(q: torch.Tensor, i: int) -> torch.Tensor:
    return q[:, min(i - 1, q.shape[1] - 1)]


def banded_edit_batch(q: torch.Tensor, qlen: torch.Tensor, r: torch.Tensor,
                      rlen: torch.Tensor, band: int) -> torch.Tensor:
    """Banded Levenshtein distance per pair (paf.rs:35-79 semantics): q,
    r are (B, N) / (B, Nr) nt4 codes (pad 4); returns (B,) int32
    distances, max(n, m) when the end cell falls outside the band."""
    B, N = q.shape
    dev = q.device
    W = 2 * band + 1
    INF = 2**24
    q, r = q.to(torch.int64), r.to(torch.int64)
    qlen, rlen = qlen.to(torch.int64), rlen.to(torch.int64)
    offs = torch.arange(W, device=dev) - band
    rpad = _pad(r, band)
    prev = torch.where(offs >= 0, offs, INF).expand(B, W)
    prev = torch.where(offs <= rlen[:, None], prev, INF)
    inf_col = torch.full((B, 1), INF, dtype=torch.int64, device=dev)
    for i in range(1, N + 1):
        qc = _query_code(q, i)[:, None]
        j = i + offs[None, :]
        cost = torch.where((qc == _row_codes(rpad, i, offs)) & (qc < 4), 0, 1)
        in_r = (j > 0) & (j <= rlen[:, None])
        diag = torch.where(in_r, prev + cost, INF)
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        dele = torch.where(j == 0, i, INF)
        cand = torch.minimum(torch.minimum(diag, torch.where(in_r, up, INF)), dele)
        # insertion curr[o-1] + 1: a unit-decay cummin
        ins = (cand - offs).cummin(dim=1).values + offs
        curr = torch.where(in_r | (j == 0), torch.minimum(cand, ins), INF)
        prev = torch.where(i <= qlen[:, None], curr, prev)
    kd = rlen - qlen + band
    in_band = (kd >= 0) & (kd < W)
    got = prev.gather(1, kd.clamp(0, W - 1)[:, None])[:, 0]
    worst = torch.maximum(qlen, rlen)
    out = torch.where(in_band & (got < INF), got, worst)
    return torch.where((qlen == 0) | (rlen == 0), worst, out).to(torch.int32)


def banded_affine_extend(
    q: torch.Tensor, qlen: torch.Tensor, r: torch.Tensor, rlen: torch.Tensor,
    band: int, match: int = 2, mismatch: int = 4, gap_open: int = 4,
    gap_ext: int = 2,
):
    """Banded affine-gap extension per pair from the (0, 0) corner: the
    best score over all in-band cells. Returns (best_score, best_i,
    best_j), (B,) int32 each, (0, 0, 0) when no cell scores above 0."""
    B, N = q.shape
    dev = q.device
    W = 2 * band + 1
    q, r = q.to(torch.int64), r.to(torch.int64)
    qlen, rlen = qlen.to(torch.int64), rlen.to(torch.int64)
    offs = torch.arange(W, device=dev) - band
    rpad = _pad(r, band)
    neg_col = torch.full((B, 1), _NEG, dtype=torch.int64, device=dev)
    # row 0: the leading insertion run
    H = torch.where(offs == 0, 0, torch.where(offs > 0, -(gap_open + gap_ext * offs), _NEG))
    H = torch.where(offs <= rlen[:, None], H, _NEG)
    F = torch.full((B, W), _NEG, dtype=torch.int64, device=dev)
    best = torch.zeros(B, dtype=torch.int64, device=dev)
    bi = torch.zeros_like(best)
    bj = torch.zeros_like(best)
    for i in range(1, N + 1):
        qc = _query_code(q, i)[:, None]
        j = i + offs[None, :]
        sub = torch.where((qc == _row_codes(rpad, i, offs)) & (qc < 4), match, -mismatch)
        in_r = (j > 0) & (j <= rlen[:, None]) & (i <= qlen[:, None])
        F = torch.maximum(torch.cat([F[:, 1:], neg_col], dim=1),
                          torch.cat([H[:, 1:], neg_col], dim=1) - gap_open) - gap_ext
        H0 = torch.maximum(torch.where(in_r, H + sub, _NEG), torch.where(in_r, F, _NEG))
        run = (H0 + gap_ext * offs).cummax(dim=1).values
        E = torch.cat([neg_col, run[:, :-1]], dim=1) - gap_ext * offs - gap_open
        H = torch.where(in_r, torch.maximum(H0, torch.where(in_r, E, _NEG)), _NEG)
        rowmax, argk = H.max(dim=1)
        upd = rowmax > best
        best = torch.where(upd, rowmax, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, i + argk - band, bj)
    return tuple(t.to(torch.int32) for t in (best, bi, bj))
