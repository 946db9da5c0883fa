"""On-device chain finalization for the lite path, in PyTorch.

Counterpart of minimap2_rs_tpu/ops/finalize_ops.py. With min_cnt >= 2
the reference's backtrack always takes its greedy single-chain fallback
(lchain.rs:161-173), so each read's PAF fields are per-read arithmetic
over the aux chain DP's (f, cnt, sq, sr) — no backtracking. The rows
ship as the 10-word wire of pack_fields_wire; the host unpacks them with
unpack_fields_wire and formats PAF with the native runtime.

Arithmetic follows the JAX module's int32 semantics: uint32 anchor words
(carried in int64) are reinterpreted as int32 where the JAX code
bitcasts them.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -(2**30)

FIELDS = [
    "score", "qs", "qe", "ts", "te", "cm", "grp", "n_match", "st", "n_tot",
    "dv_found", "rescue", "n_anchors", "n_mini", "mini_ovf", "anc_ovf",
    "win_ovf", "sum_span",
]

# 18 logical fields ship as 10 int32 words per read (n_match == cm;
# 16-bit-bounded counters pack in pairs; the 5 flags share n_tot's word)
WIRE_WORDS = 10


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> int32 with the same bits."""
    t = t.to(torch.int64)
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def wire_packable(A: int, M: int) -> bool:
    """True when every packed half-word is statically < 2^16:
    cm/n_anchors <= A, n_mini/st <= M, n_tot <= M + 2."""
    return A < (1 << 16) and M + 2 < (1 << 16)


def pack_fields_wire(fields: torch.Tensor) -> torch.Tensor:
    """(B, 18) int32 field rows -> (B, 10) int32 wire rows."""
    c = {n: fields[:, i].to(torch.int64) for i, n in enumerate(FIELDS)}
    w16 = lambda hi, lo: as_i32((hi << 16) | lo)
    flags = (
        c["dv_found"] | (c["rescue"] << 1) | (c["mini_ovf"] << 2)
        | (c["anc_ovf"] << 3) | (c["win_ovf"] << 4)
    )
    return torch.stack(
        [
            fields[:, FIELDS.index(n)]
            for n in ("score", "qs", "qe", "ts", "te", "grp")
        ]
        + [
            w16(c["cm"], c["n_anchors"]), w16(c["n_mini"], c["st"]),
            w16(c["n_tot"], flags), fields[:, FIELDS.index("sum_span")],
        ],
        dim=1,
    )


def unpack_fields_wire(wire) -> np.ndarray:
    """Host-side inverse of pack_fields_wire: (B, 10) -> (B, 18) int32."""
    w = np.ascontiguousarray(wire, dtype=np.int32)
    u = w.view(np.uint32)
    out = np.empty((w.shape[0], len(FIELDS)), np.int32)
    col = {n: i for i, n in enumerate(FIELDS)}
    for j, name in enumerate(("score", "qs", "qe", "ts", "te", "grp")):
        out[:, col[name]] = w[:, j]
    out[:, col["cm"]] = (u[:, 6] >> 16).astype(np.int32)
    out[:, col["n_match"]] = out[:, col["cm"]]
    out[:, col["n_anchors"]] = (u[:, 6] & 0xFFFF).astype(np.int32)
    out[:, col["n_mini"]] = (u[:, 7] >> 16).astype(np.int32)
    out[:, col["st"]] = (u[:, 7] & 0xFFFF).astype(np.int32)
    out[:, col["n_tot"]] = (u[:, 8] >> 16).astype(np.int32)
    flags = u[:, 8]
    out[:, col["dv_found"]] = (flags & 1).astype(np.int32)
    out[:, col["rescue"]] = ((flags >> 1) & 1).astype(np.int32)
    out[:, col["mini_ovf"]] = ((flags >> 2) & 1).astype(np.int32)
    out[:, col["anc_ovf"]] = ((flags >> 3) & 1).astype(np.int32)
    out[:, col["win_ovf"]] = ((flags >> 4) & 1).astype(np.int32)
    out[:, col["sum_span"]] = w[:, 9]
    return out


def finalize_from_aux(
    f, cnt, sq, sr,            # (B, A) int32 aux chain outputs
    x_hi, x_lo, y_lo,          # (B, A) int64 uint32 sorted anchor words
    n_anchors,                 # (B,) int32
    mini_pos,                  # (B, M) int64 position-sorted, padding max
    n_mini,                    # (B,) int32
    lengths,                   # (B,) int32
    tlens,                     # (n_seq,) int32
    mini_ovf, anc_ovf,         # (B,) bool
    k: int,
    rmq_rescue_size: int, rmq_rescue_ratio: float,
    win_ovf=None,              # (B,) bool or None
):
    """Returns the (B, 18) int32 field rows (see FIELDS); non-HPC spans
    (every anchor span is k)."""
    B, A = f.shape
    dev = f.device
    i32 = torch.int32
    a_idx = torch.arange(A, device=dev)
    valid = a_idx[None, :] < n_anchors[:, None]
    fm = torch.where(valid, f, _NEG)
    # the last maximum (Rust max_by_key)
    best_i = ((A - 1) - fm.flip(1).argmax(dim=1))[:, None]
    at_best = lambda arr: arr.gather(1, best_i)[:, 0]

    score = at_best(fm)
    cm = at_best(cnt)
    # every chain anchor's query position is in the minimizer stream and
    # chains are strictly increasing, so the two-pointer match count
    # (paf.rs:185-188) equals the chain length
    n_match = cm
    sq_b = at_best(sq)
    sr_b = at_best(sr)
    grp = as_i32(at_best(x_hi))
    rev = (grp >> 31) & 1
    rid = grp & 0x7FFFFFFF
    tlen = tlens[rid.to(torch.int64).clamp(0, tlens.shape[0] - 1)]
    qlen = lengths.to(i32)
    qpos_b = as_i32(at_best(y_lo))
    rpos_b = as_i32(at_best(x_lo))
    span_b = torch.full((B,), k, dtype=i32, device=dev)

    qs = (sq_b - (span_b - 1)).clamp(min=0)
    qe = qpos_b + 1
    ts = (sr_b - (span_b - 1)).clamp(min=0)
    te = rpos_b + 1

    qfwd_best = torch.where(rev == 1, qlen - 1 - (qpos_b + 1 - span_b), qpos_b)
    qfwd_start = torch.where(rev == 1, qlen - 1 - (sq_b + 1 - span_b), sq_b)
    first_u = torch.minimum(qfwd_best, qfwd_start).clamp(0, (1 << 24) - 1).to(torch.int64)
    last_u = torch.maximum(qfwd_best, qfwd_start).clamp(0, (1 << 24) - 1).to(torch.int64)
    # lower bounds by a full-width compare + row sum (padding never < q)
    st = (mini_pos < first_u[:, None]).sum(dim=1).to(i32)
    M = mini_pos.shape[1]
    at_st = mini_pos.gather(1, st.to(torch.int64).clamp(max=M - 1)[:, None])[:, 0]
    dv_found = (st < n_mini) & (at_st == first_u)
    en = (mini_pos < last_u[:, None]).sum(dim=1).to(i32)
    n_tot = en - st + 1
    r_qs = torch.where(rev == 1, qlen - qe, qs)
    r_qe = torch.where(rev == 1, qlen - qs, qe)
    # the dv border uses the truncated average span (paf.rs:192-196) by
    # INTEGER division: for span <= 255 and n_mini < 2^16 it equals the
    # truncated correctly-rounded f32 quotient (finalize_ops.py:201-213)
    sum_span = n_mini.to(i32) * k
    kk = torch.div(sum_span, n_mini.clamp(min=1), rounding_mode="floor").to(i32)
    n_tot = n_tot + ((r_qs > kk) & (ts > kk)).to(i32)
    n_tot = n_tot + (((qlen - r_qe) > kk) & ((tlen - te) > kk)).to(i32)

    cov = (qe - qs).clamp(min=0)
    uncovered = (qlen - cov).clamp(min=0)
    # filled on the device: a host copy cannot be captured into a graph
    one = torch.full((), 1.0, dtype=torch.float32, device=dev)
    ratio = torch.full((), rmq_rescue_ratio, dtype=torch.float32, device=dev)
    rescue = (uncovered > rmq_rescue_size) | (
        cov.to(torch.float32) < qlen.to(torch.float32) * (one - ratio)
    )
    if win_ovf is None:
        win_ovf = torch.zeros((B,), dtype=torch.bool, device=dev)
    cols = [
        score, qs, qe, ts, te, cm, grp, n_match, st, n_tot,
        dv_found, rescue, n_anchors, n_mini, mini_ovf, anc_ovf, win_ovf,
        sum_span,
    ]
    return torch.stack([c.to(i32) for c in cols], dim=1)
