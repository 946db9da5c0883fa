"""Seeding in PyTorch: minimizer key sort, query-occurrence filter,
index lookup, anchor expansion and the per-read anchor sort.

Counterpart of minimap2_rs_tpu/ops/seeds_ops.py (seeds.rs:13-79). The
ragged occurrence lists expand into a padded (B, A) anchor tensor by a
cumsum + searchsorted (the JAX package's routing networks were a TPU
device-sort workaround). Lexicographic multi-key sorts are stable
torch.sorts, least significant key first, on non-negative int64 columns
(uint32 words carried in int64, so the 0xFFFFFFFF padding sorts last).
"""

from __future__ import annotations

import torch

from .index_ops import DeviceIndex, index_lookup
from .sketch import INV32, ks_keys, ordered_ks

INVALID_XHI = INV32


def _sort_rows_by(keys: list[torch.Tensor], payloads: list[torch.Tensor]):
    """Sort every row by `keys` lexicographically (keys[0] most
    significant), stably; returns the permuted keys and payloads."""
    cols = keys + payloads
    for key_i in reversed(range(len(keys))):
        order = cols[key_i].sort(dim=1, stable=True).indices
        cols = [c.gather(1, order) for c in cols]
    return cols[: len(keys)], cols[len(keys):]


def sort_minimizers_by_key(ks: torch.Tensor, ps: torch.Tensor):
    """Per-read sort of minimizer slots by key_span as a uint64 (padding
    last); equal keys keep ascending positions."""
    _, (ks2, ps2) = _sort_rows_by([ordered_ks(ks), ps], [ks, ps])
    return ks2, ps2


def query_occ_filter(ks: torch.Tensor, n_mini: torch.Tensor, q_occ_max: int,
                     q_occ_frac: float) -> torch.Tensor:
    """Mask of minimizers surviving the query-frequency filter
    (seeds.rs:13-36): drop keys whose per-read count exceeds both
    q_occ_max and floor(n * q_occ_frac); no-op when n <= q_occ_max.
    ks must be key-sorted per read; counts are run lengths."""
    B, M = ks.shape
    dev = ks.device
    keys = ks_keys(ks)
    idx = torch.arange(M, device=dev).expand(B, M)
    boundary = torch.ones((B, M), dtype=torch.bool, device=dev)
    boundary[:, 1:] = keys[:, 1:] != keys[:, :-1]
    first = torch.where(boundary, idx, -1).cummax(dim=1).values
    nxt_boundary = torch.ones_like(boundary)
    nxt_boundary[:, :-1] = boundary[:, 1:]
    last = torch.where(nxt_boundary, idx, M).flip(1).cummin(dim=1).values.flip(1)
    counts = last - first + 1
    # filled on the device: a host copy cannot be captured into a graph
    frac = torch.full((), q_occ_frac, dtype=torch.float32, device=dev)
    cutoff = (n_mini.to(torch.float32) * frac).to(torch.int64)
    n = n_mini.to(torch.int64)[:, None]
    drop = (counts > q_occ_max) & (counts > cutoff[:, None]) & (n > q_occ_max)
    return (idx < n) & ~drop


def lookup_keys(idx: DeviceIndex, ks: torch.Tensor, keep: torch.Tensor):
    """The index lookup of every minimizer slot (seeds.rs:42-47): (start,
    count) int64 (B, M) of its key's occurrence block. Filtered and
    padding slots probe key 0; expand_anchors, which places the anchors,
    masks their counts."""
    return index_lookup(idx, torch.where(keep, ks_keys(ks), 0))


def expand_anchors(
    idx: DeviceIndex,
    ks: torch.Tensor,       # (B, M) int64 key_span, key-sorted per read
    ps: torch.Tensor,       # (B, M) int64 query pos<<1|strand
    keep: torch.Tensor,     # (B, M) bool survivor mask
    start: torch.Tensor,    # (B, M) int64 occurrence block of each slot's key
    count: torch.Tensor,    # (B, M) int64 (lookup_keys)
    qlen: torch.Tensor,     # (B,) query lengths
    mid_occ: int,
    max_anchors: int,
):
    """Expansion + sort of looked-up minimizers (seeds.rs:48-79). Returns
    x_hi, x_lo, y_hi, y_lo ((B, A) int64 uint32 words, padding 0xFFFFFFFF
    sorted last), n_anchors (B,) int32 and overflow (B,) bool."""
    B, M = ks.shape
    A = max_anchors
    dev = ks.device
    # over-frequent target keys are skipped; singletons always kept
    # (seeds.rs:48-53)
    count = torch.where((count > 1) & (count > mid_occ), 0, count)
    count = torch.where(keep, count, 0)
    cum = count.cumsum(dim=1)
    total = cum[:, -1]
    n_anchors = total.clamp(max=A)

    # anchor slot a comes from minimizer m = the first with cum[m] > a,
    # at position-table row start[m] + a - (cum[m] - count[m])
    a_idx = torch.arange(A, device=dev).expand(B, A).contiguous()
    m = torch.searchsorted(cum, a_idx, right=True).clamp(max=M - 1)
    valid = a_idx < n_anchors[:, None]
    row = (start - (cum - count)).gather(1, m) + a_idx
    P = idx.pos.shape[1]
    p_idx = torch.where(valid, row, 0).clamp(0, P - 1)
    span = (ks & 0xFF).gather(1, m)
    ps_m = ps.gather(1, m) & 0x7FFFFF
    if idx.pos_packed:
        # one plane of abs_pos<<1|strand; rid and its base from seq_cum
        w = idx.pos[0].to(torch.int64)[p_idx] & INV32
        absp = w >> 1
        cum_s = idx.seq_cum
        r_hi = torch.searchsorted(cum_s[1:].contiguous(), absp, right=True)
        r_hi = r_hi.clamp(max=idx.n_seq - 1)
        r_lo = ((absp - cum_s[r_hi]) << 1) | (w & 1)
    else:
        r_hi = idx.pos[0].to(torch.int64)[p_idx] & INV32
        r_lo = idx.pos[1].to(torch.int64)[p_idx] & INV32

    qpos = ps_m >> 1
    forward = (r_lo & 1) == (ps_m & 1)
    x_hi = torch.where(forward, r_hi, r_hi | 0x80000000)
    x_lo = r_lo >> 1
    y_lo = torch.where(
        forward, qpos, (qlen.to(torch.int64)[:, None] - (qpos + 1 - span) - 1) & INV32
    )
    x_hi = torch.where(valid, x_hi, INVALID_XHI)
    x_lo = torch.where(valid, x_lo, INV32)
    # (span, qpos') packed into one sort key: qpos' < 2^24 (reads <= 4M
    # bases) and span < 256, preserving the (y_hi, y_lo) order
    y_packed = torch.where(valid, (span << 24) | y_lo, INV32)
    (x_hi, x_lo, y_packed), _ = _sort_rows_by([x_hi, x_lo, y_packed], [])
    real = x_hi != INVALID_XHI
    y_hi = torch.where(real, y_packed >> 24, INV32)
    y_lo = torch.where(real, y_packed & 0xFFFFFF, INV32)
    return x_hi, x_lo, y_hi, y_lo, n_anchors.to(torch.int32), total > A
