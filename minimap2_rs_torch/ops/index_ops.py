"""Device-resident minimizer index and its lookup, in PyTorch.

Counterpart of minimap2_rs_tpu/ops/index_ops.py. The numpy planners
below are copies of the JAX module's (that module imports jax, which
this package never does); `DeviceIndex.from_host` lays the tables out
byte for byte as the JAX DeviceIndex does, so both packages probe the
same bytes.

The planner picks a direct-mapped table addressed by the low p bits of
the hashed key. Two of its layouts are probed here:

  * dm_entry == 3, fused: row p = [S compact metas | position base], the
    positions permuted into bucket-grouped order; start = base + the
    exclusive prefix sum of the earlier slots' counts. Larger genomes
    get it (the 5 Mbp headline: p=18, S=16).
  * dm_entry == 4, wide: S entries [key_hi, key_lo, start, count] per
    row. Small genomes get it (50 kb: p=12, S=16).

The sharded index of the multi-GPU path (parallel/sharded_index.py)
keeps the compact layout the planner would fuse: dm_entry == 2, a
(2^p, S) table of metas [fp | count << fp_bits] and a flat start plane
`dm_start`, probed in two phases (a row gather of the S metas, then one
1-D gather of the hit slot's start).

Above the 2 GB cap the planner gives no direct table, and the lookup
falls back to the prefix probe (JAX index_ops.py:504-521): the prefix
table gives each key's bucket base in the padded key table `kv`, and S
consecutive rows are compared there (prefix_probe; on the card the map
programs take the kernel of kernels/probe.py, which reads the bucket's
own rows alone).

Tables are stored as int32 tensors holding the uint32 words' bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MAX_PREFIX_BITS = 26  # 256 MB table cap; beyond this widen bucket_slots
_DM_BYTE_CAP = 1 << 31  # 2 GB: beyond this, fall back to two-gather lookups
U32_MASK = 0xFFFFFFFF


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern table words -> their uint32 values as int64."""
    return t.to(torch.int64) & U32_MASK


def _t32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy table -> int32 tensor with the same bytes."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


@dataclasses.dataclass
class DeviceIndex:
    """Device tables of an index (metadata stays in the OracleIndex)."""

    kv: torch.Tensor      # (U + S, 4) [key_hi, key_lo, start, count], or sentinel rows
    pos: torch.Tensor     # (1, P) abs_pos<<1|strand (packed) or (2, P) [rid], [pos<<1|strand]
    prefix: torch.Tensor  # (2^prefix_bits + 1,) lower bounds, or sentinel
    dm: torch.Tensor      # direct-mapped table (2^dm_bits, entry * S) or fused (2^dm_bits, S + 1)
    seq_cum: torch.Tensor | None   # (n_seq + 1,) cumulative lengths (packed pos)
    dm_start: torch.Tensor | None = None  # (2^dm_bits * S,) start plane of dm_entry == 2
    prefix_shift: int = 0
    bucket_slots: int = 8
    n_keys: int = 0
    dm_bits: int = 0
    dm_slots: int = 0
    dm_entry: int = 4
    dm_fp_bits: int = 0
    pos_packed: bool = False
    n_seq: int = 0

    @staticmethod
    def from_host(keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                  positions: np.ndarray, key_bits: int = 56,
                  seq_lens=None, *, device) -> "DeviceIndex":
        """Tables from the host uint64 arrays (JAX DeviceIndex.from_host,
        index_ops.py:133-204), moved to `device`. seq_lens enables the
        packed position plane (total length < 2^31, <= 64 sequences —
        the JAX package's condition, kept so the bytes match)."""
        kv_np, prefix_np, shift, S = plan_prefix_layout(keys, key_bits)
        dm_np, dm_p, dm_S, dm_entry, pos_perm = plan_direct_layout(
            keys, starts, counts, key_bits
        )
        if pos_perm is not None:
            positions = positions[pos_perm]
        P = positions.shape[0]
        cum = None
        if seq_lens is not None:
            cum = np.zeros(len(seq_lens) + 1, dtype=np.int64)
            np.cumsum(np.asarray(seq_lens, dtype=np.int64), out=cum[1:])
        pos_packed = bool(
            cum is not None and cum[-1] < (1 << 31) and len(cum) - 1 <= 64
        )
        if pos_packed:
            rid = (positions >> np.uint64(32)).astype(np.int64)
            rps = (positions & np.uint64(U32_MASK)).astype(np.int64)
            absw = ((cum[rid] + (rps >> 1)) << 1) | (rps & 1)
            pos_np = np.zeros((1, max(P, 1)), dtype=np.uint32)
            pos_np[0, :P] = absw.astype(np.uint32)
        else:
            pos_np = np.zeros((2, max(P, 1)), dtype=np.uint32)
            pos_np[0, :P] = (positions >> np.uint64(32)).astype(np.uint32)
            pos_np[1, :P] = (positions & np.uint64(U32_MASK)).astype(np.uint32)
        kv_np[: keys.shape[0], 2] = starts.astype(np.uint32)
        kv_np[: keys.shape[0], 3] = counts.astype(np.uint32)
        if dm_S:
            # the lookup never reads kv/prefix once dm exists (sentinels)
            kv_np = kv_np[:1]
            prefix_np = prefix_np[:2]
        return DeviceIndex(
            kv=_t32(kv_np, device),
            pos=_t32(pos_np, device),
            prefix=torch.from_numpy(prefix_np).to(device),
            dm=_t32(dm_np, device),
            seq_cum=(torch.from_numpy(cum).to(device) if pos_packed else None),
            prefix_shift=shift,
            bucket_slots=S,
            n_keys=int(keys.shape[0]),
            dm_bits=dm_p,
            dm_slots=dm_S,
            dm_entry=dm_entry,
            dm_fp_bits=max(0, key_bits - dm_p),
            pos_packed=pos_packed,
            n_seq=(len(cum) - 1 if pos_packed else 0),
        )


def plan_prefix_layout(keys: np.ndarray, key_bits: int):
    """Choose (prefix_bits, bucket_slots) so every prefix bucket fits in
    one bucket_slots-row slice; build the padded key table + prefix
    lower bounds. Returns (kv[:, :2] filled, prefix, shift, S); the
    caller fills columns 2-3."""
    U = int(keys.shape[0])
    prefix_bits = max(12, min(int(np.ceil(np.log2(U + 1))), _MAX_PREFIX_BITS, key_bits))
    prefix_bits = min(prefix_bits, _MAX_PREFIX_BITS, key_bits)
    shift = max(0, key_bits - prefix_bits)
    prefixes = (keys >> np.uint64(shift)).astype(np.int64)
    hist = np.bincount(prefixes, minlength=(1 << prefix_bits))
    while hist.max(initial=1) > 16 and prefix_bits < min(_MAX_PREFIX_BITS, key_bits):
        prefix_bits += 1
        shift = max(0, key_bits - prefix_bits)
        prefixes = (keys >> np.uint64(shift)).astype(np.int64)
        hist = np.bincount(prefixes, minlength=(1 << prefix_bits))
    prefix_np = np.zeros((1 << prefix_bits) + 1, dtype=np.int32)
    np.cumsum(hist, out=prefix_np[1:])
    maxb = int(hist.max()) if U else 1
    S = 4
    while S < maxb:
        S *= 2
    kv_np = np.full((U + S, 4), U32_MASK, dtype=np.uint32)
    kv_np[:U, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    kv_np[:U, 1] = (keys & np.uint64(U32_MASK)).astype(np.uint32)
    kv_np[U:, 3] = 0  # sentinel rows never match, and count 0 is safe
    return kv_np, prefix_np, shift, S


def plan_direct_layout(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray, key_bits: int,
    byte_cap: int = _DM_BYTE_CAP,
):
    """Direct-mapped table addressed by the low p key bits, at the
    min-bytes layout of choose_direct_layout; a compact 2-word entry is
    upgraded to the fused layout (entry 3). Returns (table, p, S,
    entry_words, pos_perm); pos_perm permutes the positions array for
    the fused layout (None otherwise); (empty, 0, 0, 4, None) when over
    the cap."""
    U = int(keys.shape[0])
    if U == 0:
        return np.zeros((0, 4), dtype=np.uint32), 0, 0, 4, None
    layout = choose_direct_layout([keys], key_bits, int(counts.max()), byte_cap)
    if layout is None:
        return np.zeros((0, 4), dtype=np.uint32), 0, 0, 4, None
    p, S, entry = layout
    if entry == 2:
        dm, pos_perm = fill_direct_table_fused(keys, starts, counts, key_bits, p, S)
        return dm, p, S, 3, pos_perm
    dm, _ = fill_direct_table(keys, starts, counts, key_bits, p, S, entry)
    return dm, p, S, entry, None


def fill_direct_table_fused(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    key_bits: int, p: int, S: int,
):
    """Fused single-gather table: row p = [meta_0..meta_{S-1}, base],
    meta_s = fp | count << fp_bits, base = bucket p's first offset in the
    BUCKET-GROUPED positions. Returns (dm (2^p, S+1) u32, pos_perm)."""
    U = int(keys.shape[0])
    fp_bits = key_bits - p
    pref = (keys & np.uint64((1 << p) - 1)).astype(np.int64)
    order = np.argsort(pref, kind="stable")
    sp = pref[order]
    first_sorted = np.searchsorted(sp, sp, side="left")
    rank = np.arange(U, dtype=np.int64) - first_sorted
    cnt_o = counts[order].astype(np.int64)
    out_off = np.zeros(U + 1, dtype=np.int64)
    np.cumsum(cnt_o, out=out_off[1:])
    pos_perm = (
        np.repeat(starts[order].astype(np.int64) - out_off[:-1], cnt_o)
        + np.arange(out_off[-1], dtype=np.int64)
    )
    dm = np.zeros((1 << p, S + 1), dtype=np.uint32)
    fp_o = (keys[order] >> np.uint64(p)).astype(np.uint32)
    dm[sp, rank] = fp_o | (cnt_o.astype(np.uint32) << np.uint32(fp_bits))
    dm[sp, S] = out_off[first_sorted].astype(np.uint32)
    return dm, pos_perm


def choose_direct_layout(
    key_slices: list, key_bits: int, max_count: int,
    byte_cap: int = _DM_BYTE_CAP,
):
    """Pick one (p, S, entry) layout covering every key slice: the
    smallest table below byte_cap. None when infeasible."""
    sizes = max(max(int(ks.shape[0]) for ks in key_slices), 1)
    cands = []  # (nbytes, p, S, entry)
    best_bytes = None
    p_lo = max(12, int(np.ceil(np.log2(sizes + 1))) - 2)
    p_hi = min(_MAX_PREFIX_BITS, key_bits)
    compact_p = key_bits - 12
    for p in range(min(p_lo, key_bits), p_hi + 1):
        maxb = 1
        for ks in key_slices:
            if ks.shape[0]:
                pref = (ks & np.uint64((1 << p) - 1)).astype(np.int64)
                maxb = max(maxb, int(np.bincount(pref, minlength=1 << p).max()))
        S = 4
        while S < maxb:
            S *= 2
        fp_bits = key_bits - p
        entry = 2 if (fp_bits <= 12 and max_count < (1 << (32 - fp_bits))) else 4
        nbytes = (1 << p) * S * entry * 4
        cands.append((nbytes, p, S, entry))
        if nbytes < byte_cap and (best_bytes is None or nbytes < best_bytes):
            best_bytes = nbytes
        if (
            best_bytes is not None
            and S <= 8
            and nbytes >= 2 * best_bytes
            and (p >= compact_p or compact_p > p_hi)
        ):
            break
    if best_bytes is None:
        return None
    feas = [c for c in cands if c[0] < byte_cap]
    _nb, p, S, entry = min(feas)
    return p, S, entry


def fill_direct_table(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    key_bits: int, p: int, S: int, entry: int,
):
    """One direct-mapped table at a forced (p, S, entry) layout (JAX
    index_ops.py:385-422), shared by the planner and the sharded builder,
    which needs one layout across shards. entry 4: row p holds S entries
    [key_hi, key_lo, start, count]; empty entries carry key uint64-max
    and count 0; returns (table, None). entry 2: the (2^p, S) metas
    [fp | count << fp_bits] and the flat (2^p * S,) start plane; returns
    (metas, starts)."""
    U = int(keys.shape[0])
    fp_bits = key_bits - p
    pref = (keys & np.uint64((1 << p) - 1)).astype(np.int64)
    # within-bucket rank (buckets by low bits are not sorted-contiguous)
    order = np.argsort(pref, kind="stable")
    sp = pref[order]
    first_sorted = np.searchsorted(sp, sp, side="left")
    rank = np.empty(U, dtype=np.int64)
    rank[order] = np.arange(U) - first_sorted
    slot = pref * S + rank
    if entry == 2:
        meta = np.zeros(((1 << p) * S,), dtype=np.uint32)
        start_plane = np.zeros(((1 << p) * S,), dtype=np.uint32)
        fp = (keys >> np.uint64(p)).astype(np.uint32)
        meta[slot] = fp | (counts.astype(np.uint32) << np.uint32(fp_bits))
        start_plane[slot] = starts.astype(np.uint32)
        return meta.reshape(1 << p, S), start_plane
    dm = np.full(((1 << p) * S, 4), U32_MASK, dtype=np.uint32)
    dm[:, 3] = 0
    dm[slot, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    dm[slot, 1] = (keys & np.uint64(U32_MASK)).astype(np.uint32)
    dm[slot, 2] = starts.astype(np.uint32)
    dm[slot, 3] = counts.astype(np.uint32)
    return dm.reshape(1 << p, entry * S), None


def gather_rows(table: torch.Tensor, base: torch.Tensor, S: int) -> torch.Tensor:
    """table (N, C), N >= S, base any int shape -> (*base.shape, S, C): the
    S consecutive rows from each base, one gather from a view of the
    table's S-row windows, with one index a query. A base past N - S
    takes the last window; JAX index_ops.py:425-437 clamps each row at
    the end instead, the same rows wherever base <= N - S, as every
    prefix table's bound is (kv has S sentinel rows past its U keys)."""
    windows = table.unfold(0, S, 1).transpose(-1, -2)  # (N - S + 1, S, C), a view
    return windows[base.clamp(0, table.shape[0] - S)]


def prefix_probe(idx: DeviceIndex, q: torch.Tensor):
    """The prefix probe of an index with no direct table (JAX
    index_ops.py:504-521): for each query key (int64, any shape), the S =
    bucket_slots rows of kv from its bucket's base prefix[q >> shift],
    compared with the key, (start, count) int64 of the hit row, 0 and 0
    without one. The plain version of the kernel csrc/probe.cu, which
    reads only the bucket's own rows (kernels/probe.py); it runs on CPU
    tensors."""
    p = (q >> idx.prefix_shift).clamp(0, idx.prefix.shape[0] - 2)
    base = idx.prefix.to(torch.int64)[p]
    # the S rows stay int32 words, compared with the key's words as
    # int32 bits, and only the hit row widens: at S 128 (a human-sized
    # index at k 19) the rows are 2 KB a query key; widened to int64,
    # 4 KB (9 GiB for a batch of bucket 16,384) beside int64 row
    # indices, they do not fit the card beside the index
    rows = gather_rows(idx.kv, base, idx.bucket_slots)  # (..., S, 4) int32
    # (the int64 -> int32 cast keeps the low 32 bits)
    hit = (rows[..., 0] == (q >> 32).to(torch.int32).unsqueeze(-1)) & (
        rows[..., 1] == q.to(torch.int32).unsqueeze(-1)
    )
    # keys are distinct and the sentinel rows match no key: at most
    # one hit, whose start and count the JAX probe's max over the
    # slots gives (0 without one)
    slot = hit.to(torch.int8).argmax(dim=-1)[..., None, None].expand(*q.shape, 1, 4)
    row = _u32(rows.gather(-2, slot).squeeze(-2))  # (..., 4)
    found = hit.any(dim=-1)
    start = torch.where(found, row[..., 2], 0)
    count = torch.where(found, row[..., 3], 0)
    return start, count


def index_lookup(idx: DeviceIndex, q: torch.Tensor):
    """For each query key (int64, any shape): (start, count) int64 of its
    occurrence block, count 0 when absent (Index::get, index.rs:143-154).
    One row gather on the direct-mapped table (two phases for the
    sharded index's compact entry); prefix_probe when there is none."""
    if not idx.dm_slots:
        return prefix_probe(idx, q)
    S = idx.dm_slots
    if idx.dm_entry == 3:
        fpb = idx.dm_fp_bits
        p = (q & ((1 << idx.dm_bits) - 1)).clamp(0, idx.dm.shape[0] - 1)
        row = _u32(idx.dm[p])  # (..., S + 1)
        meta = row[..., :S]
        base = row[..., S]
        fpm = (1 << fpb) - 1
        fp = (q >> idx.dm_bits) & fpm
        hit = (meta & fpm) == fp.unsqueeze(-1)
        cnts = meta >> fpb
        # distinct keys of a bucket have distinct fps; empty slots (count
        # 0, after every real slot) can also "hit" an fp == 0 query, so
        # the first hit is the real one
        slot = hit.to(torch.int8).argmax(dim=-1, keepdim=True)
        sidx = torch.arange(S, device=q.device)
        before = torch.where(sidx < slot, cnts, 0).sum(dim=-1)
        count = torch.where(hit, cnts, 0).amax(dim=-1)
        start = torch.where(count > 0, base + before, 0)
        return start, count
    if idx.dm_entry == 2:
        # two-phase probe (JAX index_ops.py:480-503): the S metas, the
        # hit slot (distinct keys of a bucket have distinct fps: at most
        # one hit), then one 1-D gather of its start; empty slots carry
        # count 0, already "absent"
        fpb = idx.dm_fp_bits
        p = (q & ((1 << idx.dm_bits) - 1)).clamp(0, idx.dm.shape[0] - 1)
        meta = _u32(idx.dm[p])  # (..., S)
        fpm = (1 << fpb) - 1
        hit = (meta & fpm) == ((q >> idx.dm_bits) & fpm).unsqueeze(-1)
        slot = hit.to(torch.int8).argmax(dim=-1)
        start = torch.where(hit.any(dim=-1), _u32(idx.dm_start[p * S + slot]), 0)
        count = torch.where(hit, meta >> fpb, 0).amax(dim=-1)
        return start, count
    if idx.dm_entry == 4:
        p = (q & ((1 << idx.dm_bits) - 1)).clamp(0, idx.dm.shape[0] - 1)
        rows = _u32(idx.dm[p]).reshape(*q.shape, S, 4)
        hit = (rows[..., 0] == (q >> 32).unsqueeze(-1)) & (
            rows[..., 1] == (q & U32_MASK).unsqueeze(-1)
        )
        start = torch.where(hit, rows[..., 2], 0).amax(dim=-1)
        count = torch.where(hit, rows[..., 3], 0).amax(dim=-1)
        return start, count
    raise ValueError(f"unknown direct-table entry {idx.dm_entry}")
