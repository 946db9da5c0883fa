"""The hash-range-sharded minimizer index.

Counterpart of minimap2_rs_tpu/parallel/sharded_index.py (:33,108-198).
The flat sorted key table is split into contiguous equal-count ranges,
one per rank of the mesh's "ix" axis. Every key lives in exactly one
shard's sorted slice, so a local lookup finds it or misses, with no
boundary bookkeeping.

Each shard has its padded (U_loc + S, 4) key table, its prefix table,
its (2, P_loc) position planes (rid, pos<<1|strand) relative to the
shard's first position, and a direct-mapped table at ONE (p, S, entry)
layout chosen over every slice, so the tables match the JAX package's
byte for byte. The compact entry (2) keeps its two-phase form here: the
planner of a single card would fuse it, a shard's start plane stays
relative to the shard's first position (p_lo).

The sizes and the layout are chosen from every slice's keys, starts and
counts; a rank fills the host tables of its own shard only and places
them on its device (`local`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.index_ops import (
    _MAX_PREFIX_BITS,
    DeviceIndex,
    _t32,
    choose_direct_layout,
    fill_direct_table,
)


@dataclasses.dataclass
class ShardedDeviceIndex:
    """One rank's shard: its host tables, each the JAX
    ShardedDeviceIndex's stacked array at that shard, and the same
    tables on its device (`local`)."""

    kv: np.ndarray        # (U_loc + S, 4) uint32 [key_hi, key_lo, start, count]
    pos: np.ndarray       # (2, P_loc) uint32 planes [rid], [pos<<1|strand]
    prefix: np.ndarray    # (2^bits + 1,) int32 prefix lower bounds
    dm: np.ndarray        # (2^dm_bits, entry*S) (entry 4) or (2^dm_bits, S) metas (entry 2)
    dm_start: np.ndarray | None  # (2^dm_bits * S,) start plane (entry 2)
    prefix_shift: int
    bucket_slots: int
    n_keys_local: int     # padded rows per shard
    dm_bits: int
    dm_slots: int
    dm_entry: int
    dm_fp_bits: int
    n_shards: int
    rank: int             # the shard this rank holds
    device: torch.device
    _local: DeviceIndex | None = None

    def local(self) -> DeviceIndex:
        """This rank's shard as a DeviceIndex on its device (JAX
        ShardedDeviceIndex.local, :94-105): the full kv and prefix tables,
        the (2, P_loc) position planes, no packed plane."""
        if self._local is None:
            dev = self.device
            self._local = DeviceIndex(
                kv=_t32(self.kv, dev), pos=_t32(self.pos, dev),
                prefix=torch.from_numpy(self.prefix).to(dev),
                dm=_t32(self.dm, dev), seq_cum=None,
                dm_start=_t32(self.dm_start, dev) if self.dm_start is not None else None,
                prefix_shift=self.prefix_shift, bucket_slots=self.bucket_slots,
                n_keys=self.n_keys_local, dm_bits=self.dm_bits, dm_slots=self.dm_slots,
                dm_entry=self.dm_entry, dm_fp_bits=self.dm_fp_bits,
            )
        return self._local

    @staticmethod
    def from_host(keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                  positions: np.ndarray, n_shards: int, key_bits: int = 56, *,
                  rank: int, device) -> "ShardedDeviceIndex":
        """Split the flat host arrays into n_shards contiguous key ranges,
        padded to uniform per-shard sizes (padding keys are U64-max, so
        every lookup misses them), and fill shard `rank`'s tables; JAX
        sharded_index.py:108-198."""
        if not 0 <= rank < n_shards:
            raise ValueError(f"rank {rank} holds no shard of {n_shards}")
        U = keys.shape[0]
        bounds = [round(s * U / n_shards) for s in range(n_shards + 1)]
        u_loc = max(max((bounds[s + 1] - bounds[s] for s in range(n_shards)), default=0), 1)
        p_loc = 1
        slices = []
        for s in range(n_shards):
            lo_k, hi_k = bounds[s], bounds[s + 1]
            if hi_k > lo_k:
                p_lo = int(starts[lo_k])
                p_hi = int(starts[hi_k - 1] + counts[hi_k - 1])
            else:
                p_lo = p_hi = 0
            slices.append((lo_k, hi_k, p_lo, p_hi))
            p_loc = max(p_loc, p_hi - p_lo)

        prefix_bits = max(12, int(np.ceil(np.log2(u_loc + 1))) + 4)
        prefix_bits = min(prefix_bits, _MAX_PREFIX_BITS, key_bits)
        shift = max(0, key_bits - prefix_bits)
        T = (1 << prefix_bits) + 1
        lo_k, hi_k, p_lo, p_hi = slices[rank]
        maxb = 1
        for s, (a, b, _pl, _ph) in enumerate(slices):
            hist = np.bincount((keys[a:b] >> np.uint64(shift)).astype(np.int64),
                               minlength=T - 1)
            if s == rank:
                ptab = np.zeros(T, dtype=np.int32)
                np.cumsum(hist, out=ptab[1:])
            if b > a:
                maxb = max(maxb, int(hist.max()))
        S = 4
        while S < maxb:
            S *= 2

        kv = np.full((u_loc + S, 4), 0xFFFFFFFF, dtype=np.uint32)
        kv[:, 3] = 0
        pos = np.zeros((2, p_loc), dtype=np.uint32)
        n = hi_k - lo_k
        if n:
            kslice = keys[lo_k:hi_k]
            kv[:n, 0] = (kslice >> np.uint64(32)).astype(np.uint32)
            kv[:n, 1] = (kslice & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            kv[:n, 2] = (starts[lo_k:hi_k] - p_lo).astype(np.uint32)
            kv[:n, 3] = counts[lo_k:hi_k].astype(np.uint32)
            m = p_hi - p_lo
            pos[0, :m] = (positions[p_lo:p_hi] >> np.uint64(32)).astype(np.uint32)
            pos[1, :m] = (positions[p_lo:p_hi] & np.uint64(0xFFFFFFFF)).astype(np.uint32)

        # one direct-mapped layout for every shard; S covers the worst
        # shard, and the byte cap bounds one table (a rank holds one)
        layout = choose_direct_layout(
            [keys[a:b] for (a, b, _pl, _ph) in slices],
            key_bits, int(counts.max()) if U else 0,
        )
        if layout is not None:
            dm_p, dm_S, dm_entry = layout
            # dm_start: the entry-2 start plane, else None
            dm, dm_start = fill_direct_table(keys[lo_k:hi_k], starts[lo_k:hi_k] - p_lo,
                                             counts[lo_k:hi_k], key_bits, dm_p, dm_S,
                                             dm_entry)
        else:
            dm_p = dm_S = 0
            dm_entry = 4
            dm, dm_start = np.zeros((0, 4), dtype=np.uint32), None
        return ShardedDeviceIndex(
            kv=kv, pos=pos, prefix=ptab, dm=dm, dm_start=dm_start,
            prefix_shift=shift, bucket_slots=S, n_keys_local=u_loc,
            dm_bits=dm_p, dm_slots=dm_S, dm_entry=dm_entry,
            dm_fp_bits=max(0, key_bits - dm_p), n_shards=n_shards, rank=rank,
            device=torch.device(device),
        )
