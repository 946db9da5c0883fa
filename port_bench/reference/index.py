"""The reference's index, worked out again from the genome's bases.

Every minimizer of every sequence is found a chunk at a time on the
device given (reference/sketch.genome_minimizers). All their keys give
the occurrence counts and so `mid_occ`, the count at the
(1 - frac_top_repetitive) quantile of the distinct keys, plus one, and
at least mid_occ_floor (index.rs:124-141, main.rs:196-197). Only the
occurrences of the keys asked for (those of the reads being judged) are
kept, as flat arrays sorted by key and, within a key, by position
(index.rs:98).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .sketch import genome_minimizers


@dataclasses.dataclass
class RefIndex:
    w: int
    k: int
    names: list[str]
    lengths: list[int]
    mid_occ: int
    n_keys: int        # distinct keys in the genome
    n_positions: int   # minimizers in the genome
    keys: np.ndarray       # uint64, sorted distinct keys asked for and found
    starts: np.ndarray     # int64
    counts: np.ndarray     # int64, each key's occurrences in the whole genome
    positions: np.ndarray  # uint64 rid << 32 | pos << 1 | strand


def build_index(names: list[str], lengths: list[int],
                fetch: Callable[[int, int, int], torch.Tensor], w: int, k: int,
                want: np.ndarray, frac_top_repetitive: float, mid_occ_floor: int,
                device, chunk: int = 1 << 26) -> RefIndex:
    """fetch(rid, lo, hi): the int64 base codes of sequence rid at
    [lo, hi) on `device`. want: the uint64 keys whose occurrences to keep."""
    key_dtype = torch.int32 if 2 * k <= 31 else torch.int64
    want_t = torch.from_numpy(np.unique(want).astype(np.int64)).to(device)
    all_keys: list[torch.Tensor] = []
    got_k: list[np.ndarray] = []
    got_p: list[np.ndarray] = []
    for rid, n in enumerate(lengths):
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            lo, hi = max(a - w - k, 0), min(b + w, n)
            key, rps = genome_minimizers(fetch(rid, lo, hi), lo, n, (a, b), w, k)
            all_keys.append(key.to(key_dtype))
            hit = torch.isin(key, want_t)
            got_k.append(key[hit].cpu().numpy())
            got_p.append(((rps[hit] | (rid << 32))).cpu().numpy())
            del key, rps, hit
    allk = torch.cat(all_keys) if all_keys else torch.zeros(0, dtype=key_dtype, device=device)
    del all_keys
    n_positions = int(allk.shape[0])
    srt = torch.sort(allk).values
    del allk
    if n_positions:
        edge = torch.ones(n_positions + 1, dtype=torch.bool, device=srt.device)
        edge[1:-1] = srt[1:] != srt[:-1]
        del srt
        bounds = torch.nonzero(edge).flatten()
        counts = torch.sort(bounds[1:] - bounds[:-1]).values
        n_keys = int(counts.shape[0])
        mid = int(counts[min(int((1.0 - float(frac_top_repetitive)) * n_keys), n_keys - 1)]) + 1
        del edge, bounds, counts
    else:
        n_keys, mid = 0, np.iinfo(np.int32).max
    mk = np.concatenate(got_k).astype(np.uint64) if got_k else np.zeros(0, np.uint64)
    mp = np.concatenate(got_p).astype(np.uint64) if got_p else np.zeros(0, np.uint64)
    order = np.lexsort((mp, mk))
    mk, mp = mk[order], mp[order]
    first = np.ones(mk.shape[0], dtype=bool)
    first[1:] = mk[1:] != mk[:-1]
    starts = np.nonzero(first)[0].astype(np.int64)
    return RefIndex(
        w=w, k=k, names=list(names), lengths=list(lengths),
        mid_occ=max(mid, mid_occ_floor), n_keys=n_keys, n_positions=n_positions,
        keys=mk[starts], starts=starts,
        counts=np.diff(np.append(starts, mk.shape[0])).astype(np.int64), positions=mp,
    )
