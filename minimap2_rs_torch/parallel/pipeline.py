"""Mapping over a mesh of ranks (torch.distributed collectives).

Counterpart of minimap2_rs_tpu/parallel/pipeline.py. Two modes:

1. *_dp: the index replicated, reads data-parallel over "dp". Each rank
   maps its own rows; nothing is exchanged in the step.
2. *_sharded: the index hash-range-sharded over "ix", reads
   data-parallel over ("dp", "ix"). Each rank sketches its own rows once;
   an all_gather over its ix group gives every shard the dp row's
   minimizers; each rank looks them up against its own key range and
   expands partial anchors; an all_to_all routes each read's anchors from
   every shard back to the rank that sketched it, which chains them.

Each step takes this rank's rows (int32 nt4 codes, lengths) and returns
this rank's rows of what the single-device stages return: the *_lite
steps the wire rows of models/stages.chain_finalize_lite, the others the
anchor dict with the chain DP's f and prev. `statics` holds w, k,
q_occ_max, q_occ_frac, M, A, window (the sharded steps: over the
exchanged n_ix * A slots) and, for the lite steps, flag_window_ovf,
max_chain_skip and wide.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.chain_dp import chain_dp_batch
from ..models.stages import (
    chain_finalize_lite,
    chain_inputs,
    lookup_expand,
    sketch_compact_filter,
    sketch_to_anchors,
)
from ..ops.chain_ops import ChainScalars
from ..ops.finalize_ops import as_i32
from ..ops.index_ops import _u32
from ..ops.seeds_ops import _sort_rows_by
from .mesh import Mesh
from .sharded_index import ShardedDeviceIndex

_ANCHOR_WORDS = ("x_hi", "x_lo", "y_hi", "y_lo")


def _core(statics: dict) -> dict:
    return {kk: statics[kk] for kk in ("w", "k", "q_occ_max", "q_occ_frac", "M")}


def _exchange_anchors(anc: dict, mesh: Mesh) -> dict:
    """Route each read's partial anchors from every index shard to the
    rank that sketched it (JAX :72-93): (B_row, A) --all_to_all over
    ix--> (B_loc, n_ix * A), the words as their int32 bits; n_anchors
    summed and anc_ovf OR'd over the shards; then the 4-key sort of the
    concatenated slots. The words are uint32 values in int64, so the
    0xFFFFFFFF padding sorts last, as in the reference's (x, y) anchor
    order (seeds.rs:58)."""
    n_ix = mesh.ix
    B_row, A = anc["x_hi"].shape
    B_loc = B_row // n_ix

    def ex(t):  # (B_row, ...) -> (n_ix, B_loc, ...), block i from ix rank i
        return mesh.all_to_all(t, "ix").reshape(n_ix, B_loc, *t.shape[1:])

    out = dict(anc)
    planes = ex(torch.stack([as_i32(anc[c]) for c in _ANCHOR_WORDS], dim=1))
    planes = _u32(planes).permute(2, 1, 0, 3).reshape(4, B_loc, n_ix * A)
    flags = ex(torch.stack([anc["n_anchors"].to(torch.int32),
                            anc["anc_ovf"].to(torch.int32)], dim=1))
    out["n_anchors"] = flags[:, :, 0].sum(dim=0, dtype=torch.int32)
    out["anc_ovf"] = flags[:, :, 1].amax(dim=0) != 0
    words, _ = _sort_rows_by(list(planes.unbind(0)), [])
    out.update(zip(_ANCHOR_WORDS, words))
    return out


def _sharded_anchors(sidx: ShardedDeviceIndex, codes, lengths, mid_occ: int,
                     statics: dict, mesh: Mesh) -> dict:
    """The sharded front half (JAX :96-128): sketch, compact and filter
    this rank's reads once; all_gather the minimizer payloads (keys as
    int64, positions as int32 bits, the keep mask as bytes) and the
    lengths over ix; look the dp row up against this rank's shard; send
    the partial anchors home. The per-read payloads stay local."""
    mini = sketch_compact_filter(codes, lengths, **_core(statics))
    n_ix = mesh.ix
    if n_ix > 1:
        row = {
            "sks": mesh.all_gather(mini["sks"], "ix"),
            "sps": _u32(mesh.all_gather(as_i32(mini["sps"]), "ix")),
            "keep": mesh.all_gather(mini["keep"].to(torch.uint8), "ix") != 0,
        }
        row_lengths = mesh.all_gather(lengths, "ix")
    else:
        row, row_lengths = mini, lengths
    anc = lookup_expand(sidx.local(), row, row_lengths, mid_occ, statics["A"])
    if n_ix > 1:
        anc = _exchange_anchors(anc, mesh)
    anc.update(cps=mini["cps"], n_mini=mini["n_mini"], mini_ovf=mini["mini_ovf"])
    return anc


def _chain(anc: dict, scalars: ChainScalars, window: int, log2_tab) -> dict:
    f, prev = chain_dp_batch(*chain_inputs(*(anc[c] for c in _ANCHOR_WORDS)),
                             scalars, window, log2_tab)
    return {**anc, "f": f, "prev": prev}


def _lite(anc: dict, lengths, scalars, scalars_wide, tlens, rmq_rescue_size: int,
          rmq_rescue_ratio: float, log2_tab, statics: dict) -> torch.Tensor:
    return chain_finalize_lite(
        anc, lengths, scalars, scalars_wide, tlens, rmq_rescue_size, rmq_rescue_ratio,
        k=statics["k"], window=statics["window"], log2_tab=log2_tab,
        flag_window_ovf=statics.get("flag_window_ovf", False),
        max_chain_skip=statics.get("max_chain_skip"), wide=statics.get("wide", True),
    )


# ---------------------------------------------------------------------
# chain-score steps (general path: the host backtracks from f/prev)
# ---------------------------------------------------------------------

def map_batch_dp(dev_idx, codes, lengths, scalars: ChainScalars, mid_occ: int,
                 statics: dict, log2_tab) -> dict:
    """Data-parallel step (JAX make_map_batch_dp, :135) on this rank's
    rows against the replicated index: the anchors and (f, prev)."""
    anc = sketch_to_anchors(dev_idx, codes, lengths, mid_occ, **_core(statics),
                            A=statics["A"])
    return _chain(anc, scalars, statics["window"], log2_tab)


def map_batch_sharded(mesh: Mesh, sidx: ShardedDeviceIndex, codes, lengths,
                      scalars: ChainScalars, mid_occ: int, statics: dict,
                      log2_tab) -> dict:
    """Sharded-index step (JAX make_map_batch_sharded, :154) on this
    rank's rows: (B_loc, n_ix * A) anchors and (f, prev). The batch must
    split over dp * ix."""
    anc = _sharded_anchors(sidx, codes, lengths, mid_occ, statics, mesh)
    return _chain(anc, scalars, statics["window"], log2_tab)


# ---------------------------------------------------------------------
# lite steps (the whole pipeline on the ranks: wire rows out)
# ---------------------------------------------------------------------

def map_batch_dp_lite(dev_idx, codes, lengths, scalars, scalars_wide, mid_occ: int,
                      tlens, rmq_rescue_size: int, rmq_rescue_ratio: float, log2_tab,
                      statics: dict) -> torch.Tensor:
    """Data-parallel lite step (JAX make_map_batch_dp_lite, :188): this
    rank's wire rows."""
    anc = sketch_to_anchors(dev_idx, codes, lengths, mid_occ, **_core(statics),
                            A=statics["A"])
    return _lite(anc, lengths, scalars, scalars_wide, tlens, rmq_rescue_size,
                 rmq_rescue_ratio, log2_tab, statics)


def map_batch_sharded_lite(mesh: Mesh, sidx: ShardedDeviceIndex, codes, lengths,
                           scalars, scalars_wide, mid_occ: int, tlens,
                           rmq_rescue_size: int, rmq_rescue_ratio: float, log2_tab,
                           statics: dict) -> torch.Tensor:
    """Sharded lite step (JAX make_map_batch_sharded_lite, :231): this
    rank's wire rows, chained and finalized over the exchanged n_ix * A
    slots (statics["window"] applies to that total)."""
    anc = _sharded_anchors(sidx, codes, lengths, mid_occ, statics, mesh)
    return _lite(anc, lengths, scalars, scalars_wide, tlens, rmq_rescue_size,
                 rmq_rescue_ratio, log2_tab, statics)


def sharded_payload_bytes(statics: dict, B_row: int, n_ix: int) -> dict:
    """The collective bytes one rank sends in one sharded call (JAX
    :210-228), from the shapes: the minimizer all_gather sends its
    (B_loc, M) payloads (an 8-byte key, a 4-byte position, a keep byte)
    to the n_ix - 1 other ranks of its dp row; the anchor all_to_all
    sends (n_ix - 1) / n_ix of its 4 int32 planes of (B_row, A). The
    lengths and per-read flags that ride along are not counted."""
    M, A = statics["M"], statics["A"]
    B_loc = max(B_row // n_ix, 1)
    gather_sent = B_loc * M * (8 + 4 + 1) * max(n_ix - 1, 0)
    a2a_sent = B_row * A * 4 * 4 * (n_ix - 1) // max(n_ix, 1)
    return {
        "minimizer_all_gather_bytes_per_rank": gather_sent,
        "anchor_all_to_all_bytes_per_rank": a2a_sent,
        "total_collective_bytes_per_rank": gather_sent + a2a_sent,
        "reads_per_row": B_row,
        "collective_bytes_per_read": round((gather_sent + a2a_sent) / max(B_row, 1), 1),
    }


# ---------------------------------------------------------------------
# collective index statistics (index.rs:111-141)
# ---------------------------------------------------------------------

def _local_counts(sidx: ShardedDeviceIndex) -> torch.Tensor:
    """This rank's per-key occurrence counts (padding rows carry 0)."""
    return sidx.local().kv[:, 3].to(torch.int64)


def index_stats_allreduce(mesh: Mesh, sidx: ShardedDeviceIndex) -> tuple[int, int]:
    """Global (n_keys, n_positions), summed over the ix shards (JAX
    index_stats_psum, :263)."""
    c = _local_counts(sidx)
    local = torch.stack([(c > 0).sum(), c.sum()])
    nk, npos = mesh.all_reduce(local, "ix").tolist()
    return int(nk), int(npos)


def calc_mid_occ_allreduce(mesh: Mesh, sidx: ShardedDeviceIndex, frac: float) -> int:
    """The repetitive-seed cutoff (the occurrence-count quantile + 1,
    index.rs:124-141) as collectives (JAX calc_mid_occ_psum, :281): a
    31-step binary search over count values, one all_reduce of the
    global rank of the probe a step; no shard ships its counts. The
    quantile's rank is computed in float32, as the JAX package does."""
    c = _local_counts(sidx)
    valid = c > 0
    n = int(mesh.all_reduce(valid.sum(), "ix"))
    idx = min(int((np.float32(1.0) - np.float32(frac)) * np.float32(n)), n - 1)
    target = idx + 1  # need #(counts <= v) >= target
    lo, hi = 1, 2**31 - 1
    for _ in range(31):
        mid = lo + ((hi - lo) >> 1)
        rank = int(mesh.all_reduce((valid & (c <= mid)).sum(), "ix"))
        lo, hi = (lo, mid) if rank >= target else (mid + 1, hi)
    return hi + 1 if n > 0 else 2**31 - 1
