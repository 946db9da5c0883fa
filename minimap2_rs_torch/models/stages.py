"""Device pipeline stages of the mapping paths, in PyTorch.

Counterpart of minimap2_rs_tpu/models/stages.py: wire unpack -> sketch
-> minimizer compaction (at odd k one kernel from the wire on the card,
kernels/sketch.py; the unpack lives in ops/sketch.py) -> key sort ->
occurrence filter -> index lookup (on an index with no direct table the
prefix-probe kernel on the card, kernels/probe.py) -> anchor expansion
-> chain DP (the CUDA kernel on the card). The lite path goes on to
on-device finalize and 10-word wire rows; the general path's program
(models/mapper.py) returns the anchors and (f, prev).
"""

from __future__ import annotations

import torch

from ..kernels.chain_dp import chain_dp_aux_batch
from ..kernels.probe import probe_prefix
from ..kernels.sketch import sketch_minimizers
from ..ops.chain_ops import ChainScalars
from ..ops.finalize_ops import (
    FIELDS,
    as_i32,
    finalize_from_aux,
    pack_fields_wire,
    wire_packable,
)
from ..ops.index_ops import DeviceIndex
from ..ops.seeds_ops import (
    expand_anchors,
    lookup_keys,
    query_occ_filter,
    sort_minimizers_by_key,
)
from ..ops.sketch import compact_minimizers, sketch_positions, wire_codes


def sketch_compact_filter(codes, lengths, *, w: int, k: int, q_occ_max: int,
                          q_occ_frac: float, M: int, wire: str = "nt4",
                          nex=None) -> dict:
    """Index-independent per-read work: sketch, minimizer compaction,
    key sort, query-occurrence filter (seeds.rs:7-36). Queries are
    always sketched non-HPC (seeds.rs:7-11). `codes` holds the batch as
    `wire` says (ops/sketch.WIRE_CODES): (B, L) nt4 codes, or a map
    program's H2D wire, the 2-bit one with its N list `nex`.

    At odd k the sketch and the compaction are one kernel on the card
    that reads the wire itself (kernels/sketch.py; on the CPU its plain
    version, the chain below); even k unpacks the wire and takes
    sketch_positions' exact scan."""
    if k % 2:
        cks, cps, n_mini, mini_ovf = sketch_minimizers(codes, lengths, nex, wire, w, k, M)
    else:
        ks, ps, emitted = sketch_positions(wire_codes(codes, lengths, nex, wire),
                                           lengths, w, k)
        cks, cps, n_mini, mini_ovf = compact_minimizers(ks, ps, emitted, M)
    sks, sps = sort_minimizers_by_key(cks, cps)
    keep = query_occ_filter(sks, n_mini, q_occ_max, q_occ_frac)
    return dict(sks=sks, sps=sps, keep=keep, cps=cps, n_mini=n_mini,
                mini_ovf=mini_ovf)


def lookup_expand(dev_idx: DeviceIndex, mini: dict, lengths, mid_occ: int,
                  A: int) -> dict:
    """Index lookup + anchor expansion + per-read anchor sort
    (seeds.rs:42-79): probe, then expand."""
    return expand(dev_idx, probe(dev_idx, mini), lengths, mid_occ, A)


def probe(dev_idx: DeviceIndex, mini: dict) -> dict:
    """The index lookup of sketch_compact_filter's minimizers: `mini`
    with each slot's occurrence block, start and count (lookup_keys).

    An index with no direct table takes the prefix-probe kernel on the
    card (kernels/probe.py; on the CPU its plain version,
    ops/index_ops.prefix_probe)."""
    lookup = lookup_keys if dev_idx.dm_slots else probe_prefix
    start, count = lookup(dev_idx, mini["sks"], mini["keep"])
    return dict(mini, start=start, count=count)


def expand(dev_idx: DeviceIndex, mini: dict, lengths, mid_occ: int, A: int) -> dict:
    """Anchor expansion + per-read anchor sort of probed minimizers
    (seeds.rs:48-79)."""
    x_hi, x_lo, y_hi, y_lo, n_anchors, anc_ovf = expand_anchors(
        dev_idx, mini["sks"], mini["sps"], mini["keep"], mini["start"], mini["count"],
        lengths, mid_occ, A,
    )
    return dict(x_hi=x_hi, x_lo=x_lo, y_hi=y_hi, y_lo=y_lo,
                n_anchors=n_anchors, anc_ovf=anc_ovf)


def sketch_to_anchors(dev_idx: DeviceIndex, codes, lengths, mid_occ: int, *,
                      w: int, k: int, q_occ_max: int, q_occ_frac: float,
                      M: int, A: int) -> dict:
    """Per-read minimizers + anchors: sorted anchor words x_hi/x_lo/
    y_hi/y_lo (padding 0xFFFFFFFF), n_anchors, anc_ovf, position-sorted
    minimizer payloads cps (pos<<1|strand), n_mini, mini_ovf."""
    mini = sketch_compact_filter(codes, lengths, w=w, k=k, q_occ_max=q_occ_max,
                                 q_occ_frac=q_occ_frac, M=M)
    anc = lookup_expand(dev_idx, mini, lengths, mid_occ, A)
    anc.update(cps=mini["cps"], n_mini=mini["n_mini"], mini_ovf=mini["mini_ovf"])
    return anc


def chain_inputs(x_hi, x_lo, y_hi, y_lo):
    """Anchor words (uint32 values in int64, or their int32 bits) -> the
    chain DP's contiguous int32 (grp, rpos, qpos, span)."""
    return tuple(
        t.contiguous() for t in (as_i32(x_hi), as_i32(x_lo), as_i32(y_lo),
                                 as_i32(y_hi & 0xFF))
    )


def _win_ovf(x_hi, x_lo, n_anchors, mdx: int, window: int):
    """Exact truncation detector: with anchors sorted by the 64-bit
    x = x_hi<<32|x_lo, a predecessor farther than `window` slots can
    pass max_dist_x (lchain.rs:75) only if x[i-window] >= x[i] - mdx
    (saturating at 0). Compared as (hi, lo) pairs."""
    A = x_hi.shape[1]
    lo = x_lo - mdx
    borrow = lo < 0
    neg = (x_hi == 0) & borrow
    th = torch.where(neg, 0, x_hi - borrow.to(torch.int64))[:, window:]
    tl = torch.where(neg, 0, lo + (borrow.to(torch.int64) << 32))[:, window:]
    ph, pl = x_hi[:, : A - window], x_lo[:, : A - window]
    far = (th < ph) | ((th == ph) & (tl <= pl))
    slot = torch.arange(window, A, device=x_hi.device)
    far = far & (slot[None, :] < n_anchors[:, None])
    return far.any(dim=1)


def chain_finalize_lite(
    anc: dict,
    lengths: torch.Tensor,   # (B,) int32
    scalars: ChainScalars,
    scalars_wide: ChainScalars,
    tlens: torch.Tensor,     # (n_seq,) int32
    rmq_rescue_size: int,
    rmq_rescue_ratio: float,
    *,
    k: int, window: int, log2_tab: torch.Tensor,
    flag_window_ovf: bool = False,
    max_chain_skip: int | None = None,
    wide: bool = True,
) -> torch.Tensor:
    """Chain DP + finalize; returns the wire rows ((B, 10) int32 when
    wire_packable, else the (B, 18) FIELDS rows).

    wide=True (dual band) also runs the bw_long band and switches to it
    for reads whose normal-band rescue flag fired (lchain.rs:321-330);
    the merged row's rescue column keeps the normal band's flag.
    wide=False runs the `scalars` band only. win_ovf is computed per
    band with that band's max_dist_x. max_chain_skip=None scores the
    window exactly; an int runs the reference's pruned DP in both
    bands (JAX stages.py:170-178)."""
    x_hi, x_lo, y_hi, y_lo = anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"]
    n_anchors, cps = anc["n_anchors"], anc["cps"]
    B, A = x_hi.shape
    M = cps.shape[1]
    mini_pos = cps >> 1  # position-sorted; padding stays max
    args = chain_inputs(x_hi, x_lo, y_hi, y_lo)
    fields = []
    for scal in (scalars, scalars_wide) if wide else (scalars,):
        f, cnt, sq, sr = chain_dp_aux_batch(*args, scal, window, log2_tab,
                                            max_chain_skip)
        win_ovf = (
            _win_ovf(x_hi, x_lo, n_anchors, scal.max_dist_x, window)
            if flag_window_ovf and A > window else None
        )
        fields.append(finalize_from_aux(
            f, cnt, sq, sr, x_hi, x_lo, y_lo, n_anchors,
            mini_pos, anc["n_mini"], lengths, tlens, anc["mini_ovf"],
            anc["anc_ovf"], k, rmq_rescue_size, rmq_rescue_ratio,
            win_ovf=win_ovf,
        ))
    pack = pack_fields_wire if wire_packable(A, M) else (lambda x: x)
    if not wide:
        return pack(fields[0])
    ri = FIELDS.index("rescue")
    resc = fields[0][:, ri] != 0
    merged = torch.where(resc[:, None], fields[1], fields[0])
    merged[:, ri] = resc.to(merged.dtype)
    return pack(merged)
