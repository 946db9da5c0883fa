"""End-to-end host mapping pipeline (the reference-faithful path).

Mirrors the reference align flow (reference src/main.rs:189-230):
sketch query -> occurrence filter -> anchors -> chain DP -> rescue ->
merge -> select -> PAF. This is the guaranteed-parity implementation the
device pipeline is validated against; it also serves as the CPU fallback.
"""

from __future__ import annotations

import numpy as np

from ..config import ChainParams, MapParams
from .index import OracleIndex
from .lchain import (
    chain_dp,
    chain_dp_all,
    merge_adjacent_chains_with_gap,
    rescue_long_join,
    select_and_filter_chains,
)
from .paf import paf_from_chain, write_paf, write_paf_many_with_scores
from .seeds import build_anchors, collect_query_minimizers, filter_query_minimizers


def align_read(
    idx: OracleIndex,
    qname: str,
    qseq: bytes,
    cp: ChainParams,
    mp: MapParams = MapParams(),
    mid_occ: int | None = None,
) -> list[str]:
    """Map one read, returning PAF lines (main.rs:193-219)."""
    mv = collect_query_minimizers(qseq, idx.w, idx.k)
    mv = filter_query_minimizers(mv, mp.q_occ_max, mp.q_occ_frac)
    if mid_occ is None:
        mid_occ = max(idx.calc_mid_occ(mp.frac_top_repetitive), mp.mid_occ_floor)
    anchors = build_anchors(idx, mv, len(qseq), mid_occ)
    chains_all, scores_all = chain_dp_all(anchors, cp)
    if not chains_all:
        chain = chain_dp(anchors, cp)
        rec = paf_from_chain(idx, anchors, chain, qname, qseq)
        return [write_paf(rec)] if rec is not None else []
    chains_resc, scores_resc = rescue_long_join(anchors, chains_all, scores_all, cp, len(qseq))
    chains_merged = merge_adjacent_chains_with_gap(anchors, chains_resc, cp.max_dist_y, cp.max_dist_y)
    # NOTE: the reference passes the pre-merge scores here (main.rs:217);
    # select_and_filter pairs them by list position.
    chains, _scores, _is_pri, s1, s2 = select_and_filter_chains(
        anchors, chains_merged, scores_resc[: len(chains_merged)],
        mp.mask_level, mp.pri_ratio, mp.best_n,
    )
    return write_paf_many_with_scores(idx, anchors, chains, s1, s2, qname, qseq)


def map_reads(
    idx: OracleIndex,
    reads: list[tuple[str, bytes]],
    cp: ChainParams,
    mp: MapParams = MapParams(),
) -> list[str]:
    """Map a batch of reads (generalizes the reference, which maps only
    the first query record — main.rs:92-103,193)."""
    mid_occ = max(idx.calc_mid_occ(mp.frac_top_repetitive), mp.mid_occ_floor)
    out: list[str] = []
    for qname, qseq in reads:
        if len(qseq) == 0:
            continue
        out.extend(align_read(idx, qname, qseq, cp, mp, mid_occ=mid_occ))
    return out
