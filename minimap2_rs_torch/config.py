"""Configuration dataclasses for the mapping pipeline.

Every numeric constant of the reference is lifted here (SURVEY.md section 5
notes several knobs are hard-coded at call sites in the reference):

- chaining defaults: reference src/main.rs:105-123
- query-minimizer filter (10, 0.01):   main.rs:195
- mid_occ floor of 10:                 main.rs:197
- bucket bits b=14 on the align path:  main.rs:192
- mapq hard-coded to 60:               reference src/paf.rs:213
- presets:                             main.rs:125-133
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Parameters for index construction (main.rs:20-32)."""

    w: int = 10          # minimizer window
    k: int = 15          # k-mer size (1..28, sketch.rs:32)
    bucket_bits: int = 14  # b: number of low key bits selecting a bucket
    flag: int = 0        # bit0 = HPC (index.rs:441)

    @property
    def is_hpc(self) -> bool:
        return bool(self.flag & 1)


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """Chaining DP parameters (lchain.rs:37-52, defaults main.rs:105-123)."""

    max_dist_x: int = 5000
    max_dist_y: int = 5000
    bw: int = 500
    max_chain_iter: int = 5000
    min_chain_score: int = 40
    min_cnt: int = 3
    chn_pen_gap: float = 0.01 * 0.8 * 15  # 0.01*chain_gap_scale*k, main.rs:106-107
    chn_pen_skip: float = 0.0
    max_chain_skip: int = 25
    max_drop: int = 500
    bw_long: int = 20000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1

    @staticmethod
    def defaults_for_k(k: int, **overrides) -> "ChainParams":
        """Reference default_chain_params(k) (main.rs:105-123)."""
        base = dict(chn_pen_gap=0.01 * 0.8 * float(k))
        base.update(overrides)
        return ChainParams(**base)


@dataclasses.dataclass(frozen=True)
class MapParams:
    """Per-run mapping parameters (main.rs:55-89 Align flags + hidden knobs)."""

    q_occ_max: int = 10        # query minimizer occ cap (main.rs:195)
    q_occ_frac: float = 0.01   # query minimizer occ fraction (main.rs:195)
    frac_top_repetitive: float = 2e-4  # -f (main.rs:66-67)
    mid_occ_floor: int = 10    # clamp (main.rs:196-197)
    mask_level: float = 0.5    # -M (main.rs:76-77)
    pri_ratio: float = 0.8     # -p (main.rs:78-79)
    best_n: int = 5            # -N (main.rs:80-81)
    mapq: int = 60             # hard-coded (paf.rs:213)


PRESETS = {
    # main.rs:125-133 — presets set (k, w) only.
    "map-ont": dict(k=15, w=10),
    "map-hifi": dict(k=19, w=10),
    "lr:hq": dict(k=19, w=10),
    "sr": dict(k=21, w=11),
}


def apply_preset(preset: str, w: int, k: int) -> tuple[int, int]:
    """Return (w, k) after applying a preset; unknown presets are no-ops
    (main.rs:125-133)."""
    p = PRESETS.get(preset)
    if p is None:
        return w, k
    return p["w"], p["k"]
