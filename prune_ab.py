"""A/B of two shortcuts in the pruned chain-DP kernel, on one GPU.

    python3 prune_ab.py

Builds minimap2_rs_torch/csrc/chain_dp.cu twice (one nvcc each, in
parallel, into build/prune_ab/; lane_block_ab.build_variants) and prints
each build's ptxas report of the pruned kernel:
  * as built: every chunk of 32 slots runs both warp scans;
  * with the shortcuts: two warp votes a chunk, so that a chunk with no
    admissible slot is skipped and a chunk where no slot can beat counts
    its marks by a popcount of a ballot, without the scans.
It captures the skipprune inputs of chip_smoke.py (the 5 Mbp genome,
seed 0, and its first 128 headline reads, seed 1, mapped with
MM2T_SKIP_PRUNE=1 on the lite path and at -n 1 -m 10, batch 128:
B = 128, A = 256, both bands) and adds two synthetic inputs of
chip_smoke.py at max_chain_skip 25: decoy clusters at B = 1, A = 1152
(the CLI's shape) and colinear runs at B = 128, A = 256 (few admissible
slots, so rows walk their whole window). On each it times both variants'
pruned entry points in turns (as built, with, with, as built; CUDA
events around 10 back-to-back launches into preallocated outputs, median
of 5 each) beside the template's pruned instance and the bound
(chip_smoke._chain_bound); every output must be torch.equal to the
plain version. Needs one CUDA GPU; exits non-zero otherwise or on any
mismatch.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import chip_smoke as cs
from lane_block_ab import build_variants, call_entry

AS_BUILT = "as built"
WITH_SHORTCUTS = "with the shortcuts"
# the part of a chunk's step after the marks, as built ...
STEP_FROM = "      __syncwarp();\n      const bool counted = ok && s_t[j] == i;"
STEP_TO = "      if (over) break;\n      skip = __shfl_sync(kFull, counter, 31);"
# ... and with the two shortcuts
SHORTCUT_STEP = """      // two votes, issued together: a chunk with no admissible slot
      // scores, marks and counts nothing; one where no slot scores above
      // the carried best has no beat
      const unsigned oks = __ballot_sync(kFull, ok);
      const bool can_beat = __any_sync(kFull, ok && sc > best);
      if (oks == 0) continue;
      __syncwarp();
      const bool counted = ok && s_t[j] == i;  // a marked slot, unless it beats
      int counter;
      if (can_beat) {
        // the running max before each lane: an inclusive max-scan, shifted
        int run = sc;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, run, o);
          if (lane >= o) run = max(run, u);
        }
        const int before = __shfl_up_sync(kFull, run, 1);
        const bool beat = ok && sc > (lane == 0 ? best : max(best, before));
        // the skip counter: (a, b) of n -> max(n + a, b), composed with
        // the older lanes' map applied first
        int a = beat ? -1 : (counted ? 1 : 0);
        int bb = beat ? 0 : kNegInf;
        for (int o = 1; o < 32; o <<= 1) {
          const int ua = __shfl_up_sync(kFull, a, o);
          const int ub = __shfl_up_sync(kFull, bb, o);
          if (lane >= o) {
            bb = max(ub + a, bb);
            a += ua;
          }
        }
        counter = max(skip + a, bb);
      } else {
        // no beat: the counter climbs by one a marked slot
        counter = skip + __popc(__ballot_sync(kFull, counted) & ((2u << lane) - 1));
      }
      const unsigned over = __ballot_sync(kFull, counter > max_skip);
      if (can_beat) {
        const int brk = over ? __ffs(over) - 1 : 32;  // a marked non-beat
        const int cand = ok && lane < brk ? sc : kNegInf;
        const int m = __reduce_max_sync(kFull, cand);
        if (m > best) {
          best = m;
          jb = top - (__ffs(__ballot_sync(kFull, cand == m)) - 1);
        }
      }
"""


def _sources():
    """{variant: source of chain_dp.cu}."""
    from minimap2_rs_torch.kernels import build as kbuild

    src = (kbuild.CSRC / "chain_dp.cu").read_text()
    if src.count(STEP_FROM) != 1 or src.count(STEP_TO) != 1:
        raise RuntimeError("chain_dp.cu: the pruned kernel's chunk step not found once")
    a, b = src.index(STEP_FROM), src.index(STEP_TO)
    return {AS_BUILT: src, WITH_SHORTCUTS: src[:a] + SHORTCUT_STEP + src[b:]}


def _inputs():
    """[(name, aux, args, scalars, window, max_chain_skip)] on the card,
    and the log2 table."""
    import numpy as np
    import torch

    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.ops import chain_ops
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    genome = random_genome(5_000_000, seed=0)
    reads = [(n, s) for n, s, *_ in
             simulate_reads(genome, 16384, read_len=(500, 1000), seed=1)][:128]
    idx = build_index_native([("chrB", genome)], IndexParams())
    captured: dict = {}
    kchain.captured = captured
    os.environ["MM2T_SKIP_PRUNE"] = "1"
    try:
        for cp in (ChainParams.defaults_for_k(15),
                   ChainParams.defaults_for_k(15, min_cnt=1, min_chain_score=10)):
            mapper = Mapper.from_oracle_index(idx, cp, MapParams(), device="cuda",
                                              batch_size=128)
            mapper.map_reads_paf(reads)
        torch.cuda.synchronize()
    finally:
        kchain.captured = None
        del os.environ["MM2T_SKIP_PRUNE"]
    out = [(f"{key} bw={bw}", key.startswith("chain_dp_aux"), args, scal, window, skip)
           for (key, bw, _A), (args, scal, window, skip) in sorted(captured.items())]
    scal = chain_ops.chain_scalars_from_params(ChainParams.defaults_for_k(15))
    dev = torch.device("cuda")
    to_dev = lambda cols: tuple(
        torch.from_numpy(c.astype(np.uint32).view(np.int32).copy()).to(dev) for c in cols)
    for name, cols in (
            ("decoys (B=1, A=1152)",
             cs._synthetic_decoys(np.random.default_rng(7), 1, 40, boosters=1, A=1152)),
            ("colinear runs (B=128, A=256)",
             cs._synthetic_chains(np.random.default_rng(5), 128, 256, lambda b: 256 - b))):
        for aux in (True, False):
            out.append((name, aux, to_dev(cols), scal, 5000, 25))
    return out, mapper._log2_tab


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prune_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops import chain_ops

    print(cs._nvidia_smi())
    out = Path(__file__).resolve().parent / "build" / "prune_ab"
    out.mkdir(parents=True, exist_ok=True)
    libs = build_variants(out, _sources(), "prune_smem")
    names = list(libs)
    inputs, tab = _inputs()
    for name, aux, args, scal, win, skip in inputs:
        ref_fn = chain_ops.chain_dp_aux_batch_ref if aux else chain_ops.chain_dp_batch_ref
        want = ref_fn(*args, scal, win, tab, max_chain_skip=skip)
        outs = [torch.empty_like(w) for w in want]
        res: dict = {}
        for order in (names, names[::-1]):
            for v in order:
                run = lambda: call_entry(libs[v], "prune_smem", aux, args, scal, win, tab,
                                         outs, skip)
                got = run()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name} aux={aux}, {v}: != plain")
                res.setdefault(v, []).append(cs._time_ms(run, inner=cs.KERNEL_INNER))
        tmpl = cs._time_ms(lambda: kchain.template_batch(aux, *args, scal, win, tab, skip),
                           inner=cs.KERNEL_INNER)
        bound_ms, bound_by, pairs = cs._chain_bound(args, scal, win, 4 if aux else 2, tab,
                                                    skip)
        rows = int(cs._valid_rows(args[0]).max())
        print(f"{name} aux={aux} (B, A)={tuple(args[0].shape)} H={min(win, args[0].shape[1])} "
              f"rows={rows} pairs walked={pairs}: "
              + "; ".join(f"{v} {t[0]:.4f}/{t[1]:.4f} ms" for v, t in res.items())
              + f"; template {tmpl:.4f} ms; bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
