"""A/B of the short-read chain-DP kernel's compile-time choices on one GPU.

    python3 short_block_ab.py

Builds minimap2_rs_torch/csrc/chain_dp.cu once per variant (one nvcc
each, in parallel, into build/short_ab/; lane_block_ab.build_variants)
and prints each build's ptxas report of the short-read kernels:
  * as built: one warp a read (kShortThreads = 32), four slots a group
    (kShortUnroll = 4);
  * two warps a read joined by a named barrier (kShortThreads = 64);
  * two slots a group (kShortUnroll = 2);
  * the row walk without the scoring (the next row's slots are never
    scored): its outputs are wrong and not compared; it times what the
    walk costs besides the scoring.
It then captures the headline's chain-DP inputs: the 5 Mbp genome of
chip_smoke.py (seed 0) and the first 1024 of its headline reads (seed
1), mapped once on the lite path (both bands: B = 1024, A = 256) and
once at -n 1 -m 10 (the (f, prev) DP and the rescue re-run). On each
captured input, at its own window and at window 128, it times every
variant's short-read entry point in turns (in order, then in reverse;
CUDA events around 10 back-to-back launches into preallocated outputs,
median of 5 each) beside
the warp-per-read template and the bound (chip_smoke._chain_bound);
every output but the cut's must be torch.equal to the plain version.
Needs one CUDA GPU; exits non-zero otherwise or on any mismatch.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke as cs
from lane_block_ab import build_variants, call_entry, with_constants

AS_BUILT = "32 threads, 4 slots a group (as built)"
WALK_ONLY = "walk without scoring (timing only)"
# the next row's scoring, which WALK_ONLY never enters
SCORING = "    if (i + 1 < n) row.score("


def _sources():
    """{variant: source of chain_dp.cu}."""
    from minimap2_rs_torch.kernels import build as kbuild

    src = (kbuild.CSRC / "chain_dp.cu").read_text()
    if src.count(SCORING) != 1:
        raise RuntimeError("chain_dp.cu: the short kernel's scoring not found once")
    return {
        AS_BUILT: src,
        "64 threads": with_constants(src, kShortThreads=64),
        "2 slots a group": with_constants(src, kShortUnroll=2),
        WALK_ONLY: src.replace(SCORING, SCORING.replace("i + 1 < n", "false")),
    }


def _capture(genome, reads):
    """{(variant/shape, bw, A): (args, scalars, window, None)} of one lite
    and one general (-n 1 -m 10) pass over `reads`; and the log2 table."""
    import torch

    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper

    idx = build_index_native([("chrB", genome)], IndexParams())
    captured: dict = {}
    kchain.captured = captured
    try:
        for cp in (ChainParams.defaults_for_k(15),
                   ChainParams.defaults_for_k(15, min_cnt=1, min_chain_score=10)):
            mapper = Mapper.from_oracle_index(idx, cp, MapParams(), device="cuda",
                                              batch_size=1024)
            mapper.map_reads_paf(reads)
        torch.cuda.synchronize()
    finally:
        kchain.captured = None
    return captured, mapper._log2_tab


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("short_block_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops import chain_ops
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    print(cs._nvidia_smi())
    out = Path(__file__).resolve().parent / "build" / "short_ab"
    out.mkdir(parents=True, exist_ok=True)
    libs = build_variants(out, _sources(), "short")
    names = list(libs)
    genome = random_genome(5_000_000, seed=0)
    reads = [(n, s) for n, s, *_ in
             simulate_reads(genome, 16384, read_len=(500, 1000), seed=1)][:1024]
    captured, tab = _capture(genome, reads)
    for (key, bw, A), (args, scal, window, _skip) in sorted(captured.items()):
        if not key.endswith("/static"):
            continue
        aux = key.startswith("chain_dp_aux")
        ref_fn = chain_ops.chain_dp_aux_batch_ref if aux else chain_ops.chain_dp_batch_ref
        for win in (window, 128):
            if kchain.design(A, win, aux, None) != "short":
                raise AssertionError(f"{key} A={A} H={win}: not a short-read shape")
            want = ref_fn(*args, scal, win, tab)
            outs = [torch.empty_like(w) for w in want]
            res: dict = {}
            for order in (names, names[::-1]):
                for name in order:
                    run = lambda: call_entry(libs[name], "short", aux, args, scal, win, tab,
                                             outs)
                    got = run()
                    torch.cuda.synchronize()
                    if name != WALK_ONLY and not all(
                            torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{key} bw={bw} H={win}, {name}: != plain")
                    res.setdefault(name, []).append(cs._time_ms(run, inner=cs.KERNEL_INNER))
            tmpl = cs._time_ms(lambda: kchain.template_batch(aux, *args, scal, win, tab),
                               inner=cs.KERNEL_INNER)
            bound_ms, bound_by, _pairs = cs._chain_bound(args, scal, win, 4 if aux else 2,
                                                         tab, None)
            rows = int(cs._valid_rows(args[0]).max())
            print(f"{key} bw={bw} (B, A)={tuple(args[0].shape)} H={min(win, A)} "
                  f"rows={rows}: "
                  + "; ".join(f"{n} {v[0]:.4f}/{v[1]:.4f} ms" for n, v in res.items())
                  + f"; template {tmpl:.4f} ms; bound {bound_ms:.6f} ms ({bound_by})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
