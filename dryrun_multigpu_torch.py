"""Dry run of the PyTorch port's multi-GPU mapper over N ranks.

    python3 dryrun_multigpu_torch.py              # 8 gloo ranks on the CPU
    python3 dryrun_multigpu_torch.py --ranks 4

The port's counterpart of __graft_entry__.py's entry() (:36) and
dryrun_multichip() (:61), and of multihost_dryrun.py: in torch every
rank is a process, so one script covers both. N must be even. It checks:

  0. entry: the single-device general program (models/mapper
     _fused_map_stage) on the tiny problem (6 kb genome, k=11, w=5)
     finds anchors;
  1. on N spawned gloo ranks (minimap2_rs_torch.parallel.ranks.spawn,
     a FileStore under build/dryrun/), ranks.step_checks: the dp step on
     an (N, 1) mesh and the sharded step on an (N/2, 2) mesh agree on
     anchor counts and chain scores for the reads neither overflows;
  2. the collective index statistics and the occurrence quantile equal
     the oracle's;
  3. ranks.mesh_map: MeshMapper with the index replicated (N, 1) and
     sharded (N/2, 2), byte-identical to the host oracle on the tiny
     problem's reads;
  4. the realistic regime: a 1 Mbp genome (seed 42) at k=15, w=10, 368
     reads of 500-1000 bp and 16 chimeras at 40 anchor slots a kb, so
     the 4x tier and the wide band fire on the mesh; both modes
     byte-identical to the oracle;
  5. the lane-shape regime: an 8 kb bucket (A = 1536), 2N reads of
     5-8 kb and 4 long chimeras; the lazy wide pass fires; both modes
     byte-identical to the oracle.

Every rank runs the port only (torch, no jax); the oracle runs in the
parent process.
Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _tiny_problem(w=5, k=11, n_reads=8, genome_len=6000, L=128, seed=0):
    from minimap2_rs_torch.config import ChainParams, IndexParams
    from minimap2_rs_torch.oracle.index import build_index
    from minimap2_rs_torch.utils.packing import nt4_encode
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    genome = random_genome(genome_len, seed=seed)
    idx = build_index([("chrT", genome)], IndexParams(w=w, k=k))
    reads = simulate_reads(genome, n_reads, read_len=(80, L - 8), seed=seed + 1)
    codes = np.full((n_reads, L), 4, dtype=np.int32)
    lengths = np.zeros(n_reads, dtype=np.int32)
    for i, (_, s, *_r) in enumerate(reads):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    cp = ChainParams.defaults_for_k(k)
    return genome, idx, codes, lengths, cp, dict(
        w=w, k=k, q_occ_max=10, q_occ_frac=0.01, M=64, A=128, window=128
    )


def entry() -> None:
    """The single-device general program on the tiny problem (CPU)."""
    import torch

    from minimap2_rs_torch.models.mapper import _fused_map_stage, _unpack_map_stage
    from minimap2_rs_torch.ops.chain_ops import chain_scalars_from_params, log2_table
    from minimap2_rs_torch.ops.index_ops import DeviceIndex

    _g, idx, codes, lengths, cp, st = _tiny_problem()
    dev_idx = DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                    key_bits=2 * idx.k, device="cpu")
    out = _fused_map_stage(
        torch.from_numpy(codes), torch.from_numpy(lengths), torch.zeros(1),
        dev_idx=dev_idx, scalars=chain_scalars_from_params(cp),
        mid_occ=max(idx.calc_mid_occ(2e-4), 10), log2_tab=log2_table(cp.bw + 1),
        w=st["w"], k=st["k"], q_occ_max=st["q_occ_max"], q_occ_frac=st["q_occ_frac"],
        M=st["M"], A=st["A"], window=st["window"], wire="codes",
    )
    unpacked = _unpack_map_stage(out.numpy(), M=st["M"], A=st["A"])
    _check(int(unpacked["n_anchors"].sum()) > 0, "entry: no anchor")
    print("entry: the single-device program found "
          f"{int(unpacked['n_anchors'].sum())} anchors")


def _check_runs(res, runs, want: dict) -> None:
    for run in runs:
        blobs = [r[run["name"]]["blob"] for r in res]
        if any(b != blobs[0] for b in blobs):
            raise AssertionError(f"{run['name']}: the ranks disagree")
        got = blobs[0].decode().split("\n")[:-1] if blobs[0] else []
        host = want[run["name"]]
        if got != host:
            first = next((f"{d!r} != {h!r}" for d, h in zip(got, host) if d != h),
                         f"line counts {len(got)} vs {len(host)}")
            raise AssertionError(f"{run['name']} mismatch: {first}")
        print(f"{run['name']}: {len(got)} PAF lines, byte-identical to the oracle on "
              f"every rank; stats {res[0][run['name']]['first_stats']}")


def dryrun(n_ranks: int, store_dir: Path) -> None:
    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.oracle.pipeline import map_reads as oracle_map
    from minimap2_rs_torch.parallel import ranks
    from minimap2_rs_torch.runtime import host as nhost
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    if n_ranks < 2 or n_ranks % 2:
        raise ValueError("the dry run needs an even number of ranks")
    nhost.native_available()  # build the host runtime once, before the ranks
    ix = 2
    n_reads = n_ranks * 4
    genome, idx, codes, lengths, cp, statics = _tiny_problem(n_reads=n_reads)

    # 1-2) the chain-score steps, the statistics, the quantile
    t0 = time.perf_counter()
    res = ranks.spawn(ranks.step_checks, n_ranks, idx, codes, lengths, cp, statics, ix,
                      (2e-4,), store_dir=store_dir, device="cpu", timeout_s=600)
    cat = lambda mode, name: np.concatenate([r[mode][name] for r in res])
    ovf = cat("dp", "anc_ovf") | cat("sharded", "anc_ovf")
    na_dp, na_sh = cat("dp", "n_anchors"), cat("sharded", "n_anchors")
    f_dp, f_sh = cat("dp", "f"), cat("sharded", "f")
    checked = 0
    for b in np.flatnonzero(~ovf):
        _check(na_dp[b] == na_sh[b], f"read {b}: n_anchors {na_dp[b]} != {na_sh[b]}")
        np.testing.assert_array_equal(f_dp[b, :na_dp[b]], f_sh[b, :na_dp[b]])
        checked += 1
    _check(checked >= n_reads // 2, f"only {checked} reads compared")
    want_stats = (int(idx.keys.shape[0]), int(idx.positions.shape[0]))
    for r in res:
        _check(r["stats"] == want_stats, f"stats {r['stats']} != {want_stats}")
        _check(r["mid_occ"][2e-4] == idx.calc_mid_occ(2e-4), f"mid_occ {r['mid_occ']}")
    print(f"steps on {n_ranks} ranks: dp and sharded (ix={ix}, dm_entry "
          f"{res[0]['dm_entry']}) agree on {checked} of {n_reads} reads; stats "
          f"{want_stats} and mid_occ {idx.calc_mid_occ(2e-4)} equal the oracle's; "
          f"{time.perf_counter() - t0:.1f} s")

    # 3) MeshMapper on the tiny problem; 4) the realistic regime;
    # 5) the lane-shape regime
    mp = MapParams()
    cp_d = ChainParams.defaults_for_k(idx.k)
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, n_reads, read_len=(80, 120), seed=2)]
    big = random_genome(1_000_000, seed=42)
    idx_r = build_index_native([("chrR", big)], IndexParams())
    cp_r = ChainParams.defaults_for_k(15)
    reads_r = [(n, s) for n, s, *_ in simulate_reads(big, 368, read_len=(500, 1000),
                                                     seed=43)]
    rng = np.random.RandomState(44)
    for ci in range(16):  # halves 200 kb apart: the best chain covers about half
        a = int(rng.randint(0, 700_000))
        reads_r.append((f"chim{ci}", big[a:a + 400] + big[a + 200_000:a + 200_400]))
    reads_l = [(n, s) for n, s, *_ in simulate_reads(big, 2 * n_ranks,
                                                     read_len=(5000, 8000), seed=45)]
    for ci in range(4):
        a = int(rng.randint(0, 600_000))
        reads_l.append((f"lchim{ci}", big[a:a + 3000] + big[a + 300_000:a + 303_000]))
    modes = ((False, n_ranks, 1), (True, n_ranks // ix, ix))
    sets = [
        ("tiny", idx, cp_d, rl, dict(buckets=(256,), batch_size=8, mini_frac=0.6,
                                     anchor_frac=1.0)),
        ("realistic", idx_r, cp_r, reads_r, dict(buckets=(1024,), batch_size=n_ranks * 16,
                                                 mini_frac=0.25, anchor_frac=0.04)),
        ("lane", idx_r, cp_r, reads_l, dict(buckets=(8192,), batch_size=n_ranks * 16)),
    ]
    runs, want = [], {}
    for tag, ix_, cp_, reads_, kw in sets:
        host = oracle_map(ix_, reads_, cp_, mp)
        _check(bool(host), f"{tag}: the oracle maps nothing")
        for sharded, dp, ixx in modes:
            name = f"{tag}/{'sharded' if sharded else 'dp'}"
            runs.append(dict(name=name, idx=ix_, cp=cp_, mp=mp, reads=reads_, dp=dp, ix=ixx,
                             sharded=sharded, kw=kw))
            want[name] = host
    t0 = time.perf_counter()
    res = ranks.spawn(ranks.mesh_map, n_ranks, runs, store_dir=store_dir, device="cpu",
                      timeout_s=1800)
    _check_runs(res, runs, want)
    for name, key in (("realistic/sharded", "tier2_reads"), ("realistic/sharded", "wide_reads"),
                      ("lane/sharded", "wide_reads"), ("lane/dp", "wide_reads")):
        _check(res[0][name]["first_stats"].get(key, 0) > 0, f"{name}: {key} never fired")
    print(f"MeshMapper runs: {time.perf_counter() - t0:.1f} s; the 4x tier and the wide "
          f"band fired on the mesh")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8, help="gloo ranks on the CPU (even)")
    args = ap.parse_args(argv)
    store_dir = Path(__file__).resolve().parent / "build" / "dryrun"
    store_dir.mkdir(parents=True, exist_ok=True)
    entry()
    dryrun(args.ranks, store_dir)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"dryrun over {args.ranks} ranks OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
