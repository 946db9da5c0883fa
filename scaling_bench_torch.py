"""Scaling of the port's mesh mapping path, dp = 1 against dp = N: the
counterpart of scaling_bench.py.

    python3 scaling_bench_torch.py [--reads N] [--genome-kb KB] [--dp 8]
        [--sharded] [--pin-threads] [--share-device] [--device cuda|cpu]

A random genome of --genome-kb kb (seed 0), its oracle index
(oracle.index.build_index), --reads reads of 500-1000 bp (seed 1),
MeshMapper at batch_size 1024. Ranks are processes
(parallel/ranks.spawn, a FileStore under build/), one group a world
size: dp = 1 on one rank, then dp = N and, with --sharded, the
hash-range-sharded (N/2, 2) mesh on N ranks. Transports:

  * --device cpu: gloo ranks on the host, the port's counterpart of the
    JAX package's virtual CPU mesh; the programs run through
    ProgramCache(graph=ReplayStandIn), the capture plumbing without a card;
  * --device cuda with at least N cards: NCCL, one card a rank, each
    stage captured as a CUDA graph with its collectives inside;
  * --device cuda --share-device: gloo ranks on one card, eager (a gloo
    collective stages through host memory, which no capture holds).
    Fewer cards than N without --share-device raises.

Each run (parallel/ranks.mesh_map): the warm passes (two with held
programs: a key captures on its second batch), 3 timed map_reads passes
(a pass takes the slowest rank's time; the median is sorted[1]), and,
where the ranks hold programs, the program-only time: every held program
replayed once, 3 rounds, sorted[1] of the slowest rank's rounds (on the
shared card there are none: program_only_* null, program_only_reason).
Every rank of every run must give the same PAF bytes as the dp = 1 run;
with held programs every timed stage must be a replay. --pin-threads
runs torch on one thread a rank (else torch's default). Prints one JSON
line, whose keys line up with scaling_bench.py's (KEY_TABLE). Imports
nothing of jax or of the JAX package; main(argv, sizes) takes the set
sizes (SIZES) for a cut run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.device import resolve_device
from minimap2_rs_torch.models.programs import ReplayStandIn
from minimap2_rs_torch.oracle.index import build_index
from minimap2_rs_torch.parallel import ranks
from minimap2_rs_torch.runtime import host as nhost
from minimap2_rs_torch.utils.measure import median, nvidia_smi
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

ROOT = Path(__file__).resolve().parent

# the set sizes scaling_bench.py hard-codes (its lines); "mapper" holds
# extra MeshMapper keywords (buckets) for a cut run on the CPU
SIZES = {
    "read_len": (500, 1000),      # (:65)
    "batch_size": 1024,           # (:75)
    "passes": 3,                  # (:78)
    "program_rounds": 3,          # (:107)
    "timeout_s": 1800,
    "mapper": {},
}

# scaling_bench.py's record key ("{dp}" for --dp) -> this record's key:
# the same where the quantity is the same, another name where it is not,
# None where it is a TPU figure. WHY gives the reason of every rename
# and drop.
_SAME = ("metric", "value", "unit", "t_dp1_s", "t_dp{dp}_s", "reads_per_s_dp1",
         "reads_per_s_dp{dp}", "program_only_dp1_s", "program_only_dp{dp}_s",
         "program_only_efficiency", "work_conservation_t1_over_tN",
         "program_work_conservation", "sharded_dp_ix_s", "sharded_program_only_s")
KEY_TABLE = {
    **{k: k for k in _SAME},
    "ici_payload_per_call": "collective_payload_per_call",
    "ici_bytes_per_read": "collective_bytes_per_read",
    "predicted_ici_overhead_frac": None,
}
WHY = {
    "ici_payload_per_call": "the bytes one rank's collectives send in a sharded call "
                            "(parallel/pipeline.sharded_payload_bytes, by (reads, bucket) "
                            "of the batch), over NCCL or gloo, not a TPU's ICI",
    "ici_bytes_per_read": "the same per read, the largest over the call shapes",
    "predicted_ici_overhead_frac": "it divides by a TPU v5e ICI link's rate; "
                                   "collective_bytes_per_s, the load a link would carry, "
                                   "takes its place",
}
# keys this record adds
ADDED = {
    "transport": "gloo-cpu, nccl or gloo-shared-device",
    "device": "the card's name and power limit (nvidia-smi), or \"cpu\"",
    "dp": "--dp",
    "collective_bytes_per_s": "collective_bytes_per_read x reads_per_s_dp{dp} (--sharded)",
    "program_only_reason": "why program_only_* is null (the shared card holds no programs)",
    "pass_times_s": "each run's timed passes, the slowest rank's time each",
    "program_rounds_s": "each run's program-only rounds, the slowest rank's time each",
    "launches": "each run's kernel launches in its timed passes, over the ranks",
    "collectives": "each run's collective calls, bytes and seconds a timed pass, rank 0",
    "paf_sha256": "the sha256 of the PAF bytes every rank of every run gave",
}
SHARED_REASON = ("gloo ranks on one card run eagerly: a gloo collective stages through "
                 "host memory, which no CUDA graph can hold, so no program is held")


def record_keys(dp: int, sharded: bool, held: bool) -> set:
    """The keys of a record at --dp dp, with --sharded, and with held
    programs (else program_only_reason)."""
    keys = {v.format(dp=dp) for v in KEY_TABLE.values() if v} | set(ADDED)
    if not sharded:
        keys -= {"sharded_dp_ix_s", "sharded_program_only_s", "collective_payload_per_call",
                 "collective_bytes_per_read", "collective_bytes_per_s"}
    if held:
        keys.discard("program_only_reason")
    return keys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--genome-kb", type=int, default=500)
    ap.add_argument("--dp", type=int, default=8)
    ap.add_argument("--sharded", action="store_true",
                    help="also time the (dp/2, 2) sharded-index mode")
    ap.add_argument("--pin-threads", action="store_true",
                    help="run torch on one thread in each rank (else torch's default)")
    ap.add_argument("--share-device", action="store_true",
                    help="with --device cuda: gloo ranks that share one card (eager)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def transport(dev: torch.device, dp: int, share_device: bool) -> str:
    """The ranks' transport for this device and dp; raises where it
    cannot run."""
    if dev.type == "cpu":
        if share_device:
            raise ValueError("--share-device needs --device cuda")
        return "gloo-cpu"
    if share_device:
        return "gloo-shared-device"
    if torch.cuda.device_count() < dp:
        raise RuntimeError(f"--dp {dp} NCCL ranks need {dp} cards, this host has "
                           f"{torch.cuda.device_count()}; pass --share-device for gloo "
                           "ranks on one card")
    return "nccl"


def check_same_bytes(results: dict) -> bytes:
    """The one PAF blob of every rank of every run ({name: [rank
    results]}); raises where a rank's bytes differ from the first run's
    rank 0, or where there are none."""
    runs = list(results.items())
    want = runs[0][1][0]["blob"]
    if not want:
        raise AssertionError(f"run {runs[0][0]} produced no mappings")
    for name, res in runs:
        for rank, r in enumerate(res):
            if r["blob"] != want:
                raise AssertionError(f"run {name}, rank {rank}: other PAF bytes than run "
                                     f"{runs[0][0]}, rank 0")
    return want


def _slowest(per_rank: list) -> list:
    """Per pass (or round), the slowest rank's seconds."""
    return [max(ts) for ts in zip(*per_rank)]


def main(argv=None, sizes: dict | None = None) -> dict:
    """Time the runs, print the record as one JSON line and return it.
    Raises on any failure."""
    args = _parser().parse_args(argv)
    sz = {**SIZES, **(sizes or {})}
    dev = resolve_device(args.device)
    mode = transport(dev, args.dp, args.share_device)
    if args.sharded and args.dp < 2:
        raise ValueError("--sharded needs --dp 2 or more")
    if not nhost.native_available():
        raise RuntimeError("the native host runtime did not build or load")
    genome = random_genome(args.genome_kb * 1000, seed=0)
    idx = build_index([("chrS", genome)], IndexParams())
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, args.reads, read_len=sz["read_len"],
                                                seed=1)]
    held = mode != "gloo-shared-device"
    kw = dict(batch_size=sz["batch_size"], **sz["mapper"])
    if mode == "gloo-shared-device":
        kw["graphs"] = False
    base = dict(idx=idx, cp=cp, mp=mp, reads=rl, kw=kw, passes=sz["passes"],
                warm=2 if held else 1, program_only=sz["program_rounds"] if held else 0,
                graph=ReplayStandIn if mode == "gloo-cpu" else None)
    store = ROOT / "build" / "scaling_store"
    store.mkdir(parents=True, exist_ok=True)
    spawn_kw = dict(store_dir=store, device="cuda:0" if mode == "gloo-shared-device"
                    else dev.type, share_device=mode == "gloo-shared-device",
                    timeout_s=sz["timeout_s"], threads=1 if args.pin_threads else None)

    def spawn(world: int, runs: list) -> dict:
        t0 = time.perf_counter()
        res = ranks.spawn(ranks.mesh_map, world, [{**base, **r} for r in runs], **spawn_kw)
        print(f"[scaling] {', '.join(r['name'] for r in runs)} on {world} {mode} ranks: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        return {r["name"]: [rank[r["name"]] for rank in res] for r in runs}

    results = spawn(1, [dict(name="dp1", dp=1, ix=1, sharded=False)])
    big = [dict(name=f"dp{args.dp}", dp=args.dp, ix=1, sharded=False)]
    if args.sharded:
        big.append(dict(name="sharded", dp=args.dp // 2, ix=2, sharded=True))
    if args.dp == 1:
        results[f"dp{args.dp}"] = results["dp1"]  # the same run
    else:
        results.update(spawn(args.dp, big))
    blob = check_same_bytes(results)

    times, rounds, launches, colls = {}, {}, {}, {}
    for name, res in results.items():
        for rank, r in enumerate(res):
            if held and any(st.get("eager_stages") or st.get("graph_captures")
                            or not st.get("graph_replays") for st in r["pass_stats"]):
                raise AssertionError(f"run {name}, rank {rank}: a timed pass ran a stage "
                                     f"eagerly or captured one: {r['pass_stats']}")
        times[name] = _slowest([r["times"] for r in res])
        rounds[name] = _slowest([r["program_only"] for r in res]) if held else None
        launches[name] = {}
        for r in res:
            for k, v in r["launches"].items():
                launches[name][k] = launches[name].get(k, 0) + v
        n = len(res[0]["times"])
        colls[name] = {k: {"calls": v["calls"] / n, "bytes_sent": v["bytes_sent"] / n,
                           "seconds": v["seconds"] / n, "transport": v["transport"]}
                       for k, v in res[0]["collectives"].items()}

    N = args.dp
    t1, tn = median(times["dp1"]), median(times[f"dp{N}"])
    p1, pn = (median(rounds["dp1"]), median(rounds[f"dp{N}"])) if held else (None, None)
    rec = {
        "metric": "mesh_scaling_efficiency",
        "value": (t1 / tn) / N,
        "unit": f"(t_dp1/t_dp{N})/{N}",
        "transport": mode,
        "device": nvidia_smi() if dev.type == "cuda" else "cpu",
        "dp": N,
        "t_dp1_s": t1,
        f"t_dp{N}_s": tn,
        "reads_per_s_dp1": len(rl) / t1,
        f"reads_per_s_dp{N}": len(rl) / tn,
        "program_only_dp1_s": p1,
        f"program_only_dp{N}_s": pn,
        "program_only_efficiency": (p1 / pn) / N if held else None,
        "work_conservation_t1_over_tN": t1 / tn,
        "program_work_conservation": p1 / pn if held else None,
    }
    if not held:
        rec["program_only_reason"] = SHARED_REASON
    if args.sharded:
        rec["sharded_dp_ix_s"] = median(times["sharded"])
        rec["sharded_program_only_s"] = median(rounds["sharded"]) if held else None
        pay = results["sharded"][0]["payload_per_call"]
        if not pay:
            raise AssertionError("the sharded run recorded no collective payload")
        bpr = max(v["collective_bytes_per_read"] for v in pay.values())
        # bytes a read times the record's reads a second, as ADDED states it
        rec.update(collective_payload_per_call=pay, collective_bytes_per_read=bpr,
                   collective_bytes_per_s=bpr * rec[f"reads_per_s_dp{N}"])
    rec.update(pass_times_s=times, program_rounds_s=rounds, launches=launches,
               collectives=colls, paf_sha256=hashlib.sha256(blob).hexdigest())
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
