"""The control of the benchmark's `correct`: the reference put in the
mapper's place, its chain DP computed in bfloat16 (reference/chain.py),
judged against the float32 reference as run.py judges the mapper, at a
cell's own size, once per seed.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

It reads the cell's genome, pool and sample size exactly as run.py does
(the sample is drawn from the pool's calls, since no window runs) and
prints one JSON line per seed: the reads judged and those mismatched,
which has to be above run.py's limit of 0. The benchmark's own runs do
not run it. It needs a CUDA device, as run.py does.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(root: Path, cell_name: str, seed: int, device, err=sys.stderr) -> dict:
    import torch

    from port_bench import generate, harness
    from port_bench.reference import chain as rchain
    from port_bench.reference import pipeline as rpipe

    _bench, _cell, config, mix = harness.load_cell(root, cell_name)
    t = time.perf_counter()
    recs, codes = generate.genome([tuple(s) for s in config["sequences"]], seed, device)
    n_calls = min(int(mix["pool_calls"]), int(config.get("pool_calls_max", 1 << 30)))
    pool = generate.read_pool(codes, mix, seed, n_calls, device)
    del codes
    sample, _kinds = harness.choose_sample([(reads, b"") for reads in pool], mix, seed)
    reads = [pool[c][r] for c, r in sample]
    idx = harness.reference_index(reads, recs, config, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cp, mp = rchain.ChainParams(k=idx.k), rpipe.MapParams()
    got = [rpipe.map_read(idx, n, s, cp, mp, mode="exact", pen_dtype="bfloat16")
           for n, s in reads]
    verdict = harness.judge(idx, reads, got, err)
    return {"workload": cell_name, "seed": seed, "judged": verdict["judged"],
            "mismatched_reads": verdict["mismatched"], "seconds": time.perf_counter() - t}


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="port_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench: the control needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(control(ROOT, args.workload, seed, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
