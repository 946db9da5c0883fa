"""The long-read path's buckets and passes, on the port: the counterpart
of prof_longread.py.

    python3 prof_longread_torch.py [N] [--device cuda|cpu]

bench_torch.py's long-read section: N reads (default 512) of 5-20 kb
(seed 3) against the 5 Mbp genome (seed 0), on a captured Mapper at
batch_size 8192. Prints each bucket's population and its shapes from
the port's own Mapper (M, A, the window, the lite cap
min(window, LITE_WINDOW_CAP), the rows a call B and _dual_band(A)); then
two warm passes (a key captures on its second batch) and 3 timed
map_reads passes, each with its seconds, the mapped read bases a second,
its line count and its stats.

On the card every timed pass must replay its stages and the timed
passes must launch the lane kernel (chain_dp_aux/lane); any failure
raises. --device cpu runs the plain versions on the host clock; the
default, cuda, raises without a card. main(argv, sizes) takes the set
sizes (SIZES) for a cut run. Imports nothing of jax or of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import time

from bench_torch import _aligned_bp, _counting, _require, _timed_pass, _warm
from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.device import resolve_device
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.mapper import LITE_WINDOW_CAP, Mapper
from minimap2_rs_torch.runtime import host as nhost
from minimap2_rs_torch.utils.measure import nvidia_smi
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

# the set sizes prof_longread.py hard-codes (its lines); "mapper" holds
# extra Mapper keywords (buckets) for a cut run on the CPU
SIZES = {
    "genome": 5_000_000,          # (:26)
    "read_len": (5000, 20000),    # (:34)
    "batch_size": 8192,           # (:31)
    "passes": 3,                  # (:53)
    "mapper": {},
}


def bucket_table(mapper: Mapper, reads) -> list:
    """[{bucket, population, M, A, window, lite_window, B, dual_band}]
    for each bucket the reads fill (Mapper._group), in bucket order."""
    rows = []
    for b, ris in sorted(mapper._group(reads, range(len(reads))).items()):
        M, A, window, B = mapper._shapes_for(b, 1)
        rows.append(dict(bucket=b, population=len(ris), M=M, A=A, window=window,
                         lite_window=min(window, LITE_WINDOW_CAP), B=B,
                         dual_band=mapper._dual_band(A)))
    return rows


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None, sizes: dict | None = None) -> dict:
    """Print prof_longread.py's report and return the record. Raises on
    any failure."""
    args = _parser().parse_args(argv)
    sz = {**SIZES, **(sizes or {})}
    dev = resolve_device(args.device)
    if not nhost.native_available():
        raise RuntimeError("the native host runtime did not build or load")
    genome = random_genome(sz["genome"], seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    mapper = Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(15), MapParams(),
                                      batch_size=sz["batch_size"], device=dev, **sz["mapper"])
    lrl = [(nm, s) for nm, s, *_ in simulate_reads(genome, args.n, read_len=sz["read_len"],
                                                   seed=3)]
    total_bp = sum(len(s) for _, s in lrl)

    table = bucket_table(mapper, lrl)
    print("bucket populations:", {r["bucket"]: r["population"] for r in table})
    for r in table:
        print(f"  bucket {r['bucket']}: M={r['M']} A={r['A']} window={r['window']} "
              f"(lite cap -> {r['lite_window']}) B={r['B']} dual_band={r['dual_band']}")

    t0 = time.perf_counter()
    _warm(mapper, lrl)
    warm_s = time.perf_counter() - t0
    n_warm = 2 if mapper.programs is not None else 1
    print(f"warmup ({n_warm} passes): {warm_s:.1f}s")

    passes = []

    def timed():
        for p in range(sz["passes"]):
            t1 = time.perf_counter()
            lines = _timed_pass(mapper, lrl)
            dt = time.perf_counter() - t1
            l_bp = _aligned_bp(lrl, lines)
            print(f"pass {p}: {dt:.3f}s  {l_bp/dt/1e6:.2f} Mbp/s  "
                  f"({len(lines)} lines, {l_bp}/{total_bp} bp mapped)")
            print("  stats:", {k: (round(v, 4) if isinstance(v, float) else v)
                               for k, v in sorted(mapper.stats.items())})
            passes.append(dict(seconds=dt, bp_per_s=l_bp / dt, lines=len(lines),
                               mapped_bp=l_bp, stats=dict(mapper.stats)))

    _, launches = _counting(timed)
    _require("long reads", launches, "chain_dp_aux/lane", dev)
    rec = {"device": nvidia_smi() if dev.type == "cuda" else "cpu", "n": args.n,
           "total_bp": total_bp, "buckets": table, "warm_passes": n_warm, "warm_s": warm_s,
           "passes": passes, "launches": launches}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
