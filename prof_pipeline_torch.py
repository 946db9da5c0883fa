"""The headline pass time against reads a call, on the port: the
counterpart of prof_pipeline.py.

    python3 prof_pipeline_torch.py [BATCH_SIZE ...] [--device cuda|cpu]

A 5 Mbp random genome (seed 0), its native index, 16,384 reads of
500-1000 bp (seed 1). For each batch size (default 8192 4096 2048 1024)
a fresh captured Mapper, two warm passes (a key captures on its second
batch), then 5 timed map_reads_paf passes: the median (sorted[2]), the
read bases a second over it (all reads' bases, as prof_pipeline.py
counts them), every pass, and the last pass's float stats (upload,
encode, post...; the record keeps every pass's). Each line adds the
padded rows of each call in each bucket (Mapper._shapes_for caps the
rows a call at _SLOT_TARGET // A, and _quantize_b pads a chunk), so the
sizes that really differ show.

Every size must give the same PAF bytes, and on the card every timed
pass must replay its stages and launch the short-read chain kernel; any
failure raises. Each size's mapper, with its graph pool, is dropped
before the next. --device cpu runs the plain versions on the host clock;
the default, cuda, raises without a card. main(argv, sizes) takes the
set sizes (SIZES) for a cut run. Imports nothing of jax or of the JAX
package.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import time

import torch

from bench_torch import _counting, _require, _timed_pass, _warm
from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.device import resolve_device
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.mapper import Mapper
from minimap2_rs_torch.runtime import host as nhost
from minimap2_rs_torch.utils.measure import median, nvidia_smi
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

# the set sizes prof_pipeline.py hard-codes (its lines); "mapper" holds
# extra Mapper keywords (buckets) for a cut run on the CPU
SIZES = {
    "genome": 5_000_000,          # (:26)
    "reads": 16384,               # (:28)
    "read_len": (500, 1000),      # (:28)
    "passes": 5,                  # (:37)
    "mapper": {},
}
DEFAULT_BATCH_SIZES = (8192, 4096, 2048, 1024)  # (:25)


def call_rows(mapper: Mapper, reads) -> dict:
    """{bucket: [padded rows of each call]}: the reads grouped as the
    mapper groups them (Mapper._group), each bucket's chunks of at most
    _shapes_for(bucket, 1)[3] reads, each padded by _quantize_b."""
    out = {}
    for b, ris in sorted(mapper._group(reads, range(len(reads))).items()):
        B_max = mapper._shapes_for(b, 1)[3]
        out[b] = [mapper._quantize_b(min(B_max, len(ris) - c0), B_max)
                  for c0 in range(0, len(ris), B_max)]
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch_sizes", type=int, nargs="*", default=list(DEFAULT_BATCH_SIZES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None, sizes: dict | None = None) -> dict:
    """Sweep the batch sizes, printing prof_pipeline.py's line for each;
    returns the record. Raises on any failure."""
    args = _parser().parse_args(argv)
    sz = {**SIZES, **(sizes or {})}
    dev = resolve_device(args.device)
    if not nhost.native_available():
        raise RuntimeError("the native host runtime did not build or load")
    genome = random_genome(sz["genome"], seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    rl = [(n, s) for n, s, *_ in simulate_reads(genome, sz["reads"], read_len=sz["read_len"],
                                                seed=1)]
    total_bp = sum(len(s) for _, s in rl)
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    rec = {"device": nvidia_smi() if dev.type == "cuda" else "cpu", "reads": len(rl),
           "total_bp": total_bp, "sizes": []}
    first = None
    for bs in args.batch_sizes:
        mapper = Mapper.from_oracle_index(idx, cp, mp, batch_size=bs, device=dev,
                                          **sz["mapper"])
        rows = call_rows(mapper, rl)
        _warm(mapper, rl)
        times, pass_stats, blob = [], [], b""

        def passes():
            nonlocal blob
            for _ in range(sz["passes"]):
                t0 = time.perf_counter()
                blob = _timed_pass(mapper, rl, paf=True)
                times.append(time.perf_counter() - t0)
                pass_stats.append({k: v for k, v in mapper.stats.items()
                                   if isinstance(v, float)})

        _, launches = _counting(passes)
        _require(f"batch {bs}", launches, "chain_dp_aux/static", dev)
        if first is None:
            first = (bs, blob)
        elif blob != first[1]:
            raise AssertionError(f"batch {bs} gave other PAF bytes than batch {first[0]}")
        med = median(times)
        st = pass_stats[-1]
        print(f"batch={bs:5d}: median {med*1e3:6.1f} ms "
              f"({total_bp/med/1e6:5.1f} M bp/s)  passes "
              f"{[round(t*1e3) for t in times]}  stats "
              f"{ {k: round(v, 3) for k, v in st.items()} }  rows a call {rows}", flush=True)
        rec["sizes"].append(dict(batch_size=bs, median_s=med, bp_per_s=total_bp / med,
                                 pass_times_s=times, stats=st, pass_stats=pass_stats,
                                 rows_per_call=rows, launches=launches))
        # each mapper holds its own graph pool: free it before the next size
        del mapper
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["paf_bytes"] = len(first[1]) if first else 0
    rec["paf_sha256"] = hashlib.sha256(first[1]).hexdigest() if first else None
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
