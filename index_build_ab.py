"""The device index build at the chm13 phase's size on one GPU: its
seconds, the card's peak memory and the host's peak RSS, as one JSON line.

    python3 index_build_ab.py [--package-dir DIR]

The genome is chip_smoke.py's chm13 phase's: random_genome(3,117,292,070,
seed=11) cut into T2T-CHM13v2.0's 25 sequences. --package-dir puts DIR
first on sys.path, so that the build of another copy of the port (a `git
archive` of an earlier commit unpacked there) is measured on the same
genome; run the two copies in turns, one process each, in one call. A
build the card cannot hold prints its out-of-memory error and the peak
reached. Needs a card, and about 45 GB of host memory.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-dir", type=Path,
                    help="the directory holding the minimap2_rs_torch to measure")
    args = ap.parse_args(argv)
    if args.package_dir:
        sys.path.insert(0, str(args.package_dir.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("index_build_ab: no CUDA device")
    import minimap2_rs_torch
    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_device
    from minimap2_rs_torch.utils.seqsim import random_genome

    sys.path.insert(1, str(Path(__file__).resolve().parent))
    from chip_smoke import CHM13_BP, chm13_lengths, cut_records

    t0 = time.perf_counter()
    records = cut_records(random_genome(CHM13_BP, seed=11), chm13_lengths())
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rec = {"package": str(Path(minimap2_rs_torch.__file__).parent), "bp": CHM13_BP,
           "genome_s": t_gen, "device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    try:
        idx = build_index_device(records, IndexParams(), device="cuda")
        rec.update(build_s=time.perf_counter() - t0, keys=int(idx.keys.shape[0]),
                   positions=int(idx.positions.shape[0]))
    except torch.OutOfMemoryError as e:
        rec.update(build_s=time.perf_counter() - t0, out_of_memory=str(e).splitlines()[0])
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
