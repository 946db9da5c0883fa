"""Command-line interface of the port: `align`, mirroring the JAX
package's `minimap2_rs_tpu.cli align` (cli.py:69-88, 165-246) with the
flags the port supports.

    python -m minimap2_rs_torch.cli align ref.fa reads.fa -n 1 -m 10
    python -m minimap2_rs_torch.cli align ref.fa reads.fa --device cpu

It builds the index with the native C++ builder (or loads a .mmi or
native index file), maps every read through the port's Mapper on
`--device` (default cuda) and writes one PAF blob to stdout or `-o`.
A cuda request on a machine without CUDA exits with an error; the CPU
runs only when asked for. Flags of the JAX CLI that the port does not
have (-H, --engine, --mesh, --index-shards, --trace-dir) are rejected.
`index`, `anchors` and `chain` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams, apply_preset
from minimap2_rs_tpu.io.fasta import read_fasta, read_fasta_first
from minimap2_rs_tpu.oracle.index import OracleIndex
from minimap2_rs_tpu.utils.profiling import print_stage_stats

from .device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mm2t-torch", description="minimap2-class read mapper on PyTorch/CUDA"
    )
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("align", help="map reads, PAF output")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    p.add_argument("-w", type=int, default=10)
    p.add_argument("-k", type=int, default=15)
    p.add_argument("-f", dest="frac_top_repetitive", type=float, default=2e-4)
    p.add_argument("-g", dest="max_gap", type=int, default=5000)
    p.add_argument("-r", dest="r", default=None, help="NUM[,NUM] bandwidth (bw[,bw_long])")
    p.add_argument("-n", dest="min_cnt", type=int, default=3)
    p.add_argument("-m", dest="min_chain_score", type=int, default=40)
    p.add_argument("-M", "--mask-level", type=float, default=0.5)
    p.add_argument("-p", "--pri-ratio", type=float, default=0.8)
    p.add_argument("-N", "--best-n", type=int, default=5)
    p.add_argument("-x", dest="preset", default=None)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("--first-only", action="store_true",
                   help="map only the first query record (reference behavior)")
    p.add_argument("--stats", action="store_true",
                   help="print a per-stage timing breakdown to stderr")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="max reads per device program invocation")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (cpu only when asked for)")
    return ap


def _bandwidths(r: str | None) -> dict:
    """-r NUM[,NUM] -> ChainParams overrides bw[, bw_long]; a part that is
    not an integer is ignored, as in the JAX CLI."""
    out = {}
    for key, part in zip(("bw", "bw_long"), (r or "").split(",")):
        try:
            out[key] = int(part)
        except ValueError:
            pass
    return out


def load_index(path: str, w: int, k: int) -> OracleIndex:
    """A .mmi or native index file as it is; a FASTA through the native
    C++ builder (the JAX CLI's load_index_auto order)."""
    from .models.index_builder import build_index_native

    if path.endswith(".mmi"):
        return OracleIndex.load_from_mmi(path)
    try:
        return OracleIndex.load_from_file(path)
    except ValueError:  # no native index magic: a FASTA
        return build_index_native(read_fasta(path), IndexParams(w=w, k=k, bucket_bits=14))


def align(args, ap: argparse.ArgumentParser) -> int:
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e}; pass --device cpu to map on the CPU")
    from .models.mapper import Mapper

    w, k = apply_preset(args.preset, args.w, args.k) if args.preset else (args.w, args.k)
    idx = load_index(args.ref_fasta, w, k)
    reads = (
        [read_fasta_first(args.qry_fasta)] if args.first_only else read_fasta(args.qry_fasta)
    )
    cp = ChainParams.defaults_for_k(
        idx.k, max_dist_x=args.max_gap, max_dist_y=args.max_gap,
        min_cnt=args.min_cnt, min_chain_score=args.min_chain_score,
        **_bandwidths(args.r),
    )
    mp = MapParams(
        frac_top_repetitive=args.frac_top_repetitive, mask_level=args.mask_level,
        pri_ratio=args.pri_ratio, best_n=args.best_n,
    )
    t0 = time.time()
    mapper = Mapper.from_oracle_index(idx, cp, mp, device=device,
                                      batch_size=args.batch_size)
    blob = mapper.map_reads_paf(reads)
    if args.stats:
        total_bp = sum(len(s) for _, s in reads)
        print_stage_stats(dict(mapper.stats), len(reads), total_bp, time.time() - t0)
    if args.output and args.output != "-":
        with open(args.output, "wb") as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
        sys.stdout.buffer.flush()
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command == "align":
        return align(args, ap)
    return 1


if __name__ == "__main__":
    sys.exit(main())
