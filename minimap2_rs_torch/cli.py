"""Command-line interface of the port, mirroring the JAX package's
`minimap2_rs_tpu.cli` (cli.py:48-334): `index`, `anchors`, `chain` and
`align`, with the same flags and output.

    python -m minimap2_rs_torch.cli index ref.fa -d ref.mmi --engine device
    python -m minimap2_rs_torch.cli anchors ref.fa reads.fa -k 14
    python -m minimap2_rs_torch.cli chain ref.fa reads.fa --engine device
    python -m minimap2_rs_torch.cli align ref.fa reads.fa -n 1 -m 10
    python -m minimap2_rs_torch.cli align ref.fa reads.fa --device cpu
    torchrun --nproc-per-node 4 -m minimap2_rs_torch.cli align ref.fa reads.fa \
        --mesh 2 --index-shards 2

`--engine device` (the default `auto` for anchors, chain and align) runs
on `--device`, cuda unless asked otherwise; a cuda request on a machine
without CUDA exits with an error, and nothing falls back to the CPU or
the host. `--engine host` runs the reference-faithful host oracle.
`index` defaults to the native C++ builder; its `device` engine is the
port's chunked device build. `anchors` sends a query whose minimizers
or anchors overflow the device capacities to the host oracle, as the
JAX CLI does, and says so on stderr. `--trace-dir` writes a
torch.profiler trace of the mapping. `align --mesh DP --index-shards IX`
maps over a (DP, IX) mesh of ranks (models/mesh_mapper.py): one rank a
process, as torchrun starts them (RANK, WORLD_SIZE, LOCAL_RANK; rank r
on cuda:LOCAL_RANK), the index hash-range-sharded when IX > 1. DP * IX
must equal the launch's ranks (`--mesh 1` runs without torchrun), and
only rank 0 writes the PAF.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .config import ChainParams, IndexParams, MapParams, apply_preset
from .device import resolve_device
from .io.fasta import read_fasta, read_fasta_first
from .oracle.index import OracleIndex, build_index
from .oracle.lchain import backtrack, chain_dp
from .oracle.pipeline import map_reads
from .oracle.seeds import (
    build_anchors,
    collect_query_minimizers,
    filter_query_minimizers,
)
from .utils.packing import nt4_encode
from .utils.profiling import device_trace, print_stage_stats


def _add_common(p, engines, default="auto"):
    p.add_argument("-w", type=int, default=10)
    p.add_argument("-k", type=int, default=15)
    p.add_argument("-H", "--hpc", action="store_true")
    p.add_argument("--engine", choices=engines, default=default)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device engine runs (cpu only when asked for)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mm2t-torch", description="minimap2-class read mapper on PyTorch/CUDA"
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="build a reference index")
    p.add_argument("fasta")
    _add_common(p, ["auto", "native", "device", "host"])
    p.add_argument("-b", "--bucket-bits", type=int, default=14)
    p.add_argument("-d", "--dump", default=None)

    p = sub.add_parser("anchors", help="debug: print anchor stats")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_common(p, ["auto", "device", "host"])

    p = sub.add_parser("chain", help="debug: best chain endpoints")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_common(p, ["auto", "device", "host"])
    p.add_argument("-r", dest="bw", type=int, default=5000)

    p = sub.add_parser("align", help="map reads, PAF output")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_common(p, ["auto", "device", "host"])
    p.add_argument("-f", dest="frac_top_repetitive", type=float, default=2e-4)
    p.add_argument("-g", dest="max_gap", type=int, default=5000)
    p.add_argument("-r", dest="r", default=None, help="NUM[,NUM] bandwidth (bw[,bw_long])")
    p.add_argument("-n", dest="min_cnt", type=int, default=3)
    p.add_argument("-m", dest="min_chain_score", type=int, default=40)
    p.add_argument("-M", "--mask-level", type=float, default=0.5)
    p.add_argument("-p", "--pri-ratio", type=float, default=0.8)
    p.add_argument("-N", "--best-n", type=int, default=5)
    p.add_argument("-x", dest="preset", default=None)
    p.add_argument("-a", dest="out_sam", action="store_true", help="(ignored; PAF only)")
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("--first-only", action="store_true",
                   help="map only the first query record (reference behavior)")
    p.add_argument("--stats", action="store_true",
                   help="print a per-stage timing breakdown (and, on a mesh, "
                        "rank 0's collectives) to stderr")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the mapping here")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="max reads per device program invocation")
    p.add_argument("--mesh", type=int, default=0, metavar="DP",
                   help="map over a DP-way mesh of ranks (0 = single device; "
                        "DP * IX must equal the launch's ranks)")
    p.add_argument("--index-shards", type=int, default=1, metavar="IX",
                   help="hash-range-shard the index over IX ranks")
    return ap


def _device(args, ap: argparse.ArgumentParser):
    """The torch.device of --device, or exit with an error."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e}; pass --device cpu to run on the CPU")


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


def load_index(path: str, w: int, k: int, flag: int = 0) -> OracleIndex:
    """A .mmi or native index file as it is; a FASTA through the native
    C++ builder (the JAX CLI's load_index_auto order)."""
    from .models.index_builder import build_index_native

    if path.endswith(".mmi"):
        return OracleIndex.load_from_mmi(path)
    try:
        return OracleIndex.load_from_file(path)
    except ValueError:  # no native index magic: a FASTA
        return build_index_native(
            read_fasta(path), IndexParams(w=w, k=k, bucket_bits=14, flag=flag)
        )


def index(args, ap) -> int:
    params = IndexParams(w=args.w, k=args.k, bucket_bits=args.bucket_bits,
                         flag=1 if args.hpc else 0)
    records = read_fasta(args.fasta)
    if args.engine == "device":
        from .models.index_builder import build_index_device

        idx = build_index_device(records, params, device=_device(args, ap))
    elif args.engine == "host":
        idx = build_index(records, params)
    else:  # auto, native
        from .models.index_builder import build_index_native

        idx = build_index_native(records, params)
    n_keys, avg_occ, avg_spacing, total_len = idx.stats()
    print(f"kmer size: {args.k}; skip: {args.w}; is_hpc: {1 if args.hpc else 0}; "
          f"#seq: {idx.n_seq}")
    print(f"distinct minimizers: {n_keys} (avg occ {avg_occ:.2f}) "
          f"avg spacing {avg_spacing:.3f} total length {total_len}")
    if args.dump:
        (idx.save_to_mmi if args.dump.endswith(".mmi") else idx.save_to_file)(args.dump)
    return 0


def _lane(v: int) -> int:
    return max(128, -(-int(v) // 128) * 128)


def _device_anchors(idx: OracleIndex, q: bytes, mid_occ: int, device) -> np.ndarray | None:
    """(n, 2) uint64 anchors of one query computed on `device` (JAX
    cli.py:268-302), or None on a capacity overflow (M = L, A = 4L)."""
    import torch

    from .models.stages import sketch_to_anchors
    from .ops.index_ops import DeviceIndex

    L = _lane(len(q))
    codes = np.full((1, L), 4, dtype=np.int32)
    codes[0, : len(q)] = nt4_encode(q)
    dev_idx = DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                    key_bits=2 * idx.k, device=device)
    anc = sketch_to_anchors(
        dev_idx, torch.from_numpy(codes).to(device),
        torch.tensor([len(q)], dtype=torch.int32, device=device), mid_occ,
        w=idx.w, k=idx.k, q_occ_max=10, q_occ_frac=0.01, M=L, A=_lane(4 * L),
    )
    if bool(anc["anc_ovf"][0]) or bool(anc["mini_ovf"][0]):
        return None
    n = int(anc["n_anchors"][0])
    w = {c: anc[c][0, :n].cpu().numpy().astype(np.uint64)
         for c in ("x_hi", "x_lo", "y_hi", "y_lo")}
    x = (w["x_hi"] << np.uint64(32)) | w["x_lo"]
    y = (w["y_hi"] << np.uint64(32)) | w["y_lo"]
    return np.stack([x, y], axis=1)


def _anchors_for(idx: OracleIndex, q: bytes, mid_occ: int, device) -> np.ndarray:
    """Anchors of one query: on `device`, or with the host oracle when
    device is None or the device capacities overflow (reported on
    stderr)."""
    if device is not None:
        out = _device_anchors(idx, q, mid_occ, device)
        if out is not None:
            return out
        print("[mm2t-torch] anchor capacity overflow: host oracle anchors",
              file=sys.stderr)
    mv = collect_query_minimizers(q, idx.w, idx.k)
    mv = filter_query_minimizers(mv, 10, 0.01)
    return build_anchors(idx, mv, len(q), mid_occ)


def _device_chain(anchors: np.ndarray, cp: ChainParams, device) -> list[int]:
    """The reference chain_dp (lchain.rs:54-57) with the DP on `device`:
    the pruned kernel (JAX cli.py:305-334) and the host backtrack;
    returns the best chain's anchor indices."""
    import torch

    from .kernels.chain_dp import chain_dp_batch
    from .ops.chain_ops import chain_scalars_from_params, log2_table

    n = anchors.shape[0]
    if n == 0:
        return []
    A = _lane(n)
    cols = np.zeros((4, 1, A), dtype=np.uint32)
    cols[0] = 0xFFFFFFFF
    cols[0, 0, :n] = anchors[:, 0] >> np.uint64(32)
    cols[1, 0, :n] = anchors[:, 0] & np.uint64(0xFFFFFFFF)
    cols[2, 0, :n] = anchors[:, 1] & np.uint64(0xFFFFFFFF)
    cols[3, 0, :n] = (anchors[:, 1] >> np.uint64(32)) & np.uint64(0xFF)
    grp, rpos, qpos, span = (torch.from_numpy(c.view(np.int32)).to(device) for c in cols)
    f, prev = chain_dp_batch(
        grp, rpos, qpos, span, chain_scalars_from_params(cp),
        min(cp.max_chain_iter, A), log2_table(cp.bw + 1).to(device),
        max_chain_skip=cp.max_chain_skip,
    )
    f = f[0, :n].cpu().numpy()
    prev = prev[0, :n].cpu().numpy()
    chains, _scores = backtrack(anchors, f, None, prev, cp)
    return chains[0] if chains else []


def anchors_or_chain(args, ap) -> int:
    device = None if args.engine == "host" else _device(args, ap)
    idx = load_index(args.ref_fasta, args.w, args.k, 1 if args.hpc else 0)
    _qname, q = read_fasta_first(args.qry_fasta)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    anchors = _anchors_for(idx, q, mid_occ, device)
    if args.command == "anchors":
        print(f"anchors: {anchors.shape[0]}")
        for x, y in anchors[:10]:
            print(f"x=0x{int(x):016x} y=0x{int(y):016x}")
        return 0
    cp = ChainParams.defaults_for_k(idx.k, bw=args.bw)
    chain = _device_chain(anchors, cp, device) if device is not None else chain_dp(anchors, cp)
    print(f"best_chain_len: {len(chain)}")
    if chain:
        st, en = chain[0], chain[-1]
        print(f"start: x=0x{int(anchors[st, 0]):016x} y=0x{int(anchors[st, 1]):016x}")
        print(f"end:   x=0x{int(anchors[en, 0]):016x} y=0x{int(anchors[en, 1]):016x}")
    return 0


def align(args, ap) -> int:
    if args.engine == "host" and (args.mesh or args.index_shards > 1):
        ap.error("--mesh and --index-shards need the device engine, not --engine host")
    device = None if args.engine == "host" else _device(args, ap)
    w, k = apply_preset(args.preset, args.w, args.k) if args.preset else (args.w, args.k)
    idx = load_index(args.ref_fasta, w, k, 1 if args.hpc else 0)
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
    stats: dict = {}
    if device is not None and (args.mesh or args.index_shards > 1):
        return _align_mesh(args, ap, idx, reads, cp, mp, t0)
    with device_trace(args.trace_dir, device):
        if device is None:
            lines = map_reads(idx, reads, cp, mp)
            blob = ("\n".join(lines) + "\n").encode() if lines else b""
        else:
            from .models.mapper import Mapper

            mapper = Mapper.from_oracle_index(idx, cp, mp, device=device,
                                              batch_size=args.batch_size)
            blob = mapper.map_reads_paf(reads)
            stats = dict(mapper.stats)
    _write_paf(args, blob, stats, reads, t0)
    return 0


def _align_mesh(args, ap, idx, reads, cp, mp, t0) -> int:
    """align over a (--mesh, --index-shards) mesh of this launch's ranks;
    rank 0 writes the PAF. A process group this call starts, it ends."""
    import torch.distributed as dist

    from .models.mesh_mapper import make_mesh_mapper

    started = not dist.is_initialized()
    try:
        try:
            mapper = make_mesh_mapper(
                idx, cp, mp, dp=args.mesh or None, ix=args.index_shards,
                index_sharded=args.index_shards > 1, device=args.device,
                batch_size=args.batch_size,
            )
        except ValueError as e:
            ap.error(str(e))
        with device_trace(args.trace_dir, mapper.device):
            blob = mapper.map_reads_paf(reads)
        if mapper.mesh.rank == 0:
            _write_paf(args, blob, dict(mapper.stats), reads, t0)
            if args.stats:
                print(f"[mm2t] collectives of rank 0: {json.dumps(mapper.mesh.stats)}",
                      file=sys.stderr)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _write_paf(args, blob: bytes, stats: dict, reads, t0: float) -> None:
    if args.stats:
        total_bp = sum(len(s) for _, s in reads)
        print_stage_stats(stats, len(reads), total_bp, time.time() - t0)
    if args.output and args.output != "-":
        with open(args.output, "wb") as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
        sys.stdout.buffer.flush()


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command == "index":
        return index(args, ap)
    if args.command in ("anchors", "chain"):
        return anchors_or_chain(args, ap)
    return align(args, ap)


if __name__ == "__main__":
    sys.exit(main())
