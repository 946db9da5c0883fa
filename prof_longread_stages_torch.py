"""Stage times at the long-read buckets, on the port: the counterpart of
prof_longread_stages.py.

    python3 prof_longread_stages_torch.py [--device cuda|cpu]

512 reads of 5-20 kb (seed 3) against the 5 Mbp genome (seed 0), the
Mapper at batch_size 8192, the reads grouped by bucket. At the 8192 and
24576 buckets (a bucket the reads leave empty raises) and at two batch
sizes, B_full = Mapper._shapes_for(bucket, 1)[3] (the mapper's padded
call) and B_cap (the bucket's population rounded up to 128, at least
128), the card's time of one call of:

  1. models/stages.sketch_compact_filter (sketch, compaction, key sort,
     occurrence filter);
  2. models/stages.sketch_to_anchors (1. plus lookup, expansion and the
     anchor sort);
  3. one band of kernels/chain_dp.chain_dp_aux_batch on 2.'s anchors
     (grp = x_hi, rpos = x_lo, qpos = y_lo, span = y_hi & 0xFF) at the
     lite window, min(window, LITE_WINDOW_CAP): the lane kernel, which
     must launch.

The codes are int32 nt4 rows padded with 4, as prof_longread_stages.py
packs them; the statics are the mapper's own (bench_torch.lite_statics).
Each function is captured as a CUDA graph and one replay timed behind a
spin kernel (bench_torch._graph_ms): no relay sync floor is subtracted,
since the card has none. --device cpu times the plain versions on the
host clock; the default, cuda, raises without a card. main(argv, sizes)
takes the set sizes (SIZES) for a cut run. Imports nothing of jax or of
the JAX package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from bench_torch import _counting, _graph_ms, _host_ms, _require, lite_statics
from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.device import resolve_device
from minimap2_rs_torch.kernels.chain_dp import chain_dp_aux_batch
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.mapper import Mapper
from minimap2_rs_torch.models.stages import chain_inputs, sketch_compact_filter, sketch_to_anchors
from minimap2_rs_torch.runtime import host as nhost
from minimap2_rs_torch.utils.measure import nvidia_smi
from minimap2_rs_torch.utils.packing import nt4_encode
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

# the set sizes prof_longread_stages.py hard-codes (its lines); "mapper"
# holds extra Mapper keywords (buckets, anchor_frac) for a cut run, and
# "reps" the host-clock repeats of a CPU run
SIZES = {
    "genome": 5_000_000,          # (:34)
    "reads": 512,                 # (:57)
    "read_len": (5000, 20000),    # (:57)
    "batch_size": 8192,           # (:38)
    "buckets": (8192, 24576),     # (:70)
    "cap_unit": 128,              # B_cap's rounding (:74)
    "reps": 5,
    "mapper": {},
}
STAGES = ("sketch", "anchors", "chain")


def pack_codes(seqs, B: int, bucket: int):
    """(codes (B, bucket) int32 nt4, padding 4; lengths (B,) int32) of the
    first B of `seqs`, as prof_longread_stages.py packs them."""
    codes = np.full((B, bucket), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs[:B]):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    return codes, lengths


def stage_fns(st: dict, codes: torch.Tensor, lengths: torch.Tensor) -> dict:
    """{stage: fn()} of the three timed calls on device tensors `codes`
    and `lengths` with the statics `st`; the chain call takes the anchors
    of one sketch_to_anchors call made here."""
    kw = dict(w=st["w"], k=st["k"], q_occ_max=st["q_occ_max"], q_occ_frac=st["q_occ_frac"],
              M=st["M"])

    def sketch():
        return sketch_compact_filter(codes, lengths, **kw)

    def anchors():
        return sketch_to_anchors(st["dev_idx"], codes, lengths, st["mid_occ"], A=st["A"], **kw)

    anc = anchors()
    args = chain_inputs(anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"])

    def chain():
        return chain_dp_aux_batch(*args, st["scalars"], st["window"], st["log2_tab"],
                                  st["max_chain_skip"])

    return {"sketch": sketch, "anchors": anchors, "chain": chain}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None, sizes: dict | None = None) -> dict:
    """Print prof_longread_stages.py's report and return the record.
    Raises on any failure."""
    args = _parser().parse_args(argv)
    sz = {**SIZES, **(sizes or {})}
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if not nhost.native_available():
        raise RuntimeError("the native host runtime did not build or load")
    genome = random_genome(sz["genome"], seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    mapper = Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(15), MapParams(),
                                      batch_size=sz["batch_size"], device=dev, **sz["mapper"])
    print("timing: one replay of each call captured as a CUDA graph, behind a spin kernel"
          if cuda else f"timing: host clock, median of {sz['reps']} calls")
    lrl = simulate_reads(genome, sz["reads"], read_len=sz["read_len"], seed=3)
    groups = {b: [lrl[i][1] for i in ris]
              for b, ris in mapper._group(lrl, range(len(lrl))).items()}

    rec = {"device": nvidia_smi() if cuda else "cpu", "buckets": []}
    for bucket in sz["buckets"]:
        seqs = groups.get(bucket)
        if not seqs:
            raise ValueError(f"bucket {bucket} holds none of the {len(lrl)} reads: "
                             f"populations {dict(sorted((b, len(v)) for b, v in groups.items()))}")
        st = lite_statics(mapper, bucket, "4bit")  # no call here reads the wire
        M, A, window = st["M"], st["A"], st["window"]
        B_full = mapper._shapes_for(bucket, 1)[3]
        unit = sz["cap_unit"]
        B_cap = max(unit, -(-len(seqs) // unit) * unit)
        print(f"\nbucket {bucket}: {len(seqs)} reads, M={M} A={A} "
              f"window={window} B_full={B_full} B_cap={B_cap}")
        row = dict(bucket=bucket, reads=len(seqs), M=M, A=A, window=window, B_full=B_full,
                   B_cap=B_cap, calls=[])
        for B in (B_full, B_cap):
            codes, lengths = pack_codes(seqs, B, bucket)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            fns = stage_fns(st, torch.from_numpy(codes).to(dev),
                            torch.from_numpy(lengths).to(dev))
            ms, launches = {}, {}
            for name in STAGES:
                ms[name], launches[name] = _counting(
                    lambda: _graph_ms(fns[name]) if cuda
                    else _host_ms(fns[name], dev, reps=sz["reps"]))
            _require(f"bucket {bucket}, B={B}, chain", launches["chain"],
                     "chain_dp_aux/lane", dev)
            print(f"  B={B}: sketch+sort+filter {ms['sketch']:9.4f} ms | "
                  f"+lookup+expand+ancsort {ms['anchors']:9.4f} ms | "
                  f"chain(1 band) {ms['chain']:9.4f} ms", flush=True)
            row["calls"].append(dict(
                B=B, codes_bytes=codes.nbytes, **{f"{k}_ms": v for k, v in ms.items()},
                launches=launches["chain"],
                peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None))
            del fns
        rec["buckets"].append(row)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
