"""The prefix-probe kernel on the inputs of the benchmark cell chm13-hifi,
on one GPU.

    python3 probe_hifi.py [--seed N] [--rows PATH]

Makes the cell's genome (T2T-CHM13v2.0's 25 sequences at their lengths,
random bases) and one pool call of its HiFi reads from the seed
(port_bench/generate.py, on the card), builds the index at k 19, w 10
(the native build), uploads it (the prefix probe at 128 slots) and maps
the call on a Mapper with captured programs, as the cell does: two
passes that keep the prefix-probe kernel's inputs of each batch shape
(kernels/probe.captured; a shape's first batch runs eagerly, the only
launch whose inputs are kept), then a third that must issue every stage
as a replay, whose kernel launches must equal its probe_kernel_batches.
The kernel is held torch.equal to the plain branch (ops/index_ops.
prefix_probe, on the card) on every kept input, and timed with it on
the largest beside the bound (probe_rows, which chip_smoke.py also
calls for its assembly and chm13 phases); its launches are the third
pass's. --rows writes the kernel row there as JSON.

Needs one CUDA GPU and about 25 GB of host memory; exits non-zero on
any mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2_999_999_997
DESIGN = "binary search, a thread a query"  # csrc/probe.cu's header


def plain_probe(idx, sks, keep):
    """The plain prefix branch on the card's tensors."""
    import torch

    from minimap2_rs_torch.ops.index_ops import prefix_probe
    from minimap2_rs_torch.ops.sketch import ks_keys

    return prefix_probe(idx, torch.where(keep, ks_keys(sks), 0))


def _equal(tag, got, want) -> None:
    import torch

    for name, g, x in zip(("start", "count"), got, want):
        if not torch.equal(g, x):
            bad = (g != x).nonzero()[:5].tolist()
            raise AssertionError(f"[{tag}] probe kernel {name} != plain branch at {bad}")


def probe_rows(tag: str, captured: dict, launches: int) -> list:
    """The prefix-probe kernel (through its wrapper) held to the plain
    branch on every captured input ({(KEY, B, M): ((sks, keep), index)}),
    then timed with the plain branch on the largest beside the bound
    (utils/measure.probe_bound); `launches` the kernel's launches in the
    phase's timed passes. Returns its kernel row (one dict), or none
    without a captured input."""
    import torch

    from minimap2_rs_torch.kernels.probe import KEY, probe_prefix
    from minimap2_rs_torch.utils.measure import KERNEL_INNER, probe_bound, time_ms

    entries = [v for k, v in sorted(captured.items(), key=lambda kv: kv[0][1:])
               if k[0] == KEY]
    if not entries:
        return []
    for (sks, keep), idx in entries:
        _equal(f"{tag} {tuple(sks.shape)}", probe_prefix(idx, sks, keep),
               plain_probe(idx, sks, keep))
    torch.cuda.synchronize()
    (sks, keep), idx = max(entries, key=lambda e: e[0][0].numel())
    ms = time_ms(lambda: probe_prefix(idx, sks, keep), inner=KERNEL_INNER)
    plain_ms = time_ms(lambda: plain_probe(idx, sks, keep), reps=3)
    bound_ms, bound_by = probe_bound(sks)
    shapes = [tuple(e[0][0].shape) for e in entries]
    print(f"probe_prefix ({tag}): S {idx.bucket_slots}, shift {idx.prefix_shift}, "
          f"{idx.n_keys} keys; (B, M) = {shapes}, start and count equal to the plain branch "
          f"on each; timed at {tuple(sks.shape)} ({int(keep.sum())} kept slots): kernel "
          f"{ms:.4f} ms, plain branch {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); launches {launches}, x (ms - bound) = "
          f"{launches * (ms - bound_ms):.4f} ms")
    return [dict(
        name=f"probe_prefix ({tag}, S {idx.bucket_slots})", route="cuda",
        source="minimap2_rs_torch/csrc/probe.cu",
        replaces="minimap2_rs_torch/ops/index_ops.py prefix_probe (minimap2_rs_tpu/ops/"
                 "index_ops.py:504-521)",
        launches=launches, max_abs_err=0, ms=ms, plain_ms=plain_ms, prev_design_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_note="no PyTorch call searches a sorted bucket per key",
        design=DESIGN, shape=f"S {idx.bucket_slots}", timed_at=tuple(sks.shape),
        on_main_path=launches > 0,
    )]


def hifi_phase(seed: int = SEED) -> list:
    """The cell's index and one pool call mapped on captured programs, the
    probe kernel's inputs kept on the first two passes; the kernel row,
    its launches those of the third pass."""
    import torch

    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.kernels import probe as kprobe
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.utils.measure import nvidia_smi
    from port_bench import generate

    print(nvidia_smi())
    config = json.loads((ROOT / "port_bench/configs/chm13-map-hifi.json").read_text())
    mix = json.loads((ROOT / "port_bench/traffic/hifi.json").read_text())
    w, k = int(config["w"]), int(config["k"])
    t0 = time.perf_counter()
    recs, codes = generate.genome([tuple(s) for s in config["sequences"]], seed, "cuda")
    reads = generate.read_pool(codes, mix, seed, 1, "cuda")[0]
    del codes
    idx = build_index_native(recs, IndexParams(w=w, k=k))
    del recs
    mapper = Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(k), MapParams(),
                                      device="cuda")
    di = mapper.dev_idx
    print(f"set-up {time.perf_counter() - t0:.1f} s: {di.n_keys} keys, S {di.bucket_slots}, "
          f"shift {di.prefix_shift}, direct table {di.dm_slots}; {len(reads)} reads, "
          f"{sum(len(s) for _n, s in reads)} bp")
    captured: dict = {}
    kprobe.captured = captured
    try:
        for p in (1, 2):
            t0 = time.perf_counter()
            first = mapper.map_reads_paf(reads)
            torch.cuda.synchronize()
            print(f"pass {p} (inputs kept) {time.perf_counter() - t0:.1f} s")
    finally:
        kprobe.captured = None
    kprobe.reset_launches()
    mapper.stats = {}
    t0 = time.perf_counter()
    if mapper.map_reads_paf(reads) != first:
        raise AssertionError("the third pass's PAF differs from the second's")
    torch.cuda.synchronize()
    st = mapper.stats
    launches = kprobe.total_launches()
    keys = ("device_stages", "eager_stages", "graph_captures", "graph_replays",
            "probe_kernel_batches", "probe_queries", "tier2_reads", "host_reads")
    print(f"pass 3 (replays) {time.perf_counter() - t0:.1f} s: {launches} probe kernel "
          f"launches, stats {json.dumps({x: st.get(x, 0) for x in keys})}")
    n = st.get("device_stages", 0)
    if st.get("eager_stages", 0) or not st.get("graph_replays", 0) >= n > 0:
        raise AssertionError("pass 3 issued a stage other than as a replay")
    if not launches or launches != st.get("probe_kernel_batches"):
        raise AssertionError("probe_kernel_batches != the kernel's launches")
    return probe_rows("chm13-hifi", captured, launches)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--rows", type=Path, help="write the kernel row here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hifi: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    rows = hifi_phase(args.seed)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    if args.rows is not None:
        args.rows.write_text(json.dumps(rows))
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
