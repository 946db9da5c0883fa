"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA chain-DP kernel from minimap2_rs_torch/csrc, holds it
bit for bit against its plain PyTorch version at the shapes the mapping
path gives it, then maps the production configuration through the
port's Mapper.map_reads_paf: a 5 Mbp random genome (seed 0, k=15, w=10),
16,384 reads of 500-1000 bp (seed 1) and 64 long reads of 5-20 kb
(seed 3), with byte parity against the host oracle pipeline on every
16th short read and on every long read. Exits non-zero, printing no
result, when any phase fails or CUDA is unavailable.

Only the JAX-free host modules of minimap2_rs_tpu (config, oracle,
utils, runtime) are imported, as the port itself does; the script
asserts that jax was never loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return _median(times)


def _first_batch_anchors(mapper, reads, bucket_filter):
    """Anchors of the first batch the mapper would submit for the
    bucket picked by bucket_filter, through the port's own front half.
    Returns (chain args, window, A, B, reads in the batch)."""
    import torch

    from minimap2_rs_torch.models.mapper import LITE_WINDOW_CAP
    from minimap2_rs_torch.models.stages import sketch_to_anchors, unpack_codes2, unpack_codes4
    from minimap2_rs_torch.ops.finalize_ops import as_i32

    order = sorted(range(len(reads)), key=lambda i: len(reads[i][1]))
    groups: dict = {}
    for i in order:
        b = next(b for b in mapper.buckets if len(reads[i][1]) <= b)
        groups.setdefault(b, []).append(i)
    bucket = bucket_filter(groups)
    M, A, window, B_max = mapper._shapes_for(bucket, 1)
    window = min(window, LITE_WINDOW_CAP)
    chunk = groups[bucket][:B_max]
    B = mapper._quantize_b(len(chunk), B_max)
    lengths = torch.zeros(B, dtype=torch.int32)
    lengths[: len(chunk)] = torch.tensor([len(reads[ri][1]) for ri in chunk])
    wire_arr, nex, wire = mapper._encode([reads[ri][1] for ri in chunk], B, bucket)
    dev = mapper.device
    lengths = lengths.to(dev)
    codes = torch.from_numpy(wire_arr).to(dev)
    if wire == "2bit":
        codes = unpack_codes2(codes, lengths, torch.from_numpy(nex).to(dev))
    else:
        codes = unpack_codes4(codes)
    anc = sketch_to_anchors(
        mapper.dev_idx, codes, lengths, mapper.mid_occ, w=mapper.idx.w,
        k=mapper.idx.k, q_occ_max=mapper.mp.q_occ_max,
        q_occ_frac=mapper.mp.q_occ_frac, M=M, A=A,
    )
    args = tuple(
        as_i32(t).contiguous()
        for t in (anc["x_hi"], anc["x_lo"], anc["y_lo"], anc["y_hi"] & 0xFF)
    )
    return args, window, A, B, len(chunk)


def _kernel_vs_plain(mapper, args, window, scalars_list):
    """torch.equal of kernel and plain outputs on the same inputs, plus
    both times (ms, CUDA events, median of 5) for the first band."""
    import torch

    from minimap2_rs_torch.kernels.chain_dp import chain_dp_aux_batch
    from minimap2_rs_torch.ops.chain_ops import chain_dp_aux_batch_ref

    tab = mapper._log2_tab
    err = 0
    for scal in scalars_list:
        got = chain_dp_aux_batch(*args, scal, window, tab)
        want = chain_dp_aux_batch_ref(*args, scal, window, tab)
        torch.cuda.synchronize()
        for name, g, w in zip(("f", "cnt", "sq", "sr"), got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(
                    f"kernel != plain on {name} (bw={scal.bw}) at {bad}"
                )
            err = max(err, int((g.long() - w.long()).abs().max()))
    scal = scalars_list[0]
    ms = _time_ms(lambda: chain_dp_aux_batch(*args, scal, window, tab))
    plain_ms = _time_ms(lambda: chain_dp_aux_batch_ref(*args, scal, window, tab))
    return err, ms, plain_ms


def _parity(tag, idx, sample, lines, cp, mp):
    from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map

    host = oracle_map(idx, sample, cp, mp)
    names = {n for n, _ in sample}
    dev = [l for l in lines if l.split("\t", 1)[0] in names]
    if dev != host:
        first = next(
            (f"{d!r} != {h!r}" for d, h in zip(dev, host) if d != h),
            "line-count mismatch",
        )
        raise AssertionError(
            f"parity failure [{tag}]: {len(dev)} vs {len(host)} lines; {first}"
        )
    return len(sample)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_tpu.runtime.host import native_available
    from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads
    from minimap2_rs_torch.kernels import build as kbuild
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper

    card = _nvidia_smi()
    print(card)
    nvcc = subprocess.run([kbuild._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    print(f"native host runtime loaded: {native_available()}")

    # ---- build ------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.library()
    print(f"kernel library built in {time.perf_counter() - t0:.1f} s")
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- set-up: 5 Mbp index on the card, reads ---------------------
    cp = ChainParams.defaults_for_k(15)
    mp = MapParams()
    t0 = time.perf_counter()
    genome = random_genome(5_000_000, seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    mapper = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=1024)
    reads = [(n, s) for n, s, *_ in simulate_reads(genome, 16384, read_len=(500, 1000), seed=1)]
    lreads = [(n, s) for n, s, *_ in simulate_reads(genome, 64, read_len=(5000, 20000), seed=3)]
    di = mapper.dev_idx
    print(f"set-up {time.perf_counter() - t0:.1f} s: {idx.keys.shape[0]} keys, "
          f"dm_entry={di.dm_entry} p={di.dm_bits} S={di.dm_slots}")

    # ---- kernel against its plain version ---------------------------
    kernels = []
    bands = [mapper._scalars, mapper._scalars_wide]
    args, window, A, B, n = _first_batch_anchors(mapper, reads, lambda g: min(g))
    err, ms, plain_ms = _kernel_vs_plain(mapper, args, window, bands)
    print(f"chain kernel, headline batch B={B} A={A} window={window} (both bands equal): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    kernels.append(dict(
        name="chain_dp_aux (headline: A<1024, full window)", route="cuda",
        source="minimap2_rs_torch/csrc/chain_dp.cu",
        replaces="minimap2_rs_tpu/ops/chain_pallas.py:291",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
    ))
    largs, lwindow, lA, lB, ln = _first_batch_anchors(
        mapper, lreads, lambda g: max(g, key=lambda b: len(g[b]))
    )
    if lA < 1536 or lwindow >= lA:
        raise AssertionError(f"long-read batch shape A={lA} window={lwindow}")
    err, ms, plain_ms = _kernel_vs_plain(mapper, largs, lwindow, bands[:1])
    print(f"chain kernel, long-read batch B={lB} ({ln} reads) A={lA} window={lwindow}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    kernels.append(dict(
        name="chain_dp_aux (long reads: A>=1024, sliding window)", route="cuda",
        source="minimap2_rs_torch/csrc/chain_dp.cu",
        replaces="minimap2_rs_tpu/ops/chain_pallas.py:553",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
    ))

    # ---- headline: 16,384 reads, 1 warm + 5 timed passes -------------
    t0 = time.perf_counter()
    mapper.map_reads_paf(reads)
    torch.cuda.synchronize()
    print(f"headline warm pass {time.perf_counter() - t0:.3f} s")
    times = []
    kchain.launches = 0
    for _ in range(5):
        mapper.stats = {}
        t0 = time.perf_counter()
        blob = mapper.map_reads_paf(reads)
        times.append(time.perf_counter() - t0)
    kernels[0]["launches"] = kchain.launches
    stats = dict(mapper.stats)
    lines = blob.decode().split("\n")[:-1]
    mapped = {l.split("\t", 1)[0] for l in lines}
    aligned_bp = sum(len(s) for n, s in reads if n in mapped)
    dt = _median(times)
    print(f"headline pass times (s): {[round(t, 4) for t in times]}")
    print(f"headline median pass {dt:.4f} s, aligned {aligned_bp / dt:.1f} bp/s, "
          f"{len(lines)} PAF lines, chain kernel launches over 5 passes: {kchain.launches}")
    print(f"headline stats (last pass): {json.dumps(stats, sort_keys=True)}")
    if kchain.launches <= 0:
        raise AssertionError("the mapping path never launched the chain kernel")
    if stats.get("host_reads", 0) >= 0.01 * len(reads):
        raise AssertionError(f"host fallback on {stats.get('host_reads')} reads (>= 1%)")
    n_par = _parity("headline", idx, reads[::16], lines, cp, mp)
    print(f"headline parity vs oracle: {n_par} reads byte-identical")

    # ---- long reads: 64 reads of 5-20 kb ------------------------------
    mapper.map_reads_paf(lreads)
    torch.cuda.synchronize()
    kchain.launches = 0
    ltimes = []
    for _ in range(3):
        mapper.stats = {}
        t0 = time.perf_counter()
        lblob = mapper.map_reads_paf(lreads)
        ltimes.append(time.perf_counter() - t0)
    kernels[1]["launches"] = kchain.launches
    llines = lblob.decode().split("\n")[:-1]
    print(f"long-read pass times (s): {[round(t, 4) for t in ltimes]}, "
          f"chain kernel launches over 3 passes: {kchain.launches}")
    print(f"long-read stats (last pass): {json.dumps(mapper.stats, sort_keys=True)}")
    if kchain.launches <= 0:
        raise AssertionError("the long-read path never launched the chain kernel")
    n_par = _parity("longread", idx, lreads, llines, cp, mp)
    print(f"long-read parity vs oracle: {n_par} reads byte-identical")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
