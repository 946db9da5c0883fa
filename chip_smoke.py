"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from minimap2_rs_torch/csrc (the chain
DP's two variants in their short-read, lane and template designs, their
pruned instances in the shared-memory and template designs, the window
scan in its tiled and sequential designs, the odd-k sketch from the
wire and the prefix probe; one nvcc per source, in parallel) and maps
through the port's
Mapper.map_reads_paf:

  * lite path (default ChainParams, k=15): a 5 Mbp random genome
    (seed 0, w=10), 16,384 reads of 500-1000 bp (seed 1) and 64 long
    reads of 5-20 kb (seed 3), with byte parity against the host oracle
    on every 16th short read and on every long read;
  * general path (`align -n 1 -m 10`: min_cnt=1, min_chain_score=10) on
    the same index and reads, held against the oracle with
    max_chain_skip past any window (the device DP scores the window
    exactly), and required to emit secondary (tp:A:S) lines;
  * hifi_k19 (lite, k=19, w=10): a 2 Mbp genome (seed 11) and 128 reads
    of 2-4 kb at 1% error (seed 13), parity on all of them;
  * even_k14: the same genome at w=10, k=14, 128 reads of 500-1000 bp
    (seed 23) and 16 of 5-20 kb (seed 29): the exact-scan sketch through
    the window-scan kernel at a short and a long bucket;
  * hpc: the same genome indexed with flag=1 (k=15), 128 reads of
    500-1000 bp (seed 17);
  * skipprune: MM2T_SKIP_PRUNE=1 on the first 128 headline reads at
    batch_size=128, lite and general (-n 1 -m 10), through the pruned
    kernel instances, held against the default (pruning) oracle;
  * device index build: build_index_device of the 5 Mbp genome on the
    card at flag 0 and 1, equal to the native build;
  * CLI: `index`, then `anchors` and `chain` with --engine device on one
    long read at k=15 and k=14, equal to --engine host;
  * extension: both banded extension functions on 64 random pairs, on
    the card equal to the CPU;
  * mesh dp: MeshMapper (dp = 1) over a 1-rank NCCL group on the
    headline reads, captured (its programs hold the wire-row all_gather)
    and a graphs=False twin, in turns with the captured Mapper, all
    byte-identical, every timed stage of the captured ones a replay,
    their medians beside the lite headline phase's; one profiled pass
    of each mesh, in which every graph launch holds the NCCL work of the
    collectives its program recorded and the two meshes count the same
    collective calls and bytes;
  * CLI: `align --mesh 1` equal to `align` on the headline's FASTA, its
    MeshMapper replaying every batch after each key's first;
  * mesh sharded: a 10 Mbp genome (seed 0, k=15), 2,048 reads of
    500-1000 bp (seed 1) and 32 of 5-20 kb (seed 3), the index
    hash-range-sharded over 2 gloo ranks that share cuda:0
    (minimap2_rs_torch.parallel.ranks.spawn with share_device; NCCL
    refuses two ranks on one device, so gloo carries the collectives,
    staged through host memory, and the mesh runs with graphs=False:
    no capture can hold a host-staged collective). Each rank's shard takes the two-phase
    table (dm_entry 2); the PAF is the same on both ranks and
    byte-identical to the oracle on every 16th short read and every
    long read; each rank's collective index statistics and quantile
    equal the oracle's; each rank prints its median pass, collective
    bytes and seconds a pass, transports and launches, and holds its
    captured chain-kernel inputs to the plain versions. This stands in
    for the 100 Mbp genome on 4 cards (bench.py:475-531): ix = 2 at
    10 Mbp is the smallest layout whose shards take dm_entry 2.
  * ont_10pct: 256 reads of 1-2 kb at 10% error (seed 19) on the
    headline index, parity on all of them (bench.py:391-399);
  * tier 2 and the lazy wide pass, forced: undersized anchor slots on a
    400 kb genome send 48 or more reads to the 4x tier, and chimeras in
    an 8 kb bucket re-run in the lazy wide pass (the cases of
    tests/test_torch_mapper.py), parity on every read;
  * large: a 100 Mbp random genome (seed 7; the native build's time
    and per-stage seconds, runtime/host.last_build_stage_s), 16,384
    reads of 500-1000 bp (seed 9), parity on every 64th
    (bench.py:475-531), the median of 3 passes;
  * assembly: the reference's yardstick size (BASELINE.md), 278,413,945
    bp (seed 11) cut into 300 contigs of lognormal lengths (seed 12),
    built natively and on the card (equal; both timed), whose index
    takes the two-plane position table (over 64 sequences) and, at its
    key count, the prefix probe (no direct table under the 2 GB cap;
    the layout and table bytes printed); 16,384 reads of 500-1000 bp
    and 512 of 5-20 kb simulated contig by contig (seeds (13, mix,
    contig)) on a captured lite Mapper, parity on every 64th read of
    each mix, and those sampled reads on the general path
    (MM2T_NO_LITE) against the exact-window oracle; the medians,
    aligned bp/s, the wire flags of each mix's first pass, the lookup
    stage's card time, peak device memory and the host's peak RSS. Its
    kernel rows count its own timed passes, the prefix-probe kernel's
    (S 16) too: equal to the plain branch on every input both mixes kept,
    timed on the largest;
  * chm13: a human-sized reference, 3,117,292,070 bp (seed 11) cut into
    T2T-CHM13v2.0's 25 sequences at their lengths (past 2^31 bases, so
    the length alone refuses the packed position plane), in a child
    process (`python3 chip_smoke.py --phase chm13` runs it alone): the
    native and the device index build (equal; both timed), the .mmi
    written and read back (equal) and the mapper made from it; the
    layout and table bytes; 16,384 short and 512 long reads as in the
    assembly phase, parity on every 64th read of each, the short mix on
    all 24 nuclear chromosomes at CHM13's target lengths, the wire flags
    and host-fallback share of each mix (printed, not gated); up to 12
    long reads that the 4x tier mapped on the card, held to the oracle;
    the general-path sample; the lookup stage's card time; peak device
    memory and the child's peak RSS. It times its own four kernel rows
    and the prefix-probe kernel's (S 16, as in the assembly phase) and
    hands them to the parent;
  * chm13-hifi probe: after the chm13 child, `python3 probe_hifi.py` in
    a child of its own: the benchmark cell chm13-hifi's index (T2T-CHM13's
    lengths at k 19, the prefix probe at 128 slots) and one pool call of
    its HiFi reads on captured programs, as the cell maps it; the
    prefix-probe kernel held to the plain branch on every batch shape,
    timed on the largest, its launches those of a pass of replays;
  * bench: bench_torch.py (the port's bench.py) at a cut size, `--reads
    2048 --longread-n 64 --skip-large`, before the mesh phases (it
    fails on any parity difference or a section without its kernels'
    launches): its record must hold every key of such a run and each
    parity count (128, hifi_k19 128, hpc 128, ont_10pct 256, even_k14
    128, longread 11, skipprune 128);
  * prof: the four measuring scripts at a cut size, after the bench
    phase and before the mesh phases (each fails on other bytes, a
    missing kernel launch or a timed stage that did not replay): the
    batch-size sweep (prof_pipeline_torch.py 2048 1024 on 4,096 reads,
    byte-equal PAF), the long-read report (prof_longread_torch.py 64,
    the lane kernel launched), the stage split at the 8192 and 24576
    buckets of 64 long reads (prof_longread_stages_torch.py, the lane
    kernel launched at each), and the scaling record twice
    (scaling_bench_torch.py --dp 1: a 1-rank NCCL group in a spawned
    rank, captured, its programs replayed; --dp 2 --share-device
    --reads 512: 2 gloo ranks on the card, bytes equal to dp = 1).
Every mapping phase is byte-identical to the host oracle (default
parameters unless said otherwise).

Every single-device Mapper, and the 1-rank NCCL MeshMapper, issues its
device stages as captured programs (models/programs.py: a key's first
batch runs eagerly, its second captures a CUDA graph, later ones replay
it). Each mapping phase starts with a first pass (and, on captured
programs, a second) that keep the kernels' inputs (one per kernel,
shape class, band and capacity; outside a capture only) and are timed
and printed beside the medians; each such phase's timed passes must
then show no eager stage and a replay for every stage. The lite and
general headline, both long-read phases and the mesh dp phase also run
a twin with graphs=False, in turns with the captured one (a b b a
...): the two must give the same bytes,
and both medians and their host seconds (submit, encode, upload,
stage_issue, d2h_issue, d2h+wait, post, ...) are printed side by side.
Each mapper's timed passes count the launches per kernel and shape
apart, each replay adding the launches its capture recorded
(kernels/counts.py); every path must launch the phase's kernels, and
only the captured (main) path's counts go to the kernel rows. Each of
those ten mappers then maps one pass under torch.profiler (CUDA
activity): the card's kernels and copies and the host's launch calls
per device stage, the device busy share and the lane kernels' share of
the pass; the chain-DP and window-scan kernels in the trace must match
the pass's counted launches, and on the captured mappers the kernels of
each graph launch must match its program's recorded launches. The
captured mappers print their live programs, the seconds of each capture
and the graph pool's bytes.
Afterwards each kernel is held bit for bit against its plain PyTorch
version on those inputs (the window scan's long shape on 8 rows; the
odd-k sketch against the chain it replaces, wire unpack, sketch_positions
and compact_minimizers, then timed at the 1024-, 8192- and 24576-base
buckets' (B, L, M) on reads simulated from the headline genome, the
1024 bucket's batch also on the 4-bit wire and as int32 codes), and
the dynamic-window shape, which no mapping path launches, on the
headline's inputs at window 128; the mesh phases' rows on the inputs of
the 1-rank mesh and of sharded rank 0. A synthetic phase holds both lane
kernels against their plain versions on the edge cases (no valid
anchor, n < H, A not a multiple of the block, forced score ties, the
largest general shape: A = 11,904, H = 5000), both short-read kernels
on theirs (an empty read, n < 32 and n = A; window 64; A = 384 and 768,
full and at window 128; forced ties; positions near 2^31 - 1;
pen_skip != 0; bw 20000 with winners past the staged penalty table),
and both pruned kernels at max_chain_skip 0, 1 and 25 on theirs (decoy
clusters whose marks land a chunk or more back, with and without
boosters, long enough to carry the skip counter across chunks, and at 31
a chunk without a beat; chains whose predecessors sit at the window's
edge; colinear runs with n < 32 and n = A; forced ties; anchors out of
reference order, dr < 0; A = 1152 with B = 1).

Every kernel row gets its bound from the inputs it was timed on: the
candidate pairs the DP scores (a pruned row: only those its walk visits
before the break; the window scan: the positions), times the operations
per pair counted from the kernel source, over the card's float32 rate,
against the bytes each input read once and each output written once
over its memory rate; the larger names what bounds it.
A kernel's time is the median of 5 CUDA-event timings of 10
back-to-back launches, divided by 10, so it holds no host cost of a call.
Every chain row names its design and gives `rows`, the longest read's
valid rows in the timed input, and `us_per_row` (ms x 1000 / rows, the
row walk's step latency); the short-read, lane and pruned rows also time
the previous design, the warp-per-read template, on the same inputs
(prev_design_ms), and the window-scan rows the sequential design.

Exits non-zero, printing no result, when any phase fails or CUDA is
unavailable.

The script imports nothing of minimap2_rs_tpu: the host oracle, config,
sequence simulator and native runtime are the port's own copies
(minimap2_rs_torch.oracle, .config, .utils, .runtime). The native host
runtime is built from the port's source (build/host/) and must load: a
silent pure-Python postprocess would hide the production path. The
script asserts that jax was never loaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from minimap2_rs_torch.utils.measure import (
    CHAIN_OPS_PER_PAIR,
    KERNEL_INNER,
    chain_bound,
    device_ms,
    median,
    nvidia_smi,
    parity,
    scan_bound,
    sketch_bound,
    time_ms,
    valid_rows,
)


# the kernel rows' note on library_ms
LIBRARY_NOTE = ("no single PyTorch call computes a sequential chaining DP, a window scan or a "
                "minimizer sketch")


def _kernel_vs_plain(entries, tab, aux: bool, window=None, plain_reps: int = 5):
    """torch.equal of kernel and plain outputs on every captured input
    (entries: [(args, scalars, window, max_chain_skip)]; `window`
    overrides the captured one), plus both times (ms, CUDA events,
    median) on the largest normal-band launch, which is returned too as
    (args, scalars, window, max_chain_skip). aux picks the variant:
    (f, cnt, sq, sr) or (f, prev). Long shapes time the plain version
    with fewer repeats: at plain_reps 1, its run in the comparison."""
    import torch

    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops import chain_ops

    if aux:
        fn, ref = kchain.chain_dp_aux_batch, chain_ops.chain_dp_aux_batch_ref
        names = ("f", "cnt", "sq", "sr")
    else:
        fn, ref = kchain.chain_dp_batch, chain_ops.chain_dp_batch_ref
        names = ("f", "prev")
    bw0 = entries[0][1].bw
    largest = max((e for e in entries if e[1].bw == bw0), key=lambda e: e[0][0].numel())
    err = 0
    for entry in entries:
        args, scal, win, skip = entry
        win = window or win
        got = fn(*args, scal, win, tab, skip)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = ref(*args, scal, win, tab, max_chain_skip=skip)
        t1.record()
        torch.cuda.synchronize()
        if entry is largest:
            plain_ms = t0.elapsed_time(t1)
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(
                    f"kernel != plain on {name} (bw={scal.bw}, A={args[0].shape[1]}) "
                    f"at {bad}"
                )
            err = max(err, int((g.long() - w.long()).abs().max()))
    args, scal, win, skip = largest
    win = window or win
    ms = time_ms(lambda: fn(*args, scal, win, tab, skip), inner=KERNEL_INNER)
    if plain_reps > 1:
        # the comparison above has just run the plain version on these inputs
        plain_ms = time_ms(lambda: ref(*args, scal, win, tab, max_chain_skip=skip),
                           reps=plain_reps, warm=False)
    return err, ms, plain_ms, (args, scal, win, skip)


def _scan_vs_plain(entries, max_rows=None):
    """The window-scan kernel, and its sequential design, against the
    plain version on every captured input (entries: [(args, w, k)], each
    cut to its first max_rows rows): torch.equal, then the times (ms,
    CUDA events; the kernels the median of 5, the plain loop one run) on
    the largest entry: (kernel, its device time (device_ms), sequential
    design, plain, its inputs)."""
    import torch

    from minimap2_rs_torch.kernels.window_scan import sequential_scan, window_scan
    from minimap2_rs_torch.ops.sketch_scan import _window_scan_ref

    cut = [(tuple(a[:max_rows].contiguous() for a in args), w, k)
           for args, w, k in entries]
    for args, w, k in cut:
        want = _window_scan_ref(*args[:4], w, k, args[4])
        for fn in (window_scan, sequential_scan):
            got = fn(*args[:4], w, k, args[4])
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                raise AssertionError(f"{fn.__name__} != plain (L={args[0].shape[1]}) at {bad}")
    args, w, k = max(cut, key=lambda e: e[0][0].numel())
    ms = time_ms(lambda: window_scan(*args[:4], w, k, args[4]), inner=KERNEL_INNER)
    card_ms = device_ms(lambda: window_scan(*args[:4], w, k, args[4]))
    prev_ms = time_ms(lambda: sequential_scan(*args[:4], w, k, args[4]), inner=KERNEL_INNER)
    # the comparison above has just run the plain loop on these inputs
    plain_ms = time_ms(lambda: _window_scan_ref(*args[:4], w, k, args[4]), reps=1,
                        warm=False)
    return ms, card_ms, prev_ms, plain_ms, args


def _sketch_plain(rows, lengths, nex, wire, w, k, M):
    """The chain the odd-k sketch kernel replaces, on the card's tensors."""
    from minimap2_rs_torch.ops.sketch import compact_minimizers, sketch_positions, wire_codes

    codes = wire_codes(rows, lengths, nex, wire)
    return compact_minimizers(*sketch_positions(codes, lengths, w, k), M)


def _sketch_equal(tag, args, wire, w, k, M):
    """The sketch kernel against its plain chain on one input: torch.equal
    on every output, or AssertionError."""
    import torch

    from minimap2_rs_torch.kernels.sketch import sketch_minimizers

    got = sketch_minimizers(*args, wire, w, k, M)
    want = _sketch_plain(*args, wire, w, k, M)
    torch.cuda.synchronize()
    for name, g, x in zip(("cks", "cps", "n_mini", "mini_ovf"), got, want):
        if not torch.equal(g, x):
            bad = (g != x).nonzero()[:5].tolist()
            raise AssertionError(f"[{tag}] sketch kernel {name} != plain chain at {bad}")


def _sketch_rows(mapper, genome, captured: dict, total: dict) -> list:
    """The odd-k sketch kernel held to its plain chain on every input the
    mapping phases captured, then at the 1024-, 8192- and 24576-base
    buckets' (B, L, M): B reads of L/2-L bases simulated from `genome`
    (seed = L) through the mapper's own encoder, equal on the card, timed
    (kernel and plain chain, CUDA events) beside the bound. The 1024
    bucket's batch is also held on the 4-bit wire and as int32 codes.
    Returns the kernel rows."""
    import numpy as np
    import torch

    from minimap2_rs_torch.kernels.sketch import sketch_minimizers
    from minimap2_rs_torch.ops.sketch import unpack_codes2, unpack_codes4
    from minimap2_rs_torch.utils.seqsim import simulate_reads

    for (key, L), (args, wire, w, k, M) in sorted(captured.items()):
        _sketch_equal(f"{key} L={L}", args, wire, w, k, M)
    print(f"sketch: every captured input equal to the plain chain: "
          f"{sorted(captured)}")
    w, k = mapper.idx.w, mapper.idx.k
    rows = []
    for bucket in (1024, 8192, 24576):
        M, _A, _window, B = mapper._shapes_for(bucket, 1)
        seqs = [s[:bucket] for _n, s, *_ in simulate_reads(
            genome, B, read_len=(bucket // 2, bucket), seed=bucket)]
        wire_arr, nex, wire = mapper._encode(seqs, B, bucket)
        lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32, device="cuda")
        rows_t = torch.from_numpy(wire_arr).cuda()
        nex_t = torch.from_numpy(nex).cuda() if nex is not None else None
        args = (rows_t, lengths, nex_t)
        tag = f"sketch {bucket}"
        _sketch_equal(tag, args, wire, w, k, M)
        if bucket == 1024:
            codes = (unpack_codes2(rows_t, lengths, nex_t) if wire == "2bit"
                     else unpack_codes4(rows_t))
            packed4 = (codes[:, 0::2] | codes[:, 1::2] << 4).to(torch.uint8).contiguous()
            _sketch_equal(f"{tag} 4bit", (packed4, lengths, None), "4bit", w, k, M)
            _sketch_equal(f"{tag} nt4", (codes.contiguous(), lengths, None), "nt4", w, k, M)
        ms = time_ms(lambda: sketch_minimizers(*args, wire, w, k, M), inner=KERNEL_INNER)
        plain_ms = time_ms(lambda: _sketch_plain(*args, wire, w, k, M), reps=3)
        bound_ms, bound_by = sketch_bound(*args, wire, w, M)
        key = f"sketch/{'long' if bucket > 4096 else 'short'}"
        n_nex = int((nex < B * bucket).sum()) if nex is not None else None
        print(f"sketch ({bucket} bucket): (B, L, M) = {(B, bucket, M)}, w={w}, k={k}, "
              f"wire {wire} ({n_nex} Ns listed), all four outputs equal to the plain chain; "
              f"kernel {ms:.4f} ms, plain chain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}); launches of {key} {total.get(key, 0)}")
        rows.append(dict(
            name=f"sketch ({bucket}-base bucket)", route="cuda",
            source="minimap2_rs_torch/csrc/sketch.cu",
            replaces="minimap2_rs_tpu/ops/sketch.py:163 (with models/stages.py unpack_codes2 "
                     "and ops/sketch.py:366)",
            launches=total.get(key, 0), max_abs_err=0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library_note=LIBRARY_NOTE, design="block per read",
            shape=key.split("/")[1], timed_at=(B, bucket, M), wire=wire,
            on_main_path=total.get(key, 0) > 0,
        ))
    return rows


def _synthetic_chains(rng, B, A, n_of, r_off=0, q_off=0, step=40, jitter=3):
    """Per read n_of(b) anchors sorted like the mapper's (colinear runs
    on two strands from positions r_off and q_off, steps below `step`
    with query jitter up to `jitter`, 5% exact duplicates), padding
    after."""
    import numpy as np

    cols = np.stack([np.full((B, A), -1, np.int64), np.full((B, A), -1, np.int64),
                     np.full((B, A), -1, np.int64), np.full((B, A), 255, np.int64)])
    for b in range(B):
        n = n_of(b)
        g, r, q = [], [], []
        while len(g) < n:
            m = int(rng.integers(5, 60))
            strand = int(rng.integers(0, 2)) << 31
            r0 = r_off + int(rng.integers(0, 200_000))
            q0 = q_off + int(rng.integers(0, 20_000))
            steps = rng.integers(1, step, size=m)
            g += [strand] * m
            r += list(r0 + np.cumsum(steps))
            jit = rng.integers(-jitter, jitter + 1, size=m)
            q += list(q0 + np.cumsum(np.maximum(steps + jit, 1)))
        g, r, q = np.array(g[:n]), np.array(r[:n]), np.array(q[:n])
        dup = rng.random(n) < 0.05
        g, r, q = np.r_[g, g[dup]][:n], np.r_[r, r[dup]][:n], np.r_[q, q[dup]][:n]
        o = np.lexsort((q, r, g))
        cols[0, b, :n], cols[1, b, :n], cols[2, b, :n] = g[o], r[o], q[o]
        cols[3, b, :n] = 15
    return cols


def _synthetic_ties(B, A):
    """Blocks of four anchors, one group each, where the fourth scores 43
    from the second and the third alike (bw 60, no linear penalties): the
    larger j must win."""
    import numpy as np

    cols = np.stack([np.full((B, A), -1, np.int64), np.full((B, A), -1, np.int64),
                     np.full((B, A), -1, np.int64), np.full((B, A), 255, np.int64)])
    nb = A // 4
    blk = np.arange(nb)
    for b in range(B):
        cols[0, b, :4 * nb] = np.repeat(blk, 4)
        cols[1, b, :4 * nb] = np.tile([0, 100, 250, 265], nb) + 1000 * np.repeat(blk, 4)
        cols[2, b, :4 * nb] = np.tile([0, 100, 150, 215], nb)
        cols[3, b, :4 * nb] = np.tile([15, 15, 30, 15], nb)
    return cols


def _synthetic_decoys(rng, B, n_blocks, boosters=0, size=(28, 40), A=None):
    """Rows of [backbone, decoys, backbone, ...] blocks: clusters of `size`
    decoys on a far diagonal inside the band are admissible but never
    beat, and the backbone's marks make them count as skips; each backbone
    anchor's predecessor is the previous one, a chunk or more back.
    `boosters` on-diagonal beats a cluster, at random places. Padding to
    A."""
    import numpy as np

    rows = []
    for _b in range(B):
        rp, qp, r0 = [], [], 1000
        for _t in range(n_blocks):
            n_decoy = int(rng.integers(*size))
            diag = int(rng.integers(420, 480))
            rp += [r0] + [r0 + 10 + u for u in range(n_decoy)]
            qp += [r0] + [r0 + 10 + u + diag for u in range(n_decoy)]
            for u in rng.choice(n_decoy, size=boosters, replace=False):
                rp.append(r0 + 10 + int(u))
                qp.append(r0 + 10 + int(u))
            r0 += 10 + n_decoy + int(rng.integers(450, 520))
        o = np.argsort(np.array(rp), kind="stable")
        rows.append((np.array(rp)[o], np.array(qp)[o]))
    A = A or max(len(r) for r, _ in rows)
    cols = np.stack([np.full((B, A), -1, np.int64), np.zeros((B, A), np.int64),
                     np.zeros((B, A), np.int64), np.full((B, A), 255, np.int64)])
    for b, (rp, qp) in enumerate(rows):
        n = min(len(rp), A)
        cols[0, b, :n], cols[1, b, :n], cols[2, b, :n], cols[3, b, :n] = 0, rp[:n], qp[:n], 15
    return cols


def _synthetic_unsorted(rng, B, A):
    """Read 0: a colinear chain whose every 10th anchor steps back one base
    in r (dr = -1 to its predecessor, which then wins the tie with the
    anchor before); the others colinear runs shuffled out of order."""
    import numpy as np

    cols = _synthetic_chains(rng, B, A, lambda b: A - 30 * b, step=8)
    for b in range(1, B):
        n = A - 30 * b
        cols[:, b, :n] = cols[:, b, rng.permutation(n)]
    cols[0, 0], cols[3, 0] = 0, 15
    cols[1, 0] = 1000 + np.cumsum(np.where(np.arange(A) % 10 == 9, -1, 10))
    cols[2, 0] = 1000 + 10 * np.arange(A)
    return cols


def _synthetic_interleaved(n_chains, A):
    """One read of n_chains colinear chains on diagonals 1000 apart (no
    pair across them admissible), interleaved so that each anchor's only
    predecessor lies n_chains slots back."""
    import numpy as np

    t, c = np.divmod(np.arange(A), n_chains)
    r = 1000 + 40 * t + c
    return np.stack([np.zeros((1, A), np.int64), r[None], (r + 1000 * c)[None],
                     np.full((1, A), 15, np.int64)])


def _synthetic_cases():
    """{design: [(name, cols, scalars, lite window, general window,
    max_chain_skips)]}: the edge cases no mapping phase guarantees, for
    the lane, the short-read and the pruned kernels."""
    import numpy as np

    from minimap2_rs_torch.config import ChainParams
    from minimap2_rs_torch.ops import chain_ops

    scal = chain_ops.chain_scalars_from_params(ChainParams.defaults_for_k(15))
    tie_scal = chain_ops.chain_scalars_from_params(
        ChainParams.defaults_for_k(15, bw=60, chn_pen_gap=0.0, chn_pen_skip=0.0))
    # the short-read kernel's other instances: pen_skip != 0, and a band
    # past its staged table whose winners have large dd (no gap penalty)
    skip_scal = chain_ops.chain_scalars_from_params(
        ChainParams.defaults_for_k(15, chn_pen_skip=0.2))
    wide_scal = chain_ops.chain_scalars_from_params(
        ChainParams.defaults_for_k(15, bw=20000, chn_pen_gap=0.0, chn_pen_skip=0.001))
    rng = np.random.default_rng(59)
    chains = lambda *a, **k: _synthetic_chains(rng, *a, **k)
    exact = (None,)
    lane = [
        ("n = 0", chains(4, 1100, lambda b: 0), scal, 1024, 5000, exact),
        ("n < H", chains(8, 4480, lambda b: int(rng.integers(1, 1000))), scal, 1024, 4480,
         exact),
        ("A = 2077, not a multiple of 256",
         chains(8, 2077, lambda b: 2077 if b % 2 else int(rng.integers(1000, 2077))),
         scal, 1024, 5000, exact),
        ("forced ties (A = 1100)", _synthetic_ties(4, 1100), tie_scal, 1024, 5000, exact),
        ("largest general shape (A = 11904, H = 5000)",
         chains(4, 11904, lambda b: 11904 - 700 * b), scal, 5000, 5000, exact),
    ]
    rng = np.random.default_rng(61)
    ns = [0, 20, 256, 255, 100, 31, 200, 1]  # an empty read, n < 32, n = A
    top = 2**31 - 1
    short = [
        ("n = 0, n < 32, n = A (A = 256)", chains(8, 256, lambda b: ns[b]), scal, 256, 5000,
         exact),
        ("window 64 (A = 256)", chains(8, 256, lambda b: int(rng.integers(1, 257))), scal,
         64, 64, exact),
        ("A = 384", chains(8, 384, lambda b: 384 - 40 * b), scal, 384, 5000, exact),
        ("A = 768, the 4x tier", chains(8, 768, lambda b: 768 - 90 * b), scal, 768, 5000,
         exact),
        ("A = 768, window 128", chains(8, 768, lambda b: 768 - 90 * b), scal, 128, 128,
         exact),
        ("forced ties (A = 256)", _synthetic_ties(4, 256), tie_scal, 256, 5000, exact),
        ("positions near 2^31 - 1 (A = 256)",
         chains(8, 256, lambda b: 256, r_off=top - 260_000, q_off=top - 30_000), scal,
         256, 5000, exact),
        ("pen_skip != 0 (A = 256)", chains(8, 256, lambda b: 256 - 20 * b), skip_scal,
         256, 5000, exact),
        ("bw 20000, dd past the staged table (A = 256)",
         chains(8, 256, lambda b: 256 - 20 * b, step=3000, jitter=2000), wide_scal, 256,
         5000, exact),
    ]
    rng = np.random.default_rng(67)
    skips = (0, 1, 25)
    smem = [
        ("decoys, marks a chunk or more back", _synthetic_decoys(rng, 8, 5), scal, 5000,
         5000, skips),
        ("decoys with boosters, window 64", _synthetic_decoys(rng, 8, 5, boosters=1),
         scal, 64, 64, skips),
        ("long decoy clusters, two boosters each (the counter carried across chunks)",
         _synthetic_decoys(np.random.default_rng(0), 4, 5, boosters=2, size=(50, 70)), scal,
         5000, 5000, skips),
        ("decoys, a chunk without a beat", _synthetic_decoys(np.random.default_rng(1), 4, 5),
         scal, 5000, 5000, (31,)),
        ("interleaved chains, each predecessor at its window's edge (window 8)",
         _synthetic_interleaved(8, 256), scal, 8, 8, skips),
        ("colinear runs, n = 0, n < 32, n = A (A = 256)", chains(8, 256, lambda b: ns[b]),
         scal, 256, 5000, skips),
        ("forced ties (A = 256)", _synthetic_ties(4, 256), tie_scal, 256, 5000, skips),
        ("anchors out of reference order, dr < 0 (A = 128)", _synthetic_unsorted(rng, 4, 128),
         scal, 128, 5000, skips),
        ("A = 1152, B = 1", _synthetic_decoys(rng, 1, 40, boosters=1, A=1152), scal,
         5000, 5000, skips),
    ]
    return {"lane": lane, "short": short, "smem": smem}


def _synthetic_phase(tab_default, want_design, cases):
    """Both variants against their plain versions on `cases` (see
    _synthetic_cases); each call must take `want_design` and be
    torch.equal to the plain version."""
    import numpy as np
    import torch

    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops import chain_ops

    dev = torch.device("cuda")
    smem_bytes = {"lane": lambda A, H, aux: kchain.lane_ring_bytes(H, aux),
                  "short": lambda A, H, aux: kchain.short_block_bytes(A, aux),
                  "smem": lambda A, H, aux: kchain.prune_block_bytes(A, aux)}[want_design]
    for name, cols, sc, win_lite, win_gen, skips in cases:
        args = tuple(torch.from_numpy(c.astype(np.uint32).view(np.int32).copy()).to(dev)
                     for c in cols)
        tab = (tab_default if tab_default.shape[0] > sc.bw
               else chain_ops.log2_table(sc.bw + 1).to(dev))
        A = args[0].shape[1]
        for aux, win in ((True, win_lite), (False, win_gen)):
            fn = kchain.chain_dp_aux_batch if aux else kchain.chain_dp_batch
            ref = chain_ops.chain_dp_aux_batch_ref if aux else chain_ops.chain_dp_batch_ref
            for skip in skips:
                if kchain.design(A, win, aux, skip) != want_design:
                    raise AssertionError(f"synthetic {name}: not a {want_design}-design shape")
                got = fn(*args, sc, win, tab, skip)
                want = ref(*args, sc, win, tab, max_chain_skip=skip)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        bad = (g != w).nonzero()[:5].tolist()
                        raise AssertionError(f"synthetic {name} (aux={aux}, skip={skip}): "
                                             f"{want_design} kernel != plain at {bad}")
                n_win = int((want[1] >= (2 if aux else 0)).sum())
                print(f"synthetic {want_design} {'aux' if aux else '(f, prev)'} [{name}"
                      f"{'' if skip is None else f', max_chain_skip {skip}'}]: (B, A) = "
                      f"{tuple(args[0].shape)}, H = {min(win, A)}, shared memory "
                      f"{smem_bytes(A, min(win, A), aux)} B: equal to the plain version "
                      f"({n_win} chained rows)")


def _agree(idx, sample, lines, cp, mp) -> int:
    """Reads of `sample` whose lines equal the oracle's under cp."""
    from minimap2_rs_torch.oracle.pipeline import align_read

    by_name: dict = {}
    for l in lines:
        by_name.setdefault(l.split("\t", 1)[0], []).append(l)
    mid_occ = max(idx.calc_mid_occ(mp.frac_top_repetitive), mp.mid_occ_floor)
    return sum(
        by_name.get(n, []) == align_read(idx, n, s, cp, mp, mid_occ=mid_occ)
        for n, s in sample
    )


def _count_where(lines, pred) -> int:
    return sum(1 for l in lines if pred(l))


def _is_secondary(line: str) -> bool:
    return "\ttp:A:S\t" in line


def _s2(line: str) -> int:
    return int(line.split("\ts2:i:", 1)[1].split("\t", 1)[0])


class _OracleRescues:
    """Counts the oracle's wide-band rescue decisions while it runs: the
    re-chain of rescue_long_join is the oracle's only call of
    lchain.chain_dp_all at a band other than cp.bw."""

    def __init__(self, cp):
        self.bw, self.n = cp.bw, 0

    def __enter__(self):
        from minimap2_rs_torch.oracle import lchain

        self._orig = orig = lchain.chain_dp_all

        def counted(anchors, p):
            self.n += p.bw != self.bw
            return orig(anchors, p)

        lchain.chain_dp_all = counted
        return self

    def __exit__(self, *exc):
        from minimap2_rs_torch.oracle import lchain

        lchain.chain_dp_all = self._orig


def _kernel_modules():
    from minimap2_rs_torch.kernels import chain_dp, probe, sketch, window_scan

    return chain_dp, window_scan, sketch, probe


def _counted(tag, fn, keys, total):
    """Run fn() with every launch count set to 0 just before it and read
    just after; the counts are added to `total` (unless None), and the
    run fails unless each of `keys` (kernel/shape) launched. Returns
    (fn(), launches)."""
    mods = _kernel_modules()
    for m in mods:
        m.reset_launches()
    out = fn()
    launches = {k: v for m in mods for k, v in m.launches.items() if v}
    for k, v in (launches.items() if total is not None else ()):
        total[k] = total.get(k, 0) + v
    for key in keys:
        if not launches.get(key):
            raise AssertionError(f"[{tag}] the path never launched {key}")
    return out, launches


@contextlib.contextmanager
def _capturing():
    """While the block runs, every kernel wrapper keeps the inputs of its
    first launch per kernel, shape class, band and capacity; yields the
    dict that holds them once the block has ended."""
    mods = _kernel_modules()
    caps = [{} for _ in mods]
    for m, c in zip(mods, caps):
        m.captured = c
    captured: dict = {}
    try:
        yield captured
    finally:
        for m, c in zip(mods, caps):
            m.captured = None
            captured.update(c)


# the stats that show which path issued a pass's device stages
PROGRAM_STATS = ("device_stages", "eager_stages", "graph_captures", "graph_replays", "capture")
# the host seconds of a pass printed for each path, side by side
HOST_STATS = ("submit", "encode", "upload", "stage_issue", "d2h_issue", "d2h+wait", "post",
              "wide", "tier2", "rescue")


def _program_check(tag, mapper, summed: dict) -> None:
    """The timed passes' stage accounting (Mapper.stats summed over them):
    a mapper with captured programs issued every device stage as a replay
    (no eager stage, a replay for every stage); an eager one issued every
    stage eagerly and replayed none."""
    n = summed.get("device_stages", 0)
    if mapper.programs is not None:
        ok = summed.get("eager_stages", 0) == 0 and summed.get("graph_replays", 0) >= n > 0
    else:
        ok = summed.get("eager_stages", 0) == n > 0 and not summed.get("graph_replays")
    if not ok:
        raise AssertionError(f"[{tag}] stages of the timed passes: " + json.dumps(
            {k: summed.get(k, 0) for k in PROGRAM_STATS}))


def _programs_line(mapper) -> str:
    """A captured mapper's programs: keys, capture seconds per key and the
    bytes its graphs' shared pool grew by."""
    pc = mapper.programs
    if pc is None:
        return "eager (no programs)"
    secs = [round(v, 4) for v in pc.capture_s]
    return (f"{len(pc.programs)} live programs (capture s of each capture {secs}), graph "
            f"pool {pc.pool_bytes} bytes")


def _map_phase(tag, mappers, reads, passes, keys, total, flags=None):
    """Warm passes of each mapper (a Mapper, or {label: Mapper} of mappers
    that must give the same bytes; the first is the main path): one, and
    for a mapper with captured programs a second (a key's first batch
    runs eagerly, its second captures it), both keeping the kernels'
    inputs (_capturing) and timed, as the first and second pass (a
    _FlagCounts given as `flags` counts the first mapper's first); then
    `passes` timed passes of each, in turns (a b b a ...). Each mapper's
    timed passes count their launches apart (_counted; each must launch
    every one of `keys`) and have their stage accounting checked
    (_program_check); only the first mapper's launches go to `total`.
    Returns (PAF lines of the last pass, {label: {"times", "stats" (last
    pass), "summed" (PROGRAM_STATS over the timed passes), "launches",
    "warm" (s)}}, captured inputs)."""
    import torch

    if not isinstance(mappers, dict):
        mappers = {"captured" if mappers.programs is not None else "eager": mappers}
    labels = list(mappers)
    runs = {label: {"times": [], "summed": {}, "launches": {}, "warm": []}
            for label in labels}
    with _capturing() as captured:
        for label in labels:
            m = mappers[label]
            for w in range(2 if m.programs is not None else 1):
                counting = (flags if flags and w == 0 and label == labels[0]
                            else contextlib.nullcontext())
                t1 = time.perf_counter()
                with counting:
                    m.map_reads_paf(reads)
                torch.cuda.synchronize()
                runs[label]["warm"].append(time.perf_counter() - t1)
            print(f"{tag} ({label}) first and second pass (s): "
                  f"{[round(t, 4) for t in runs[label]['warm']]}")
    blobs = {}
    for p in range(passes):
        for label in (labels if p % 2 == 0 else labels[::-1]):
            m, run = mappers[label], runs[label]
            m.stats = {}
            t1 = time.perf_counter()
            blobs[label], got = _counted(f"{tag}, {label}",
                                         lambda m=m: m.map_reads_paf(reads), [], None)
            run["times"].append(time.perf_counter() - t1)
            run["stats"] = dict(m.stats)
            for k in PROGRAM_STATS:
                run["summed"][k] = run["summed"].get(k, 0) + m.stats.get(k, 0)
            for k, v in got.items():
                run["launches"][k] = run["launches"].get(k, 0) + v
    for label in labels[1:]:
        if blobs[label] != blobs[labels[0]]:
            a, b = (blobs[x].decode().split("\n") for x in (labels[0], label))
            first = next((f"{x!r} != {y!r}" for x, y in zip(a, b) if x != y),
                         f"line counts {len(a)} vs {len(b)}")
            raise AssertionError(f"[{tag}] {label} != {labels[0]}: {first}")
    lines = blobs[labels[0]].decode().split("\n")[:-1]
    for label in labels:
        run, m = runs[label], mappers[label]
        for key in keys:
            if not run["launches"].get(key):
                raise AssertionError(f"[{tag}, {label}] the path never launched {key}")
        _program_check(f"{tag}, {label}", m, run["summed"])
        print(f"{tag} ({label}) pass times (s): {[round(t, 4) for t in run['times']]}, "
              f"median {median(run['times']):.4f}; stages over the timed passes "
              f"{json.dumps(run['summed'])}; {_programs_line(m)}")
        print(f"{tag} ({label}) stats (last pass): {json.dumps(run['stats'], sort_keys=True)}")
        print(f"{tag} ({label}) kernel launches over {passes} timed passes: "
              f"{run['launches']}")
    for k, v in runs[labels[0]]["launches"].items():
        total[k] = total.get(k, 0) + v
    if len(labels) > 1:
        print(f"{tag}: {' == '.join(labels)}, {len(lines)} PAF lines byte-identical; median "
              f"pass " + ", ".join(f"{x} {median(runs[x]['times']):.4f} s" for x in labels)
              + "; first pass " + ", ".join(f"{x} {runs[x]['warm'][0]:.4f} s" for x in labels)
              + "; last pass " + json.dumps({k: [runs[x]["stats"].get(k) for x in labels]
                                             for k in HOST_STATS}))
    return lines, runs, captured


# the lite wire's per-read flags (ops/finalize_ops.FIELDS)
WIRE_FLAGS = ("mini_ovf", "anc_ovf", "win_ovf", "rescue")


class _FlagCounts:
    """While open, counts the reads of the lite path's first-round rows
    (Mapper._postprocess_lite in modes "normal" and "lazy": the rows of
    the first device call of each read, before the wide pass and the 4x
    tier) that carry each of WIRE_FLAGS: `n` {flag: reads}, and
    `overflow`, the reads with any of the three overflow flags, which the
    4x tier takes."""

    def __init__(self):
        self.n = dict.fromkeys(WIRE_FLAGS, 0)
        self.overflow = 0

    def __enter__(self):
        from minimap2_rs_torch.models.mapper import Mapper
        from minimap2_rs_torch.ops.finalize_ops import FIELDS

        col = [FIELDS.index(f) for f in WIRE_FLAGS]
        self._orig = orig = Mapper._postprocess_lite

        def counted(m, reads, chunk, fields, results, mode="normal"):
            if mode in ("normal", "lazy"):
                set_ = fields[:len(chunk)][:, col] != 0
                for f, c in zip(WIRE_FLAGS, set_.sum(axis=0).tolist()):
                    self.n[f] += c
                self.overflow += int(set_[:, :3].any(axis=1).sum())
            return orig(m, reads, chunk, fields, results, mode=mode)

        Mapper._postprocess_lite = counted
        return self

    def __exit__(self, *exc):
        from minimap2_rs_torch.models.mapper import Mapper

        Mapper._postprocess_lite = self._orig


def _forced_phases(cp, mp, total) -> None:
    """The 4x tier and the lazy wide pass on captured programs, forced
    (the cases of tests/test_torch_mapper.py): 240 reads of 500-1000 bp
    and 8 chimeras (halves 200 kb apart) on a 400 kb genome (seed 42)
    with undersized slots (anchor_frac 0.04), which send 48 or more reads
    to the 4x tier and switch some to the wide band on the device; and 3
    reads of 5-8 kb and 3 chimeras (halves 300 kb apart) in an 8 kb
    bucket (A >= 1024) on another (seed 45), which re-run in the lazy
    wide pass. Parity with the oracle on every read."""
    import numpy as np

    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    for tag, seed, kw in (
        ("tier2 forced", 42, dict(buckets=(1024,), batch_size=64, mini_frac=0.25,
                                  anchor_frac=0.04)),
        ("lazy wide pass forced", 45, dict(buckets=(8192,), batch_size=8)),
    ):
        g = random_genome(400_000, seed=seed)
        idx = build_index_native([("chrR", g)], IndexParams())
        rng = np.random.default_rng(seed + 2)
        if seed == 42:
            rl = [(n, s) for n, s, *_ in simulate_reads(g, 240, read_len=(500, 1000),
                                                        seed=43)]
            rl += [(f"chim{c}", g[a: a + 400] + g[a + 200_000: a + 200_400])
                   for c, a in enumerate(rng.integers(0, 150_000, size=8).tolist())]
        else:
            rl = [(n, s) for n, s, *_ in simulate_reads(g, 3, read_len=(5000, 8000),
                                                        seed=46)]
            rl += [(f"lchim{c}", g[a: a + 3000] + g[a + 300_000: a + 303_000])
                   for c, a in enumerate(rng.integers(0, 80_000, size=3).tolist())]
        m = Mapper.from_oracle_index(idx, cp, mp, device="cuda", **kw)
        lines, runs, _c = _map_phase(tag, m, rl, 1, [], total)
        st = runs["captured"]["stats"]
        if st.get("wide_reads", 0) == 0 or (seed == 42 and st.get("tier2_reads", 0) < 48):
            raise AssertionError(f"[{tag}] tier2_reads {st.get('tier2_reads')}, "
                                 f"wide_reads {st.get('wide_reads')}")
        n_par = parity(tag, idx, rl, lines, cp, mp)
        print(f"{tag} parity vs oracle: {n_par} reads byte-identical; tier2_reads "
              f"{st.get('tier2_reads')}, wide_reads {st.get('wide_reads')}")


# launch-key and kernel-name prefixes
KERNEL_FAMILIES = ("chain_dp", "window_scan", "sketch", "probe_prefix")


def _families(keys) -> dict:
    """The kernel launches among `keys` (launch keys or kernel names) per
    family."""
    out = dict.fromkeys(KERNEL_FAMILIES, 0)
    for k in keys:
        for fam in KERNEL_FAMILIES:
            out[fam] += fam in k
    return out


def _profile_pass(tag, mapper, reads, trace_dir: Path) -> dict:
    """One more pass of `reads` under torch.profiler (CUDA activity; after
    a warm-up pass under it whose events are dropped),
    read from its chrome trace: the card's kernels and copies, and the
    host's runtime calls that launch or copy, each per device stage of
    the pass; the device busy share (the union of the card's activity
    over the pass's wall time); the lane kernels' summed time and share
    of the pass. The chain-DP and window-scan kernels the card ran must
    match the launches counted in the pass; on a captured mapper, the
    kernels of each graph launch must match the launches its program
    recorded at capture (kernels/counts.py), replay by replay. A graph
    launch whose program recorded collectives (a MeshMapper's) must hold
    the card's work of each: an NCCL kernel, or on a 1-rank group the
    device-to-device copy NCCL issues in its place (in a graph, a DtoD
    copy or a `memcpy*` kernel; the stage's own copies count too, so this
    bounds the collectives from below only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from minimap2_rs_torch.kernels import counts

    mods = _kernel_modules()
    for m in mods:
        m.reset_launches()
    replays = []
    orig_replay = counts.replay

    def replay(recorded):
        # the launch keys, and the collectives (deferred by Mesh._run)
        replays.append(_families(e[1] for e in recorded if not callable(e)))
        collectives.append(sum(map(callable, recorded)))
        orig_replay(recorded)

    collectives = []

    counts.replay = replay
    try:
        # a warm-up pass under the profiler first, its events dropped: as
        # the profiler's first active step, the pass lost kernel records of
        # its first graph launch (the general long-read pass its sketch
        # kernel, in two runs)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
            mapper.map_reads_paf(reads)
            torch.cuda.synchronize()
            prof.step()
            for m in mods:
                m.reset_launches()
            replays.clear()
            collectives.clear()
            mapper.stats = {}
            t0 = time.perf_counter()
            mapper.map_reads_paf(reads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        counts.replay = orig_replay
    counted = {k: v for m in mods for k, v in m.launches.items() if v}
    path = trace_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    n = mapper.stats["device_stages"]
    kinds, api, spans, lane_us = {}, {}, [], 0.0
    by_launch: dict = {}  # correlation id -> kernel names
    copies: dict = {}  # correlation id -> device-to-device copies
    graph_launches = []
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kinds[cat] = kinds.get(cat, 0) + 1
            spans.append((e["ts"], e["ts"] + e.get("dur", 0)))
            if cat == "gpu_memcpy" and "DtoD" in e["name"]:
                c = e.get("args", {}).get("correlation")
                copies[c] = copies.get(c, 0) + 1
            if cat == "kernel":
                by_launch.setdefault(e.get("args", {}).get("correlation"), []).append(e["name"])
                lane_us += e.get("dur", 0) if "chain_dp_lane_kernel" in e["name"] else 0
        elif cat == "cuda_runtime" and ("Launch" in e["name"] or "Memcpy" in e["name"]):
            api[e["name"]] = api.get(e["name"], 0) + 1
            if e["name"].startswith("cudaGraphLaunch"):
                graph_launches.append((e["ts"], e.get("args", {}).get("correlation")))
    ran = _families(name for names in by_launch.values() for name in names)
    order = [c for _ts, c in sorted(graph_launches)]
    got = [_families(by_launch.get(c, [])) for c in order]
    if ran != _families(k for k, v in counted.items() for _i in range(v)):
        # each graph launch whose kernels differ from its program's record,
        # with the families of the kernels no graph launch holds
        differ = [(i, g, r, len(by_launch.get(order[i], [])),
                   sorted({n.split("(")[0][-60:] for n in by_launch.get(order[i], [])}))
                  for i, (g, r) in enumerate(zip(got, replays)) if g != r]
        loose = _families(n for c, names in by_launch.items() if c not in set(order)
                          for n in names)
        raise AssertionError(f"[{tag}] the card ran {ran} kernels of each family, the pass "
                             f"counted {counted}; graph launches (index, ran, recorded, "
                             f"kernels) that differ: {differ} of {len(order)}; outside "
                             f"graph launches {loose}")
    nccl = {}
    if mapper.programs is not None:
        if got != replays:
            raise AssertionError(f"[{tag}] kernels per graph launch {got} != the launches "
                                 f"recorded for each replayed program {replays}")
        if any(collectives):
            # per graph launch: collectives recorded, NCCL kernels, and
            # device-to-device copies (a DtoD copy, or the memcpy kernel
            # CUDA may run a graph's copy node as)
            work = [(n, sum("nccl" in k.lower() for k in by_launch.get(c, [])),
                     copies.get(c, 0) + sum(k.startswith("memcpy")
                                            for k in by_launch.get(c, [])))
                    for n, c in zip(collectives, order)]
            if any(n and k + d < n for n, k, d in work):
                raise AssertionError(f"[{tag}] a graph launch holds less NCCL work than "
                                     f"the collectives its program recorded: {work}")
            nccl = {"graph_launches": len(work),
                    "collectives_recorded": sorted({n for n, _k, _d in work}),
                    "nccl_kernels": sorted({k for _n, k, _d in work}),
                    "device_copies": sorted({d for _n, _k, d in work})}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    out = {"device_stages": n, "wall_s": wall,
           "device_per_stage": {k: v / n for k, v in kinds.items()},
           "host_calls_per_stage": {k: v / n for k, v in api.items()},
           "busy_share": busy / 1e6 / wall, "lane_ms": lane_us / 1e3,
           "lane_share": lane_us / 1e6 / wall, "kernels_checked": ran,
           "graph_launches_checked": len(replays)}
    if nccl:
        out["collectives_in_graph_launches"] = nccl
    print(f"{tag} profiled pass: {json.dumps(out)}")
    return out


def _kernel_row(name, line, cap, key, window, plain_reps, counts, tab) -> dict:
    """One chain-DP kernel row: the kernel held to its plain version on
    every captured input of `key` (a phase's dict of captures, or the
    ranks' [(key, entry)] list), timed beside its plain version, its
    previous design and its bound; `line` the Pallas kernel's line in
    chain_pallas.py (None: the pruned instances, which replace the JAX
    lax.scan DP), `window` the dynamic window to hold it at (None: the
    captured one), `counts` the launches of the path it ran on."""
    from minimap2_rs_torch.kernels import chain_dp as kchain

    src = "minimap2_rs_torch/csrc/chain_dp.cu"
    pallas = "minimap2_rs_tpu/ops/chain_pallas.py"
    entries = ([e for k, e in cap if k == key] if isinstance(cap, list)
               else _launched(cap, key))
    variant = key.split("/")[0]
    aux = variant.startswith("chain_dp_aux")
    shapes = [(tuple(a[0].shape), s.bw, window or w) for a, s, w, _skip in entries]
    held = f"{variant}/dynamic" if window else key
    if window and min(sh[1] for sh, _b, _w in shapes) <= window:
        raise AssertionError(f"{name}: window {window} is not below A")
    err, ms, plain_ms, (args, scal, win, skip) = _kernel_vs_plain(
        entries, tab, aux, window, plain_reps)
    timed = tuple(args[0].shape)
    bound_ms, bound_by, pairs = chain_bound(args, scal, win, 4 if aux else 2, tab, skip)
    n_launch = counts.get(held, 0)
    design = kchain.design(timed[1], win, aux, skip)
    n_rows = int(valid_rows(args[0]).max())
    extra = {"design": design, "rows": n_rows,
             "us_per_row": ms * 1e3 / n_rows if n_rows else None}
    if design != "template":
        # the previous design on the same inputs, in the same call
        extra["prev_design_ms"] = time_ms(
            lambda: kchain.template_batch(aux, *args, scal, win, tab, skip),
            inner=KERNEL_INNER)
    if design == "lane":
        extra["ring_bytes"] = kchain.lane_ring_bytes(min(win, timed[1]), aux)
    elif design == "short":
        extra["smem_bytes"] = kchain.short_block_bytes(timed[1], aux)
    elif design == "smem":
        extra["smem_bytes"] = kchain.prune_block_bytes(timed[1], aux)
        fn = kchain.chain_dp_aux_batch if aux else kchain.chain_dp_batch
        extra["device_ms"] = device_ms(lambda: fn(*args, scal, win, tab, skip))
    print(f"{name}: (B, A), bw, window = {shapes}, all equal; timed at "
          f"{timed}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; {pairs} pairs x {CHAIN_OPS_PER_PAIR} ops)"
          + "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                    for k, v in extra.items())
          + f"; launches x (ms - bound) = {n_launch * (ms - bound_ms):.4f} ms")
    # the pruned instances replace the JAX lax.scan DP with max_chain_skip
    replaces = (f"{pallas}:{line}" if line else "minimap2_rs_tpu/ops/chain_ops.py:"
                + ("219" if aux else "141"))
    return dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=n_launch, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_note=LIBRARY_NOTE, **extra,
        shape=held.split("/")[1], timed_at=timed, on_main_path=n_launch > 0,
    )


def _launched(captured, key):
    """The captured inputs of `key`, one per band and anchor capacity A
    in (bw, A) order (chain DP), or one per length L (window scan)."""
    return [v for k, v in sorted(captured.items(), key=lambda kv: kv[0][1:])
            if k[0] == key]


def _mesh_dp_phase(idx, cp, mp, reads, lines, mapper, mapper_runs: dict, trace_dir: Path):
    """MeshMapper (dp = 1) over a 1-rank NCCL group on the headline reads,
    captured (its programs hold the wire-row all_gather) and a
    graphs=False twin on a group of its own, in turns with the captured
    single-device `mapper` (a b c c b a): all byte-identical to the
    Mapper's `lines`, every timed stage of the captured ones a replay;
    the three medians printed beside the lite headline phase's
    (`mapper_runs`, same call). One profiled pass of each mesh: every
    graph launch holds the NCCL work of the collectives its program
    recorded, and the two meshes' collective calls and bytes over that
    pass are equal. Returns the captured mesh's kernel inputs and its
    timed passes' launches."""
    from minimap2_rs_torch.models.mesh_mapper import make_mesh_mapper

    mms = {"captured": make_mesh_mapper(idx, cp, mp, dp=1, device="cuda", batch_size=1024),
           "eager": make_mesh_mapper(idx, cp, mp, dp=1, device="cuda", batch_size=1024,
                                     graphs=False)}
    for label, mm in mms.items():
        if mm.mesh.backend != "nccl" or (mm.programs is None) != (label == "eager"):
            raise AssertionError(f"the 1-rank {label} mesh took {mm.mesh.backend}, "
                                 f"programs {mm.programs}")
    tag = "mesh dp (NCCL, 1 rank)"
    launches: dict = {}
    mlines, runs, cap = _map_phase(tag, {**mms, "Mapper captured": mapper}, reads, 3,
                                   ["chain_dp_aux/static"], launches)
    if mlines != lines:
        first = next((f"{a!r} != {b!r}" for a, b in zip(mlines, lines) if a != b),
                     f"line counts {len(mlines)} vs {len(lines)}")
        raise AssertionError(f"[{tag}] != the single-device Mapper: {first}")
    paths = {f"mesh {x}": runs[x] for x in mms}
    paths["Mapper captured, in turns"] = runs["Mapper captured"]
    paths.update({f"Mapper {x}, lite headline phase": mapper_runs[x]
                  for x in ("captured", "eager")})
    print(f"{tag}: {len(mlines)} PAF lines byte-identical to the single-device Mapper's; "
          f"median pass (s, same call) "
          + json.dumps({k: median(r["times"]) for k, r in paths.items()}))
    keys = ("submit", "encode", "upload", "stage_issue", "d2h_issue", "d2h+wait", "post")
    print(f"{tag} last pass of each: " + json.dumps(
        {k: {x: r["stats"].get(k) for x, r in paths.items()} for k in keys}))
    for mm in mms.values():
        mm.mesh.stats.clear()
    for label, mm in mms.items():
        _profile_pass(f"{tag} ({label})", mm, reads, trace_dir)
    coll = {label: {k: (v["calls"], v["bytes_sent"]) for k, v in mm.mesh.stats.items()}
            for label, mm in mms.items()}
    if coll["captured"] != coll["eager"] or not coll["eager"]:
        raise AssertionError(f"[{tag}] collectives of the profiled pass (calls, bytes): {coll}")
    st = mms["captured"].mesh.stats
    if any(v["replayed_calls"] != v["calls"] for v in st.values()):
        raise AssertionError(f"[{tag}] a collective of the profiled pass was not replayed: {st}")
    print(f"{tag} collectives of the profiled pass, captured (calls equal to the eager "
          f"twin's, all replayed): {json.dumps(st)}; eager: "
          f"{json.dumps(mms['eager'].mesh.stats)}")
    return cap, launches


def _mesh_cli_phase(cli, cli_dir: Path, genome: bytes, reads) -> None:
    """`align --mesh 1` against `align` on the headline's FASTA files; the
    mesh run's MeshMapper must issue its stages through captured programs
    (a replay on every batch after each key's first)."""
    from minimap2_rs_torch.models.mesh_mapper import MeshMapper

    ref_fa, qry_fa = cli_dir / "headline_ref.fa", cli_dir / "headline_reads.fa"
    ref_fa.write_bytes(b">chrB\n" + genome + b"\n")
    qry_fa.write_bytes(b"".join(b">" + n.encode() + b"\n" + s + b"\n" for n, s in reads))
    out, mesh_runs = [], []
    orig = MeshMapper.map_reads_paf

    def spy(self, rl):
        blob = orig(self, rl)
        mesh_runs.append((self.programs is not None, dict(self.stats)))
        return blob

    MeshMapper.map_reads_paf = spy
    try:
        for extra in ([], ["--mesh", "1"]):
            paf = cli_dir / f"headline{'_mesh' if extra else ''}.paf"
            t0 = time.perf_counter()
            cli("align", ref_fa, qry_fa, "-o", paf, *extra)
            out.append(paf.read_bytes())
            print(f"CLI align {' '.join(extra)}: {time.perf_counter() - t0:.2f} s "
                  f"(index build included), {out[-1].count(b'\n')} lines")
    finally:
        MeshMapper.map_reads_paf = orig
    if out[0] != out[1] or not out[0]:
        raise AssertionError("CLI align --mesh 1 != align on the headline")
    (captured, st), = mesh_runs
    stages = json.dumps({k: st.get(k) for k in PROGRAM_STATS})
    if not captured or not st.get("graph_replays") or (
            st["graph_replays"] + st.get("eager_stages", 0) != st["device_stages"]):
        raise AssertionError(f"CLI align --mesh 1 did not replay its stages: {stages}")
    print(f"CLI align --mesh 1 == align on the headline FASTA, byte for byte; its stages: "
          f"{stages}")


# the sharded phase: two gloo ranks on one card; a 10 Mbp genome gives
# each shard the compact two-phase table (dm_entry 2) at ix = 2
SHARDED_RANKS = 2
SHARDED_TIMEOUT_S = 600


def _mesh_sharded_phase(cp, mp, store_dir: Path):
    """MeshMapper with the index hash-range-sharded over 2 gloo ranks
    sharing cuda:0 (ranks.spawn, share_device), on a 10 Mbp genome with
    2,048 short and 32 long reads: byte parity with the oracle on every
    16th short read and every long read, the same bytes on both ranks,
    dm_entry 2 on each shard, the collective statistics and quantile equal
    to the oracle's. Prints each rank's median pass, collective bytes and
    seconds, transports and launches. Each rank has held its captured
    kernel inputs to the plain versions; returns rank 0's, for the kernel
    rows, as [(key, (args, scalars, window, skip))] on the card, and the
    launches of the timed passes summed over the ranks."""
    import numpy as np
    import torch

    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.parallel import ranks
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    t0 = time.perf_counter()
    g10 = random_genome(10_000_000, seed=0)
    idx10 = build_index_native([("chrS", g10)], IndexParams())
    short = [(n, s) for n, s, *_ in simulate_reads(g10, 2048, read_len=(500, 1000), seed=1)]
    long_ = [(f"long_{n}", s) for n, s, *_ in simulate_reads(
        g10, 32, read_len=(5000, 20000), seed=3)]
    print(f"mesh sharded set-up {time.perf_counter() - t0:.1f} s: {idx10.keys.shape[0]} keys")
    # gloo ranks on one card stage their collectives through host memory,
    # which no capture can hold: this mesh runs eagerly
    run = dict(name="sharded", idx=idx10, cp=cp, mp=mp, reads=short + long_, dp=1,
               ix=SHARDED_RANKS, sharded=True, kw=dict(batch_size=1024, graphs=False))
    t0 = time.perf_counter()
    res = ranks.spawn(ranks.mesh_map, SHARDED_RANKS, [run], store_dir=store_dir,
                      device="cuda:0", share_device=True, timeout_s=SHARDED_TIMEOUT_S,
                      task_kw=dict(passes=3, hold_kernels=True, fracs=(2e-4,), dm_entry=2))
    res = [r["sharded"] for r in res]
    print(f"mesh sharded: {SHARDED_RANKS} gloo ranks on cuda:0 ran in "
          f"{time.perf_counter() - t0:.1f} s")
    if any(r["blob"] != res[0]["blob"] for r in res):
        raise AssertionError("[mesh sharded] the ranks' PAF bytes differ")
    lines = res[0]["blob"].decode().split("\n")[:-1]
    n_par = parity("mesh sharded", idx10, short[::16] + long_, lines, cp, mp)
    want_stats = (int(idx10.keys.shape[0]), int(idx10.positions.shape[0]))
    want_mid = idx10.calc_mid_occ(2e-4)
    captured, launches = [], {}
    for rank, r in enumerate(res):
        if r["dm_entry"] != 2:
            raise AssertionError(f"[mesh sharded] rank {rank}: dm_entry {r['dm_entry']}")
        if tuple(r["stats_allreduce"]) != want_stats or r["mid_occ"][2e-4] != want_mid:
            raise AssertionError(f"[mesh sharded] rank {rank}: stats {r['stats_allreduce']}"
                                 f", mid_occ {r['mid_occ']} != {want_stats}, {want_mid}")
        for key in ("chain_dp_aux/static", "chain_dp_aux/lane"):
            if not r["launches"].get(key):
                raise AssertionError(f"[mesh sharded] rank {rank} never launched {key}")
        for key, v in r["launches"].items():
            launches[key] = launches.get(key, 0) + v
        n = len(r["times"])
        coll = {kk: {"calls_per_pass": v["calls"] / n, "bytes_sent_per_pass": v["bytes_sent"] / n,
                     "seconds_per_pass": v["seconds"] / n, "transport": v["transport"]}
                for kk, v in r["collectives"].items()}
        print(f"mesh sharded rank {rank}: median pass {median(r['times']):.4f} s (passes "
              f"{[round(t, 4) for t in r['times']]}); dm_entry {r['dm_entry']}; stats "
              f"{tuple(r['stats_allreduce'])} and mid_occ {r['mid_occ'][2e-4]} equal the "
              f"oracle's; launches over {n} passes {r['launches']}")
        print(f"mesh sharded rank {rank} collectives per pass: {json.dumps(coll)}")
        print(f"mesh sharded rank {rank} sharded_payload_bytes of the last pass: "
              f"{r['stats'].get('collective_payload_bytes')}")
        print(f"mesh sharded rank {rank} stats (last pass): {json.dumps(r['stats'])}")
        for key, bw, A, args, scal, window, skip, err in r["kernels"]:
            print(f"mesh sharded rank {rank}: {key} (bw={bw}, A={A}) equal to the plain "
                  f"version in the rank (max_abs_err {err})")
            if rank == 0:
                captured.append((key, (tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                             for a in args), scal, window, skip)))
    print(f"mesh sharded parity vs oracle: {n_par} reads byte-identical, the same bytes on "
          f"both ranks ({len(lines)} PAF lines); launches over both ranks {launches}")
    return captured, launches


# the bench phase: bench_torch.py at a cut size, and the parity counts it
# must report there (every 16th of 2,048 reads; every 6th of 64 long ones)
BENCH_ARGV = ["--reads", "2048", "--longread-n", "64", "--skip-large"]
BENCH_PARITY = {"default": 128, "hifi_k19": 128, "hpc": 128, "ont_10pct": 256,
                "even_k14": 128, "longread": 11, "skipprune": 128}


def _bench_phase() -> None:
    """bench_torch.main at BENCH_ARGV on the card (which itself fails on a
    parity difference, a section without its kernels' launches or a
    chain_bound_share over 1.05): its record must hold every key of such
    a run and the parity counts BENCH_PARITY; printed on one line with
    its seconds."""
    import bench_torch

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = bench_torch.main(BENCH_ARGV)
    secs = time.perf_counter() - t0
    keys = bench_torch.flat_keys(rec)
    want = bench_torch.record_keys(skip_large=True)
    if keys != want:
        raise AssertionError(f"[bench] record keys: missing {sorted(want - keys)}, "
                             f"unexpected {sorted(keys - want)}")
    got = {t: rec[f"parity_{t}"] for t in BENCH_PARITY}
    if got != BENCH_PARITY:
        raise AssertionError(f"[bench] parity counts {got} != {BENCH_PARITY}")
    print(f"bench phase ({secs:.1f} s, bench_torch.py {' '.join(BENCH_ARGV)}): "
          f"{json.dumps(rec)}")


# the prof phase: each measuring script's main at a cut size, in order
PROF_RUNS = (
    ("pipeline", "prof_pipeline_torch", ["2048", "1024"], {"reads": 4096}),
    ("longread", "prof_longread_torch", ["64"], None),
    ("stages", "prof_longread_stages_torch", [], {"reads": 64}),
    ("scaling nccl", "scaling_bench_torch", ["--dp", "1"], None),
    ("scaling shared card", "scaling_bench_torch",
     ["--dp", "2", "--share-device", "--reads", "512"], None),
)


def _prof_phase() -> None:
    """PROF_RUNS on the card. Each script fails by itself on other PAF
    bytes between its runs, a section without its kernel's launches or a
    timed stage that did not replay; here besides: both batch sizes
    swept, the lane kernel in every long-read and stage record, the NCCL
    scaling run's captured programs replayed in its program-only rounds,
    and the shared-card run on gloo with no programs. Prints what each
    script printed and then its record on a line of its own."""
    import importlib

    t_all = time.perf_counter()
    for tag, name, argv, sizes in PROF_RUNS:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec = importlib.import_module(name).main(argv, sizes=sizes)
        secs = time.perf_counter() - t0
        for line in out.getvalue().splitlines()[:-1]:  # the last is the record
            print(f"  {line}")
        lane = "chain_dp_aux/lane"
        if tag == "pipeline":
            ok = [s["batch_size"] for s in rec["sizes"]] == [2048, 1024]
        elif tag == "longread":
            ok = rec["launches"].get(lane, 0) > 0
        elif tag == "stages":
            calls = [c for b in rec["buckets"] for c in b["calls"]]
            ok = ([b["bucket"] for b in rec["buckets"]] == [8192, 24576]
                  and all(c["launches"].get(lane) for c in calls))
        elif tag == "scaling nccl":
            ok = (rec["transport"] == "nccl" and rec["program_only_dp1_s"] > 0
                  and all(r > 0 for r in rec["program_rounds_s"]["dp1"]))
        else:
            ok = (rec["transport"] == "gloo-shared-device"
                  and rec["program_only_dp2_s"] is None and rec["t_dp2_s"] > 0)
        if not ok:
            raise AssertionError(f"[prof {tag}] record: {json.dumps(rec)}")
        print(f"prof phase {tag} ({secs:.1f} s, {name}.py {' '.join(argv)}): {json.dumps(rec)}")
    print(f"prof phase {time.perf_counter() - t_all:.1f} s")


# the assembly phase: the reference's yardstick genome size (BASELINE.md),
# cut as a scaffold-level assembly: over 64 sequences (the unpacked (2, P)
# position table) and, at its key count, no direct table under the 2 GB
# cap (the prefix probe)
ASSEMBLY_BP = 278_413_945
ASSEMBLY_CONTIGS = 300
ASSEMBLY_MIN_CONTIG = 20_000
ASSEMBLY_SIGMA = 2.0
ASSEMBLY_SHORT = 16_384  # 500-1000 bp: the 1024 bucket at A = 256
ASSEMBLY_LONG = 512      # 5-20 kb: the lane kernels and the lazy wide pass


def _assembly_records() -> list:
    """random_genome(ASSEMBLY_BP, seed=11) cut into ASSEMBLY_CONTIGS contigs
    ctg000, ctg001, ...: ASSEMBLY_MIN_CONTIG bases each plus a lognormal
    (sigma ASSEMBLY_SIGMA) share of the rest, drawn from default_rng(12),
    which gives a handful of chromosome-scale sequences (tens of Mbp) and
    a long tail down to 20 kb."""
    import numpy as np

    from minimap2_rs_torch.utils.seqsim import random_genome

    genome = random_genome(ASSEMBLY_BP, seed=11)
    w = np.random.default_rng(12).lognormal(0.0, ASSEMBLY_SIGMA, ASSEMBLY_CONTIGS)
    rest = ASSEMBLY_BP - ASSEMBLY_CONTIGS * ASSEMBLY_MIN_CONTIG
    lens = np.floor(w / w.sum() * rest).astype(np.int64) + ASSEMBLY_MIN_CONTIG
    lens[np.argmax(lens)] += ASSEMBLY_BP - lens.sum()
    off = np.concatenate([[0], np.cumsum(lens)])
    return [(f"ctg{c:03d}", genome[off[c]:off[c + 1]]) for c in range(ASSEMBLY_CONTIGS)]


def _assembly_reads(records, n_reads: int, read_len, tag: int) -> list:
    """n_reads reads simulated contig by contig in proportion to its
    length (largest remainders; simulate_reads seed (13, tag, contig)), so
    that no read spans two contigs; named contig.readN."""
    import numpy as np

    from minimap2_rs_torch.utils.seqsim import simulate_reads

    lens = np.array([len(s) for _n, s in records], np.float64)
    share = n_reads * lens / lens.sum()
    per = np.floor(share).astype(int)
    per[np.argsort(per - share, kind="stable")[:n_reads - per.sum()]] += 1
    out = []
    for c, ((name, seq), n) in enumerate(zip(records, per)):
        out += [(f"{name}.{rn}", s) for rn, s, *_ in simulate_reads(
            seq, int(n), read_len=read_len, seed=(13, tag, c))]
    return out


def _device_build_equal(tag, records, idx) -> float:
    """build_index_device of `records` on the card, held to the native
    build `idx`: the four arrays and the sequence table equal. Returns its
    seconds."""
    import numpy as np

    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_device

    t0 = time.perf_counter()
    d_idx = build_index_device(records, IndexParams(), device="cuda")
    t_device = time.perf_counter() - t0
    for name in ("keys", "starts", "counts", "positions"):
        if not np.array_equal(getattr(d_idx, name), getattr(idx, name)):
            raise AssertionError(f"[{tag}] device index build != native on {name}")
    seqs = [(q.name, q.offset, q.length) for q in idx.seq]
    if [(q.name, q.offset, q.length) for q in d_idx.seq] != seqs or len(seqs) != len(records):
        raise AssertionError(f"[{tag}] the builds' sequence tables differ")
    return t_device


def _two_planes(tag, mapper, n_seq: int) -> dict:
    """The mapper's device index must hold the (2, P) position planes (no
    packed plane); returns its layout scalars and table bytes, printed by
    the caller."""
    di = mapper.dev_idx
    if di.pos_packed or di.n_seq or di.pos.shape[0] != 2:
        raise AssertionError(f"[{tag}] packed position plane over {n_seq} sequences")
    tables = {name: getattr(di, name) for name in ("kv", "pos", "prefix", "dm", "dm_start",
                                                   "seq_cum")}
    layout = {k: getattr(di, k) for k in ("dm_entry", "dm_bits", "dm_slots", "dm_fp_bits",
                                          "prefix_shift", "bucket_slots", "n_keys",
                                          "pos_packed", "n_seq")}
    layout["lookup"] = "direct table" if di.dm_slots else "prefix probe"
    layout["mid_occ"] = mapper.mid_occ
    layout["table_bytes"] = {k: (None if v is None else v.numel() * v.element_size())
                             for k, v in tables.items()}
    return layout


def _map_mix(tag, mapper, reads, key, counts, idx, cp, mp):
    """One mix on a captured lite Mapper: _map_phase with 3 timed passes
    (the kernel `key` launched), the wire flags of the first pass, every
    64th read byte-identical to the oracle. Prints the median pass,
    aligned bp/s, the PAF's targets, the tiers' reads, the host items of
    the last pass and the host-fallback share. Returns (lines, the last
    pass's stats, captured inputs)."""
    flags = _FlagCounts()
    lines, runs, cap = _map_phase(tag, mapper, reads, 3, [key], counts, flags=flags)
    st = runs["captured"]["stats"]
    n_par = parity(tag, idx, reads[::64], lines, cp, mp)
    names = {l.split("\t", 1)[0] for l in lines}
    aligned = sum(len(s) for n, s in reads if n in names)
    dt = median(runs["captured"]["times"])
    targets = sorted({l.split("\t", 6)[5] for l in lines})
    host = st.get("host_reads", 0)
    print(f"{tag}: median pass {dt:.4f} s, aligned {aligned / dt:.1f} bp/s ({aligned} bp of "
          f"{len(names)} mapped reads), {len(lines)} PAF lines on {len(targets)} targets; "
          f"parity vs oracle: {n_par} reads byte-identical (every 64th); tier2_reads "
          f"{st.get('tier2_reads', 0)}, wide_reads {st.get('wide_reads', 0)}, host_reads "
          f"{host}; host items (s) " + json.dumps({k: st.get(k) for k in (
              "submit", "post", "tier2", "d2h+wait")}))
    print(f"{tag}: wire flags on the first pass (reads, mid_occ {mapper.mid_occ}): "
          f"{json.dumps(flags.n)}, any overflow {flags.overflow} of {len(reads)}; host "
          f"fallback {host} reads, share {host / len(reads):.6f} (the assembly phase's "
          f"gate: below 0.01)")
    return lines, st, cap


def _general_sample(tag, idx, mapper, sample, cp, mp):
    """The general path (MM2T_NO_LITE) on `sample` on a captured twin over
    the same device index, held to the exact-window oracle (its agreement
    with the default oracle printed). Returns (captured inputs, launches
    of its timed pass)."""
    import dataclasses

    from minimap2_rs_torch.models.mapper import Mapper

    gmapper = Mapper(idx=idx, dev_idx=mapper.dev_idx, cp=cp, mp=mp, mid_occ=mapper.mid_occ,
                     device=mapper.device, batch_size=1024)
    gcounts: dict = {}
    os.environ["MM2T_NO_LITE"] = "1"
    try:
        if gmapper._lite_eligible():
            raise AssertionError(f"[{tag}] MM2T_NO_LITE left the lite path on")
        glines, _r, cap_g = _map_phase(f"{tag} general sample", gmapper, sample, 1,
                                       ["chain_dp/static", "chain_dp/lane"], gcounts)
    finally:
        del os.environ["MM2T_NO_LITE"]
    cp_exact = dataclasses.replace(cp, max_chain_skip=1 << 30)
    n_par = parity(f"{tag} general sample", idx, sample, glines, cp_exact, mp)
    print(f"{tag} general sample (MM2T_NO_LITE): {len(glines)} PAF lines, parity vs the "
          f"exact-window oracle: {n_par} reads byte-identical; equal to the default oracle: "
          f"{_agree(idx, sample, glines, cp, mp)} of {n_par} reads")
    return cap_g, gcounts


def _tier2_parity(tag, mapper, reads, idx, cp, mp, cap: int = 12) -> int:
    """One more pass of `reads` on `mapper` that records the reads its
    phase 2.5 re-ran at 4x capacities and those it then sent to the host
    pipeline; the first `cap` of the tier's reads that stayed on the card
    held byte for byte to the oracle. Fails unless at least one did.
    Returns the number held."""
    tier, host = [], set()
    drain, fallback = mapper._drain_tier2, mapper._host_fallback

    def record_tier(pass_reads, results):
        tier.extend(pass_reads[ri] for ri in mapper._tier2_queue)
        return drain(pass_reads, results)

    def record_host(read):
        host.add(read[0])
        return fallback(read)

    mapper._drain_tier2, mapper._host_fallback = record_tier, record_host
    try:
        mapper.stats = {}
        lines = mapper.map_reads_paf(reads).decode().split("\n")[:-1]
    finally:
        del mapper._drain_tier2, mapper._host_fallback
    order = {n: i for i, (n, _s) in enumerate(reads)}
    on_card = sorted((r for r in tier if r[0] not in host), key=lambda r: order[r[0]])
    if not on_card:
        raise AssertionError(f"[{tag}] no read of the 4x tier stayed on the card: {len(tier)} "
                             f"in the tier, {len(host)} to the host pipeline")
    t0 = time.perf_counter()
    n_par = parity(f"{tag} 4x tier", idx, on_card[:cap], lines, cp, mp)
    print(f"{tag} 4x tier: {len(tier)} reads re-run at 4x capacities, {len(on_card)} of them "
          f"mapped on the card ({len(host)} reads to the host pipeline); parity vs oracle: "
          f"{n_par} of those byte-identical ({time.perf_counter() - t0:.1f} s)")
    return n_par


def _lookup_ms(tag, mapper, reads) -> dict:
    """bench_torch.stage_ms_per_call at the 1024 bucket on `mapper`
    (after its passes): each stage's card ms a call, printed with the
    index layout that sets `lookup`."""
    import bench_torch

    ms = bench_torch.stage_ms_per_call(mapper, reads, 1024)
    di = mapper.dev_idx
    how = (f"direct table dm_entry {di.dm_entry}, p {di.dm_bits}, S {di.dm_slots}"
           if di.dm_slots else f"prefix probe S {di.bucket_slots}, shift {di.prefix_shift}")
    print(f"{tag} stage ms a 1024-read call (bench_torch.stage_ms_per_call; {how}, "
          f"{di.n_keys} keys): lookup {ms['lookup']:.4f}; " + json.dumps(ms))
    return ms


def _probe_rows(tag, out, counts) -> list:
    """The prefix-probe kernel on the inputs both mixes of a phase kept
    (probe_hifi.probe_rows: equal to the plain branch on each, timed on the
    largest), its launches counted over the phase's timed passes."""
    import probe_hifi

    return probe_hifi.probe_rows(tag, {**out["long"], **out["short"]},
                               counts.get("probe_prefix", 0))


def _phase_rows(tag, out, cap_g, counts, gcounts) -> list:
    """A reference phase's four kernel rows' arguments for _kernel_row
    (each counted over that phase's own timed passes)."""
    return [
        (f"chain_dp_aux ({tag} short)", 291, out["short"], "chain_dp_aux/static", None, 5,
         counts),
        (f"chain_dp_aux ({tag} long reads)", 553, out["long"], "chain_dp_aux/lane", None, 1,
         counts),
        (f"chain_dp ({tag} general sample)", 290, cap_g, "chain_dp/static", None, 5, gcounts),
        (f"chain_dp ({tag} general sample, long)", 552, cap_g, "chain_dp/lane", None, 1,
         gcounts),
    ]


def _peak_line(tag) -> str:
    import resource

    import torch

    return (f"{tag} peak device memory {torch.cuda.max_memory_allocated()} bytes; host peak "
            f"RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes (the "
            f"process so far)")


def _assembly_phase(cp, mp) -> list:
    """The main path on the assembly (ASSEMBLY_BP in ASSEMBLY_CONTIGS
    contigs): the native and the device index build, timed and equal;
    the device index's layout and table bytes; a captured lite Mapper on
    ASSEMBLY_SHORT reads of 500-1000 bp and ASSEMBLY_LONG of 5-20 kb (2
    warm passes, a key capturing on its second batch, then 3 timed ones
    that must be replays only; the short-read kernel, then the aux lane
    kernel, launched), every 64th read of each mix byte-identical to the
    oracle, under 1% of each mix sent to the host pipeline; the general
    path (MM2T_NO_LITE) on a captured twin over the same device index
    with those sampled reads, held to the exact-window oracle as the
    general phases are. Prints the medians, aligned bp/s, the wire flags
    of each mix's first pass, the lookup stage's card time, the PAF's
    target contigs, the peak device memory and the host's peak RSS.
    Returns the kernel rows' arguments for main's kernel rows (each
    counted over this phase's own timed passes)."""
    import numpy as np
    import torch

    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.runtime import host as nhost

    tag = "assembly"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = _assembly_records()
    t_gen = time.perf_counter() - t0
    lens = sorted((len(s) for _n, s in records), reverse=True)
    t0 = time.perf_counter()
    idx = build_index_native(records, IndexParams())
    t_native = time.perf_counter() - t0
    stages = nhost.last_build_stage_s()
    t_device = _device_build_equal(tag, records, idx)
    rids = np.unique(idx.positions >> np.uint64(32))
    if rids.shape[0] != ASSEMBLY_CONTIGS:
        raise AssertionError(f"[{tag}] positions on {rids.shape[0]} contigs")
    print(f"{tag} set-up: {ASSEMBLY_BP} bp in {len(records)} contigs (longest "
          f"{lens[:5]}, median {lens[len(lens) // 2]}, shortest {lens[-1]}), genome "
          f"{t_gen:.1f} s; native index build {t_native:.3f} s (stages "
          f"{json.dumps(stages)}); device index build {t_device:.3f} s on the card, all four "
          f"arrays and the sequence table equal; {idx.keys.shape[0]} keys, "
          f"{idx.positions.shape[0]} positions")
    t0 = time.perf_counter()
    mapper = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=1024)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    layout = _two_planes(tag, mapper, len(records))
    print(f"{tag} device index: {t_upload:.1f} s (planner, tables, upload); layout "
          f"{json.dumps(layout)}")
    t0 = time.perf_counter()
    short = _assembly_reads(records, ASSEMBLY_SHORT, (500, 1000), 0)
    long_ = _assembly_reads(records, ASSEMBLY_LONG, (5000, 20000), 1)
    print(f"{tag} reads: {len(short)} short, {len(long_)} long in "
          f"{time.perf_counter() - t0:.1f} s")
    if mapper._shapes_for(1024, 1)[1] != 256:
        raise AssertionError(f"[{tag}] the 1024 bucket is not at A = 256")
    counts: dict = {}  # this phase's launches, its own kernel rows
    out = {}
    for mix, reads, key in (("short", short, "chain_dp_aux/static"),
                            ("long", long_, "chain_dp_aux/lane")):
        lines, st, out[mix] = _map_mix(f"{tag} {mix}", mapper, reads, key, counts, idx, cp,
                                       mp)
        if st.get("host_reads", 0) >= 0.01 * len(reads):
            raise AssertionError(f"[{tag} {mix}] host fallback on {st.get('host_reads')} reads")
        if max(int(l.split("\t", 6)[5][3:]) for l in lines) < 64:
            raise AssertionError(f"[{tag} {mix}] no PAF line on a contig id past 63")
    _lookup_ms(tag, mapper, short)
    probe = _probe_rows(tag, out, counts)
    cap_g, gcounts = _general_sample(tag, idx, mapper, short[::64] + long_[::64], cp, mp)
    print(_peak_line(tag))
    print(f"{tag} launches over the timed passes: lite {counts}, general sample {gcounts}")
    return _phase_rows(tag, out, cap_g, counts, gcounts), probe


# the chm13 phase: a human-sized reference in the shape of T2T-CHM13v2.0
# (NCBI GCA_009914755.4): its 25 sequences, names and lengths in the
# assembly's order, summing past 2^31 bases (so the length, not the count
# of sequences, refuses the packed position plane); synthetic bases
CHM13_SEQS = (
    ("chr1", 248_387_328), ("chr2", 242_696_752), ("chr3", 201_105_948),
    ("chr4", 193_574_945), ("chr5", 182_045_439), ("chr6", 172_126_628),
    ("chr7", 160_567_428), ("chr8", 146_259_331), ("chr9", 150_617_247),
    ("chr10", 134_758_134), ("chr11", 135_127_769), ("chr12", 133_324_548),
    ("chr13", 113_566_686), ("chr14", 101_161_492), ("chr15", 99_753_195),
    ("chr16", 96_330_374), ("chr17", 84_276_897), ("chr18", 80_542_538),
    ("chr19", 61_707_364), ("chr20", 66_210_255), ("chr21", 45_090_682),
    ("chr22", 51_324_926), ("chrX", 154_259_566), ("chrY", 62_460_029),
    ("chrM", 16_569),
)
CHM13_BP = 3_117_292_070
CHM13_SHORT = 16_384  # 500-1000 bp: the 1024 bucket at A = 256
CHM13_LONG = 512      # 5-20 kb: the lane kernels, the wide pass and the 4x tier
# the child's limit, from its start: its host set-up runs beside the kernel
# rows (about 4 minutes), its card part after them (about 4 more)
CHM13_TIMEOUT_S = 1000


def chm13_lengths() -> list:
    """[(name, length)] of the chm13 phase's sequences: T2T-CHM13v2.0's,
    in order; the lengths sum to CHM13_BP."""
    if sum(n for _s, n in CHM13_SEQS) != CHM13_BP:
        raise AssertionError("the CHM13 lengths do not sum to CHM13_BP")
    return list(CHM13_SEQS)


def cut_records(genome: bytes, lengths) -> list:
    """The genome cut in order into [(name, bases)] at `lengths`
    [(name, length)], which must cover it exactly."""
    if sum(n for _s, n in lengths) != len(genome):
        raise ValueError(f"the lengths cover {sum(n for _s, n in lengths)} of "
                         f"{len(genome)} bases")
    out, off = [], 0
    for name, n in lengths:
        out.append((name, genome[off:off + n]))
        off += n
    return out


def _meminfo_total() -> str:
    with open("/proc/meminfo") as f:
        return next(l.strip() for l in f if l.startswith("MemTotal"))


def _chm13_phase(cp, mp, wait=None) -> list:
    """The main path on a human-sized reference (chm13_lengths: CHM13_BP
    bases in T2T-CHM13v2.0's 25 sequences), run in a process of its own
    (`python3 chip_smoke.py --phase chm13`). On the host first:
    random_genome(CHM13_BP, seed=11) cut at those lengths; the native
    index build, timed; CHM13_SHORT reads of 500-1000 bp and CHM13_LONG
    of 5-20 kb, simulated sequence by sequence; the .mmi written and read
    back under a temporary directory, its arrays and sequence table equal
    to the native build's (offsets past 2^31), the mapper to be made from
    the index read back, as users run `minimap2 -d` then map. Then
    wait() (the full run's go, once the card is free), and on the card:
    the device index build, timed and equal; the layout (the two position
    planes, refused by length alone) and table bytes; a captured lite
    Mapper on both mixes (2 warm passes, 3 timed ones, replays only; the
    short-read kernel, then the aux lane kernel), every 64th read of each
    mix byte-identical to the oracle, the short mix on every nuclear
    chromosome with CHM13's target lengths; the wire flags of each mix's
    first pass and its host-fallback share (printed, not gated); one
    more pass of the long mix, the first 12 of its reads that the 4x tier
    mapped on the card byte-identical to the oracle (_tier2_parity); the
    general path on the sampled reads against the exact-window oracle;
    the lookup stage's card time; the peak device memory and this
    process's peak RSS. Returns the kernel rows (dicts), each held to its
    plain version and counted over this phase's timed passes."""
    import tempfile

    import numpy as np
    import torch

    from minimap2_rs_torch.config import IndexParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.oracle.index import OracleIndex
    from minimap2_rs_torch.runtime import host as nhost
    from minimap2_rs_torch.utils.seqsim import random_genome

    tag = "chm13"
    lengths = chm13_lengths()
    print(f"{tag} machine: {_meminfo_total()}; {nvidia_smi()}; "
          f"{torch.cuda.get_device_properties(0).total_memory} bytes of device memory")
    t0 = time.perf_counter()
    records = cut_records(random_genome(CHM13_BP, seed=11), lengths)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = build_index_native(records, IndexParams())
    t_native = time.perf_counter() - t0
    stages = nhost.last_build_stage_s()
    print(f"{tag} set-up: {CHM13_BP} bp in {len(records)} sequences (longest "
          f"{max(n for _s, n in lengths)}, shortest {min(n for _s, n in lengths)}), genome "
          f"{t_gen:.1f} s; native index build {t_native:.3f} s (stages "
          f"{json.dumps(stages)}); {idx.keys.shape[0]} keys, {idx.positions.shape[0]} "
          f"positions; {_peak_line(tag)}")
    t0 = time.perf_counter()
    short = _assembly_reads(records, CHM13_SHORT, (500, 1000), 0)
    long_ = _assembly_reads(records, CHM13_LONG, (5000, 20000), 1)
    print(f"{tag} reads: {len(short)} short, {len(long_)} long in "
          f"{time.perf_counter() - t0:.1f} s")

    # the users' order: minimap2 -d ref.mmi, then map against ref.mmi
    tmp_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        path = os.path.join(tmp, "chm13.mmi")
        t0 = time.perf_counter()
        idx.save_to_mmi(path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = OracleIndex.load_from_mmi(path)
        t_load = time.perf_counter() - t0
    for name in ("keys", "starts", "counts", "positions", "S"):
        a, b = getattr(idx, name), getattr(loaded, name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"[{tag}] the .mmi read back differs on {name}")
    seqs = [(q.name, q.offset, q.length) for q in idx.seq]
    if ([(q.name, q.offset, q.length) for q in loaded.seq] != seqs
            or (loaded.w, loaded.k, loaded.flag) != (idx.w, idx.k, idx.flag)):
        raise AssertionError(f"[{tag}] the .mmi read back differs in its header")
    offsets = np.concatenate([[0], np.cumsum([ln for _n, ln in lengths])[:-1]]).tolist()
    if [(n, ln) for n, _o, ln in seqs] != lengths or [o for _n, o, _l in seqs] != offsets:
        raise AssertionError(f"[{tag}] sequence table {seqs}")
    print(f"{tag} .mmi round trip: {size} bytes written in {t_save:.1f} s, read back in "
          f"{t_load:.1f} s, arrays and sequence table equal to the native build's (the last "
          f"offset {seqs[-1][1]}); {_peak_line(tag)}")
    # the index read back stands for the native build from here on
    del idx
    idx = loaded
    if wait is not None:
        t0 = time.perf_counter()
        wait()
        print(f"{tag}: the host set-up done, waited {time.perf_counter() - t0:.1f} s for the "
              f"card")

    torch.cuda.reset_peak_memory_stats()
    t_device = _device_build_equal(tag, records, idx)
    del records
    print(f"{tag} device index build {t_device:.3f} s on the card, all four arrays and the "
          f"sequence table equal; peak device memory {torch.cuda.max_memory_allocated()} bytes")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    mapper = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=1024)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    layout = _two_planes(tag, mapper, len(lengths))
    if len(idx.seq) > 64 or mapper.dev_idx.dm_slots:
        raise AssertionError(f"[{tag}] {len(idx.seq)} sequences, direct table "
                             f"{mapper.dev_idx.dm_slots}: not the layout of this phase")
    print(f"{tag} device index: {t_upload:.1f} s (mid_occ, planner, tables, upload); "
          f"packed plane refused by length alone ({len(idx.seq)} sequences <= 64, "
          f"{sum(ln for _n, ln in lengths)} bases >= 2^31); layout {json.dumps(layout)}")
    if mapper._shapes_for(1024, 1)[1] != 256:
        raise AssertionError(f"[{tag}] the 1024 bucket is not at A = 256")
    counts: dict = {}  # this phase's launches, its own kernel rows
    out = {}
    for mix, reads, key in (("short", short, "chain_dp_aux/static"),
                            ("long", long_, "chain_dp_aux/lane")):
        lines, _st, out[mix] = _map_mix(f"{tag} {mix}", mapper, reads, key, counts, idx, cp,
                                        mp)
        if mix == "short":
            per: dict = {}
            for l in lines:
                f = l.split("\t", 7)
                per.setdefault(f[5], set()).add(int(f[6]))
            nuclear = [n for n, _ln in lengths if n != "chrM"]
            if (any(per.get(n) != {ln} for n, ln in lengths if n in per)
                    or not set(nuclear) <= set(per)):
                raise AssertionError(f"[{tag} short] targets and lengths {per}")
            print(f"{tag} short: PAF lines on all {len(nuclear)} nuclear chromosomes, each at "
                  f"CHM13's length (chr1 {per['chr1']}); lines a target " + json.dumps(
                      {n: sum(1 for l in lines if l.split("\t", 6)[5] == n) for n in per}))
    _tier2_parity(tag, mapper, long_, idx, cp, mp)
    _lookup_ms(tag, mapper, short)
    probe = _probe_rows(tag, out, counts)
    cap_g, gcounts = _general_sample(tag, idx, mapper, short[::64] + long_[::64], cp, mp)
    print(_peak_line(tag))
    print(f"{tag} launches over the timed passes: lite {counts}, general sample {gcounts}")
    tab = mapper._log2_tab
    return [_kernel_row(*row, tab) for row in _phase_rows(tag, out, cap_g, counts,
                                                          gcounts)] + probe


class _Chm13Child:
    """The chm13 phase in a child process, so that its host memory is its
    own. Made early, it does its host set-up (genome, native build, reads,
    .mmi round trip) while this process times the kernels, then waits;
    finish() lets it go on to the card, passes its output on, and returns
    its kernel rows. A non-zero exit or CHM13_TIMEOUT_S fails the run;
    leaving the `with` block kills a child still running."""

    def __init__(self, rows_path: Path):
        self.rows_path = rows_path
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase", "chm13", "--rows",
             str(rows_path), "--wait"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.watchdog = threading.Timer(CHM13_TIMEOUT_S, self.proc.kill)
        self.watchdog.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.watchdog.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self) -> list:
        t_go = time.perf_counter()
        try:
            self.proc.stdin.write("go\n")
            self.proc.stdin.close()
        except BrokenPipeError:
            pass  # it has ended already; its exit code says how
        for line in self.proc.stdout:
            print(line, end="")
        rc = self.proc.wait()
        if rc < 0:
            raise RuntimeError(f"the chm13 phase was killed (signal {-rc}; its limit is "
                               f"{CHM13_TIMEOUT_S} s)")
        if rc:
            raise RuntimeError(f"the chm13 phase exited {rc}")
        print(f"chm13 phase {time.perf_counter() - self.t0:.1f} s in its process, "
              f"{time.perf_counter() - t_go:.1f} s of it after the go")
        return json.loads(self.rows_path.read_text())


# the chm13-hifi probe child's limit: the cell's set-up (about 2.5 minutes),
# three passes of one pool call and the kernel's check and times
HIFI_PROBE_TIMEOUT_S = 600


def _hifi_probe_phase(rows_path: Path) -> list:
    """`python3 probe_hifi.py --rows rows_path` in a child process: the
    benchmark cell chm13-hifi's index (T2T-CHM13 at k 19, the probe at 128
    slots) and one pool call of its reads on captured programs, the
    prefix-probe kernel held to the plain branch, and its kernel row,
    which it returns. Its output is passed on; a
    non-zero exit or HIFI_PROBE_TIMEOUT_S fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve().parent / "probe_hifi.py"), "--rows",
         str(rows_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(HIFI_PROBE_TIMEOUT_S, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            print(line, end="")
        rc = proc.wait()
    finally:
        watchdog.cancel()
    if rc:
        raise RuntimeError(f"the chm13-hifi probe phase exited {rc}")
    print(f"chm13-hifi probe phase {time.perf_counter() - t0:.1f} s in its process")
    return json.loads(rows_path.read_text())


def _phase_main(phase: str, rows_path: Path | None, wait: bool) -> int:
    """`--phase chm13`: the chm13 phase alone (the kernel library and the
    native runtime built or loaded first); its kernel rows are written to
    rows_path, or printed. `wait`: after its host set-up, wait for a line
    "go" on the standard input (_Chm13Child)."""
    import torch

    from minimap2_rs_torch.config import ChainParams, MapParams
    from minimap2_rs_torch.kernels import build as kbuild
    from minimap2_rs_torch.runtime import host as nhost

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if wait:
        # its host set-up runs beside the parent's kernel timings: yield
        # the cores to them (after the go it runs alone)
        os.nice(10)
    t0 = time.perf_counter()
    kbuild.library()
    if not nhost.native_available():
        raise RuntimeError("the native host runtime did not build or load")
    print(f"{phase} phase: kernel library and native host runtime ready in "
          f"{time.perf_counter() - t0:.1f} s")

    def go():
        sys.stdout.flush()
        if sys.stdin.readline().strip() != "go":
            raise RuntimeError("the parent ended before the card was free")

    rows = _chm13_phase(ChainParams.defaults_for_k(15), MapParams(), go if wait else None)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    if rows_path is None:
        for row in rows:
            print(json.dumps(row))
    else:
        rows_path.write_text(json.dumps(rows))
    sys.stdout.flush()
    return 0


class _Sections:
    """The seconds of each section of a run: mark(name) closes the open
    section and opens `name` (None: opens none)."""

    def __init__(self, name: str):
        self.s: dict = {}
        self._name, self._t = name, time.perf_counter()

    def mark(self, name) -> None:
        now = time.perf_counter()
        self.s[self._name] = round(now - self._t, 1)
        self._name, self._t = name, now


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--phase", choices=("chm13",),
                    help="run this phase alone (the full run starts it as a child)")
    ap.add_argument("--rows", type=Path, help="with --phase: write its kernel rows here")
    ap.add_argument("--wait", action="store_true",
                    help="with --phase: wait for 'go' on stdin before using the card")
    args = ap.parse_args(argv)
    if args.phase:
        return _phase_main(args.phase, args.rows, args.wait)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    import dataclasses

    import numpy as np

    from minimap2_rs_torch import cli as tcli
    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.kernels import build as kbuild
    from minimap2_rs_torch.models.index_builder import build_index_device, build_index_native
    from minimap2_rs_torch.models.mapper import Mapper
    from minimap2_rs_torch.runtime import host as nhost
    from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads

    t_start = time.perf_counter()
    sections = _Sections("build")
    card = nvidia_smi()
    print(card)
    nvcc = subprocess.run([kbuild._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")

    # ---- build: the kernels (nvcc) and the native host runtime (g++) ----
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        kernels_built = ex.submit(kbuild.library)
        host_loaded = ex.submit(nhost.native_available)
        kernels_built.result()
        if not host_loaded.result():
            raise RuntimeError("the native host runtime did not build or load")
    print(f"kernel library and native host runtime ({nhost.build()}, from the "
          f"port's source) built in {time.perf_counter() - t0:.1f} s")
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    sections.mark("set-up")
    # ---- set-up: 5 Mbp index on the card, reads ---------------------
    cp = ChainParams.defaults_for_k(15)
    cp_gen = ChainParams.defaults_for_k(15, min_cnt=1, min_chain_score=10)
    mp = MapParams()
    t0 = time.perf_counter()
    genome = random_genome(5_000_000, seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    mapper = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=1024)
    gmapper = Mapper.from_oracle_index(idx, cp_gen, mp, device="cuda", batch_size=1024)
    # the same mappers with every device stage issued eagerly
    emapper = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=1024,
                                       graphs=False)
    egmapper = Mapper.from_oracle_index(idx, cp_gen, mp, device="cuda", batch_size=1024,
                                        graphs=False)
    if not mapper._lite_eligible() or gmapper._lite_eligible():
        raise AssertionError("the lite/general mappers took the wrong paths")
    if mapper.programs is None or emapper.programs is not None:
        raise AssertionError("the CUDA mappers took the wrong programs")
    reads = [(n, s) for n, s, *_ in simulate_reads(genome, 16384, read_len=(500, 1000), seed=1)]
    lreads = [(n, s) for n, s, *_ in simulate_reads(genome, 64, read_len=(5000, 20000), seed=3)]
    di = mapper.dev_idx
    print(f"set-up {time.perf_counter() - t0:.1f} s: {idx.keys.shape[0]} keys, "
          f"dm_entry={di.dm_entry} p={di.dm_bits} S={di.dm_slots}")
    total: dict = {}  # main-path launches per variant/shape, single-device phases
    trace_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    trace_dir.mkdir(parents=True, exist_ok=True)
    profiled: dict = {}

    def profile(tag, pair):
        for label, m in pair.items():
            profiled[f"{tag} ({label})"] = _profile_pass(f"{tag} ({label})", m, reads_of[tag],
                                                          trace_dir)

    lite, general = {"captured": mapper, "eager": emapper}, {"captured": gmapper,
                                                            "eager": egmapper}
    reads_of = {"lite headline": reads, "lite long-read": lreads,
                "general headline": reads, "general long-read": lreads}

    sections.mark("lite headline")
    # ---- lite headline: 16,384 reads, 1 warm + 5 timed passes a path --
    lines, runs, cap_lite = _map_phase("lite headline", lite, reads, 5,
                                       ["chain_dp_aux/static", "sketch/short"], total)
    times, stats = runs["captured"]["times"], runs["captured"]["stats"]
    mapped = {l.split("\t", 1)[0] for l in lines}
    aligned_bp = sum(len(s) for n, s in reads if n in mapped)
    dt = median(times)
    dt_eager = median(runs["eager"]["times"])
    print(f"lite headline median pass {dt:.4f} s captured, {dt_eager:.4f} s eager; aligned "
          f"{aligned_bp / dt:.1f} bp/s captured, {aligned_bp / dt_eager:.1f} eager, "
          f"{len(lines)} PAF lines")
    for run in runs.values():
        if run["stats"].get("host_reads", 0) >= 0.01 * len(reads):
            raise AssertionError(f"host fallback on {run['stats'].get('host_reads')} reads "
                                 "(>= 1%)")
    n_par = parity("lite headline", idx, reads[::16], lines, cp, mp)
    print(f"lite headline parity vs oracle: {n_par} reads byte-identical")
    profile("lite headline", lite)

    sections.mark("lite long reads")
    # ---- lite long reads: 64 reads of 5-20 kb --------------------------
    llines, _r, cap_llong = _map_phase("lite long-read", lite, lreads, 3,
                                       ["chain_dp_aux/lane", "sketch/long"], total)
    n_par = parity("lite longread", idx, lreads, llines, cp, mp)
    print(f"lite long-read parity vs oracle: {n_par} reads byte-identical")
    profile("lite long-read", lite)

    sections.mark("general headline")
    # ---- general headline: align -n 1 -m 10, warm passes + 1 timed one --
    # the device DP scores the window exactly, so the gate is the oracle
    # with max_chain_skip past any window; agreement with the default
    # oracle is printed, not gated
    cp_exact = dataclasses.replace(cp_gen, max_chain_skip=1 << 30)
    glines, gruns, cap_gen = _map_phase("general headline", general, reads, 1,
                                        ["chain_dp/static", "sketch/short"], total)
    n_sec = _count_where(glines, _is_secondary)
    n_s2 = _count_where(glines, lambda l: _s2(l) > 0)
    mapped = {l.split("\t", 1)[0] for l in glines}
    aligned_bp = sum(len(s) for n, s in reads if n in mapped)
    dt = median(gruns["captured"]["times"])
    print(f"general headline median pass {dt:.4f} s captured, "
          f"{median(gruns['eager']['times']):.4f} s eager; aligned {aligned_bp / dt:.1f} "
          f"bp/s captured, {len(glines)} PAF lines, {n_sec} tp:A:S lines, {n_s2} lines "
          f"with s2 > 0")
    if n_sec == 0:
        raise AssertionError("the general path emitted no secondary (tp:A:S) line")
    for run in gruns.values():
        if run["stats"].get("host_reads", 0) >= 0.01 * len(reads):
            raise AssertionError(f"host fallback on {run['stats'].get('host_reads')} reads "
                                 "(>= 1%)")
    if not gruns["captured"]["stats"].get("rescue_reads"):
        raise AssertionError("the general headline queued no rescue re-chain")
    sample = reads[::16]
    with _OracleRescues(cp_gen) as resc_exact:
        n_par = parity("general headline", idx, sample, glines, cp_exact, mp)
    print(f"general headline parity vs exact-window oracle: {n_par} reads byte-identical")
    with _OracleRescues(cp_gen) as resc_default:
        n_agree = _agree(idx, sample, glines, cp_gen, mp)
    print(f"general headline sample equal to the default oracle: {n_agree} of {n_par} reads")
    gmapper.stats = {}
    gmapper.map_reads_paf(sample)
    print(f"general headline rescue decisions on the {len(sample)} sampled reads: "
          f"port {gmapper.stats.get('rescue_reads', 0)} (besides "
          f"{gmapper.stats.get('host_reads', 0)} reads sent to the host pipeline), "
          f"exact-window oracle {resc_exact.n}, default oracle {resc_default.n}")
    profile("general headline", general)

    sections.mark("general long reads")
    # ---- general long reads ----------------------------------------------
    gllines, _r, cap_glong = _map_phase("general long-read", general, lreads, 3,
                                        ["chain_dp/lane", "sketch/long"], total)
    n_par = parity("general longread", idx, lreads, gllines, cp_exact, mp)
    print(f"general long-read parity vs exact-window oracle: {n_par} reads byte-identical")
    print(f"general long reads equal to the default oracle: "
          f"{_agree(idx, lreads, gllines, cp_gen, mp)} of {n_par} reads")
    profile("general long-read", general)

    sections.mark("ont_10pct")
    # ---- ont_10pct: 256 reads of 1-2 kb at 10% error (bench.py:391-399) --
    r_ont = [(n, s) for n, s, *_ in simulate_reads(genome, 256, read_len=(1000, 2000),
                                                   error_rate=0.10, seed=19)]
    l_ont, _r, _c = _map_phase("ont_10pct", mapper, r_ont, 1, ["chain_dp_aux/static"], total)
    n_par = parity("ont_10pct", idx, r_ont, l_ont, cp, mp)
    print(f"ont_10pct parity vs oracle: {n_par} reads byte-identical, {len(l_ont)} PAF lines")

    sections.mark("forced tiers")
    # ---- the 4x tier and the lazy wide pass, forced ------------------
    _forced_phases(cp, mp, total)

    sections.mark("hifi_k19")
    # ---- hifi_k19: lite path at k=19 -----------------------------------
    t0 = time.perf_counter()
    g19 = random_genome(2_000_000, seed=11)
    idx19 = build_index_native([("chrH", g19)], IndexParams(w=10, k=19))
    cp19 = ChainParams.defaults_for_k(19)
    m19 = Mapper.from_oracle_index(idx19, cp19, mp, device="cuda", batch_size=1024)
    r19 = [(n, s) for n, s, *_ in simulate_reads(g19, 128, read_len=(2000, 4000),
                                                 error_rate=0.01, seed=13)]
    print(f"hifi_k19 set-up {time.perf_counter() - t0:.1f} s: "
          f"{idx19.keys.shape[0]} keys, dm_entry={m19.dev_idx.dm_entry}")
    l19, _r, cap_19 = _map_phase("hifi_k19", m19, r19, 1, ["chain_dp_aux/static"],
                                     total)
    n_par = parity("hifi_k19", idx19, r19, l19, cp19, mp)
    print(f"hifi_k19 parity vs oracle: {n_par} reads byte-identical, {len(l19)} PAF lines")

    sections.mark("even_k14")
    # ---- even_k14: the exact-scan sketch through the window scan -------
    t0 = time.perf_counter()
    idx14 = build_index_native([("chrE", g19)], IndexParams(w=10, k=14))
    cp14 = ChainParams.defaults_for_k(14)
    m14 = Mapper.from_oracle_index(idx14, cp14, mp, device="cuda", batch_size=1024)
    r14 = [(n, s) for n, s, *_ in simulate_reads(g19, 128, read_len=(500, 1000), seed=23)]
    r14 += [(f"long_{n}", s) for n, s, *_ in simulate_reads(
        g19, 16, read_len=(5000, 20000), seed=29)]
    print(f"even_k14 set-up {time.perf_counter() - t0:.1f} s: {idx14.keys.shape[0]} keys")
    l14, _r, cap_14 = _map_phase(
        "even_k14", m14, r14, 1,
        ["window_scan/short", "window_scan/long", "chain_dp_aux/static",
         "chain_dp_aux/lane"], total)
    n_par = parity("even_k14", idx14, r14, l14, cp14, mp)
    print(f"even_k14 parity vs oracle: {n_par} reads byte-identical, {len(l14)} PAF lines")

    sections.mark("hpc")
    # ---- hpc: an HPC index (queries stay non-HPC, seeds.rs:7-11) --------
    t0 = time.perf_counter()
    idx_hpc = build_index_native([("chrP", g19)], IndexParams(w=10, k=15, flag=1))
    m_hpc = Mapper.from_oracle_index(idx_hpc, cp, mp, device="cuda", batch_size=1024)
    r_hpc = [(n, s) for n, s, *_ in simulate_reads(g19, 128, read_len=(500, 1000), seed=17)]
    print(f"hpc set-up {time.perf_counter() - t0:.1f} s: {idx_hpc.keys.shape[0]} keys")
    l_hpc, _r, _c = _map_phase("hpc", m_hpc, r_hpc, 1, ["chain_dp_aux/static"], total)
    n_par = parity("hpc", idx_hpc, r_hpc, l_hpc, cp, mp)
    print(f"hpc parity vs oracle: {n_par} reads byte-identical, {len(l_hpc)} PAF lines")

    sections.mark("skipprune")
    # ---- skipprune: the pruned kernel instances, both paths -------------
    # held against the default oracle, which always prunes
    r_sp = reads[:128]
    os.environ["MM2T_SKIP_PRUNE"] = "1"
    try:
        m_sp = Mapper.from_oracle_index(idx, cp, mp, device="cuda", batch_size=128)
        gm_sp = Mapper.from_oracle_index(idx, cp_gen, mp, device="cuda", batch_size=128)
        l_sp, _r, cap_sp = _map_phase("skipprune lite", m_sp, r_sp, 1,
                                          ["chain_dp_aux_prune/static"], total)
        gl_sp, _r, cap_gsp = _map_phase("skipprune general", gm_sp, r_sp, 1,
                                            ["chain_dp_prune/static"], total)
    finally:
        del os.environ["MM2T_SKIP_PRUNE"]
    n_par = parity("skipprune lite", idx, r_sp, l_sp, cp, mp)
    n_gpar = parity("skipprune general", idx, r_sp, gl_sp, cp_gen, mp)
    print(f"skipprune parity vs the default oracle: lite {n_par}, general {n_gpar} reads "
          f"byte-identical ({len(l_sp)} and {len(gl_sp)} PAF lines)")

    sections.mark("large")
    # ---- large: a 100 Mbp genome, 16,384 reads (bench.py:475-531) ---------
    t0 = time.perf_counter()
    big = random_genome(100_000_000, seed=7)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_big = build_index_native([("chrL", big)], IndexParams())
    t_build = time.perf_counter() - t0
    build_stages = nhost.last_build_stage_s()
    t0 = time.perf_counter()
    bmapper = Mapper.from_oracle_index(idx_big, cp, mp, device="cuda", batch_size=1024)
    bdi = bmapper.dev_idx
    print(f"large set-up: genome {t_gen:.1f} s; native index build {t_build:.3f} s (stages "
          f"{json.dumps(build_stages)}), {idx_big.keys.shape[0]} keys; device index "
          f"{time.perf_counter() - t0:.1f} s, dm_entry={bdi.dm_entry} p={bdi.dm_bits} "
          f"S={bdi.dm_slots}")
    brl = [(n, s) for n, s, *_ in simulate_reads(big, 16384, read_len=(500, 1000), seed=9)]
    blines, bruns, _c = _map_phase("large", bmapper, brl, 3, ["chain_dp_aux/static"], total)
    bnames = {l.split("\t", 1)[0] for l in blines}
    b_bp = sum(len(s) for n, s in brl if n in bnames)
    dt = median(bruns["captured"]["times"])
    print(f"large median pass {dt:.4f} s, aligned {b_bp / dt:.1f} bp/s, {len(blines)} PAF "
          f"lines")
    n_par = parity("large", idx_big, brl[::64], blines, cp, mp)
    print(f"large parity vs oracle: {n_par} reads byte-identical (every 64th)")
    _lookup_ms("large", bmapper, brl)
    del bmapper, idx_big, big, brl, blines

    sections.mark("assembly")
    # ---- assembly: 278,413,945 bp in 300 contigs, short and long mixes --
    t0 = time.perf_counter()
    assembly_rows, assembly_probe = _assembly_phase(cp, mp)
    torch.cuda.empty_cache()
    print(f"assembly phase {time.perf_counter() - t0:.1f} s")

    sections.mark("chm13")

    sections.mark("device index build")
    # ---- device index build of the 5 Mbp genome ---------------------------
    for flag in (0, 1):
        params = IndexParams(flag=flag)
        t0 = time.perf_counter()
        ref_idx = idx if flag == 0 else build_index_native([("chrB", genome)], params)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        d_idx = build_index_device([("chrB", genome)], params, device="cuda")
        t_dev = time.perf_counter() - t0
        for name in ("keys", "starts", "counts", "positions"):
            if not np.array_equal(getattr(d_idx, name), getattr(ref_idx, name)):
                raise AssertionError(f"device index build (flag={flag}) != native on {name}")
        print(f"device index build, 5 Mbp, flag={flag}: {t_dev:.3f} s on the card "
              f"(native build {t_native:.3f} s{'' if flag else ', timed at set-up'}); "
              f"{d_idx.keys.shape[0]} keys, all four arrays equal to the native build")

    sections.mark("CLI")
    # ---- CLI: index, then anchors / chain, device against host ----------
    cli_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    cli_dir.mkdir(parents=True, exist_ok=True)
    ref_fa, qry_fa = cli_dir / "ref.fa", cli_dir / "read.fa"
    ref_fa.write_bytes(b">chrH\n" + g19 + b"\n")
    cli_read = simulate_reads(g19, 1, read_len=(6000, 8000), seed=31)[0][1]
    qry_fa.write_bytes(b">long_read\n" + cli_read + b"\n")

    def cli(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if tcli.main([str(a) for a in argv]) != 0:
                raise AssertionError(f"CLI {argv} failed")
        return buf.getvalue()

    def cli_device():
        for k in (15, 14):
            mmi = cli_dir / f"ref_k{k}.mmi"
            cli("index", ref_fa, "-k", k, "-d", mmi)
            for cmd in ("anchors", "chain"):
                out = {e: cli(cmd, mmi, qry_fa, "-k", k, "--engine", e)
                       for e in ("device", "host")}
                if out["device"] != out["host"]:
                    raise AssertionError(f"CLI {cmd} k={k}: device != host:\n"
                                         f"{out['device']}\n{out['host']}")
                print(f"CLI {cmd} k={k} --engine device == host: "
                      f"{out['device'].splitlines()[0]}")

    # the 6-8 kb read is a long window-scan row at k=14; chain runs the
    # pruned (f, prev) instance at whatever shape its anchor count gives
    with _capturing() as cap_cli:
        _none, cli_launches = _counted("CLI", cli_device, ["window_scan/long"], total)
    if not any(k.startswith("chain_dp_prune/") for k in cli_launches):
        raise AssertionError("[CLI] chain --engine device never launched chain_dp_prune")
    print(f"CLI kernel launches: {cli_launches}")

    sections.mark("extension")
    # ---- extension: 64 random pairs, on the card against the CPU ----------
    from minimap2_rs_torch.ops import extend_ops

    rng = np.random.default_rng(37)
    q = rng.integers(0, 4, size=(64, 256)).astype(np.int32)
    r = np.concatenate([q, rng.integers(0, 4, size=(64, 16))], axis=1).astype(np.int32)
    mut = rng.random(r.shape) < 0.08
    r[mut] = rng.integers(0, 4, size=int(mut.sum()))
    qlen = rng.integers(128, 257, size=64).astype(np.int32)
    rlen = np.clip(qlen + rng.integers(-12, 13, size=64), 0, 272).astype(np.int32)
    host = tuple(map(torch.from_numpy, (q, qlen, r, rlen)))
    card = tuple(t.cuda() for t in host)
    for fn in (extend_ops.banded_edit_batch, extend_ops.banded_affine_extend):
        got, want = fn(*card, 16), fn(*host, 16)
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"{fn.__name__}: card != CPU")
        print(f"extension {fn.__name__}: 64 pairs, card == CPU; first scores "
              f"{got[0][:4].tolist()}")

    sections.mark("bench")
    # ---- bench_torch.py at a cut size (before any process group exists) --
    _bench_phase()
    sections.mark("prof")
    # ---- the measuring scripts at a cut size (before any process group) --
    _prof_phase()

    sections.mark("mesh")
    # ---- the multi-GPU mapper: a 1-rank NCCL mesh, the CLI, 2 gloo ranks --
    cap_mesh_dp, n_mesh_dp = _mesh_dp_phase(idx, cp, mp, reads, lines, mapper, runs,
                                            trace_dir)
    _mesh_cli_phase(cli, cli_dir, genome, reads)
    cap_mesh_sh, n_mesh_sh = _mesh_sharded_phase(cp, mp, cli_dir)
    print(f"main-path launches per kernel/shape, the single-device phases: {total}; "
          f"mesh dp: {n_mesh_dp}; mesh sharded (both ranks): {n_mesh_sh}")

    # ---- chm13: 3,117,292,070 bp in 25 sequences, in a child process; its
    # host set-up runs beside the kernel rows and the synthetic phase, which
    # time on the card, and its card part after them --------------------
    with _Chm13Child(trace_dir / "chm13_rows.json") as chm13:
        sections.mark("kernel rows")
        # ---- kernels against their plain versions --------------------------
        # on the inputs each path's warm pass gave its kernel, every band and
        # anchor capacity it ran (hifi_k19's beside the lite headline's); the
        # dynamic-window shape (A < 1024, window < A), which no mapper path
        # launches, on the same inputs at window 128
        tab = mapper._log2_tab
        if not torch.equal(tab, m19._log2_tab):
            raise AssertionError("the k=15 and k=19 mappers built different log2 tables")
        cap_lite = {**cap_19, **cap_lite}  # the headline's entries win a clash
        kernels = []
        rows = [
            ("chain_dp_aux (lite headline, hifi_k19)", 291, cap_lite, "chain_dp_aux/static",
             None, 5),
            ("chain_dp_aux (lite long reads)", 553, cap_llong, "chain_dp_aux/lane", None, 1),
            ("chain_dp_aux (window 128)", 429, cap_lite, "chain_dp_aux/static", 128, 5),
            ("chain_dp (general headline)", 290, cap_gen, "chain_dp/static", None, 5),
            ("chain_dp (general long reads)", 552, cap_glong, "chain_dp/lane", None, 1),
            ("chain_dp (window 128)", 428, cap_gen, "chain_dp/static", 128, 5),
            ("chain_dp_aux_prune (skipprune lite)", None, cap_sp, "chain_dp_aux_prune/static",
             None, 1),
            ("chain_dp_prune (skipprune general)", None, cap_gsp, "chain_dp_prune/static",
             None, 1),
            ("chain_dp_prune (CLI chain)", None, cap_cli, "chain_dp_prune/lane", None, 1),
        ]
        # the single-device rows count their launches over every single-device
        # phase but the assembly; the mesh and assembly rows over their own
        # phase's timed passes
        rows = [(*r, total) for r in rows] + [
            ("chain_dp_aux (mesh dp, NCCL 1 rank)", 291, cap_mesh_dp, "chain_dp_aux/static",
             None, 5, n_mesh_dp),
            ("chain_dp_aux (mesh sharded, 2 gloo ranks)", 291, cap_mesh_sh,
             "chain_dp_aux/static", None, 5, n_mesh_sh),
            ("chain_dp_aux (mesh sharded long reads, 2 gloo ranks)", 553, cap_mesh_sh,
             "chain_dp_aux/lane", None, 1, n_mesh_sh),
        ] + assembly_rows
        for row in rows:
            kernels.append(_kernel_row(*row, tab))

        # the window scan: every short entry whole, the long ones on 8 rows
        for cls, max_rows in (("short", None), ("long", 8)):
            key = f"window_scan/{cls}"
            entries = _launched(cap_14, key)
            ms, card_ms, prev_ms, plain_ms, args = _scan_vs_plain(entries, max_rows)
            timed = tuple(args[0].shape)
            bound_ms, bound_by = scan_bound(args)
            shapes = [(tuple(a[0][:max_rows].shape), w, k) for a, w, k in entries]
            print(f"window_scan ({cls}): (B, L), w, k = {shapes}, all equal (both designs); "
                  f"timed at {timed}: kernel {ms:.4f} ms (device time {card_ms:.4f} ms), "
                  f"prev_design_ms (sequential) {prev_ms:.4f}, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}); launches x (ms - bound) = "
                  f"{total.get(key, 0) * (ms - bound_ms):.4f} ms")
            kernels.append(dict(
                name=f"window_scan (even_k14 {cls} reads)", route="cuda",
                source="minimap2_rs_torch/csrc/window_scan.cu",
                replaces="minimap2_rs_tpu/ops/sketch_scan.py:110",
                launches=total.get(key, 0), max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                library_note=LIBRARY_NOTE, design="tile", prev_design_ms=prev_ms,
                device_ms=card_ms,
                shape=cls, timed_at=timed, on_main_path=total.get(key, 0) > 0,
            ))

        # the odd-k sketch: every input the map phases kept, then the
        # three bucket shapes
        sketch_caps = {kk: v for cap in (cap_lite, cap_llong, cap_gen, cap_glong, cap_19)
                       for kk, v in cap.items() if kk[0].startswith("sketch/")}
        kernels += _sketch_rows(mapper, genome, sketch_caps, total)

        sections.mark("synthetic")
        # ---- the lane, short-read and pruned kernels on synthetic edge cases --
        t0 = time.perf_counter()
        for want_design, cases in _synthetic_cases().items():
            _synthetic_phase(tab, want_design, cases)
        print(f"synthetic phase {time.perf_counter() - t0:.1f} s")
        kernels += assembly_probe
        sections.mark("chm13")
        kernels += chm13.finish()
    sections.mark("chm13-hifi probe")
    # ---- the prefix probe on one chm13-hifi pool call, in a child process
    # of its own after the chm13 one (host memory) -------------------------
    kernels += _hifi_probe_phase(trace_dir / "hifi_probe_rows.json")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    torch.distributed.destroy_process_group()
    sections.mark(None)
    print(f"seconds of each section: {json.dumps(sections.s)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
