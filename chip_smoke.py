"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from minimap2_rs_torch/csrc (the chain
DP's two variants in their short-read, lane and template designs, their
pruned instances in the shared-memory and template designs, and the
window scan in its tiled and sequential designs; one nvcc per source, in
parallel) and maps through the port's
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
  * bench: bench_torch.py (the port's bench.py) at a cut size, `--reads
    2048 --longread-n 64 --skip-large`, before the mesh phases (it
    fails on any parity difference or a section without its kernels'
    launches): its record must hold every key of such a run and each
    parity count (128, hifi_k19 128, hpc 128, ont_10pct 256, even_k14
    128, longread 11, skipprune 128).
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
version on those inputs (the window scan's long shape on 8 rows), and
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
    time_ms,
    valid_rows,
)


# the kernel rows' note on library_ms
LIBRARY_NOTE = "no single PyTorch call computes a sequential chaining DP or a window scan"


def _kernel_vs_plain(entries, tab, aux: bool, window=None, plain_reps: int = 5):
    """torch.equal of kernel and plain outputs on every captured input
    (entries: [(args, scalars, window, max_chain_skip)]; `window`
    overrides the captured one), plus both times (ms, CUDA events,
    median) on the largest normal-band launch, which is returned too as
    (args, scalars, window, max_chain_skip). aux picks the variant:
    (f, cnt, sq, sr) or (f, prev). Long shapes time the plain version
    with fewer repeats."""
    import torch

    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops import chain_ops

    if aux:
        fn, ref = kchain.chain_dp_aux_batch, chain_ops.chain_dp_aux_batch_ref
        names = ("f", "cnt", "sq", "sr")
    else:
        fn, ref = kchain.chain_dp_batch, chain_ops.chain_dp_batch_ref
        names = ("f", "prev")
    err = 0
    for args, scal, win, skip in entries:
        win = window or win
        got = fn(*args, scal, win, tab, skip)
        want = ref(*args, scal, win, tab, max_chain_skip=skip)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(
                    f"kernel != plain on {name} (bw={scal.bw}, A={args[0].shape[1]}) "
                    f"at {bad}"
                )
            err = max(err, int((g.long() - w.long()).abs().max()))
    bw0 = entries[0][1].bw
    args, scal, win, skip = max((e for e in entries if e[1].bw == bw0),
                                key=lambda e: e[0][0].numel())
    win = window or win
    ms = time_ms(lambda: fn(*args, scal, win, tab, skip), inner=KERNEL_INNER)
    plain_ms = time_ms(lambda: ref(*args, scal, win, tab, max_chain_skip=skip),
                        reps=plain_reps)
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
    from minimap2_rs_torch.kernels import chain_dp, window_scan

    return chain_dp, window_scan


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


def _map_phase(tag, mappers, reads, passes, keys, total):
    """Warm passes of each mapper (a Mapper, or {label: Mapper} of mappers
    that must give the same bytes; the first is the main path): one, and
    for a mapper with captured programs a second (a key's first batch
    runs eagerly, its second captures it), both keeping the kernels'
    inputs (_capturing) and timed, as the first and second pass; then
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
            for _w in range(2 if m.programs is not None else 1):
                t1 = time.perf_counter()
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


KERNEL_FAMILIES = ("chain_dp", "window_scan")  # launch-key and kernel-name prefixes


def _families(keys) -> dict:
    """The kernel launches among `keys` (launch keys or kernel names) per
    family."""
    out = dict.fromkeys(KERNEL_FAMILIES, 0)
    for k in keys:
        for fam in KERNEL_FAMILIES:
            out[fam] += fam in k
    return out


def _profile_pass(tag, mapper, reads, trace_dir: Path) -> dict:
    """One more pass of `reads` under torch.profiler (CUDA activity),
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

    mapper.stats = {}
    counts.replay = replay
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    if ran != _families(k for k, v in counted.items() for _i in range(v)):
        raise AssertionError(f"[{tag}] the card ran {ran} chain-DP/window-scan kernels, the "
                             f"pass counted {counted}")
    nccl = {}
    if mapper.programs is not None:
        order = [c for _ts, c in sorted(graph_launches)]
        got = [_families(by_launch.get(c, [])) for c in order]
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


def main() -> int:
    import torch

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

    # ---- lite headline: 16,384 reads, 1 warm + 5 timed passes a path --
    lines, runs, cap_lite = _map_phase("lite headline", lite, reads, 5,
                                       ["chain_dp_aux/static"], total)
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

    # ---- lite long reads: 64 reads of 5-20 kb --------------------------
    llines, _r, cap_llong = _map_phase("lite long-read", lite, lreads, 3,
                                       ["chain_dp_aux/lane"], total)
    n_par = parity("lite longread", idx, lreads, llines, cp, mp)
    print(f"lite long-read parity vs oracle: {n_par} reads byte-identical")
    profile("lite long-read", lite)

    # ---- general headline: align -n 1 -m 10, 1 warm + 3 timed passes --
    # the device DP scores the window exactly, so the gate is the oracle
    # with max_chain_skip past any window; agreement with the default
    # oracle is printed, not gated
    cp_exact = dataclasses.replace(cp_gen, max_chain_skip=1 << 30)
    glines, gruns, cap_gen = _map_phase("general headline", general, reads, 3,
                                        ["chain_dp/static"], total)
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

    # ---- general long reads ----------------------------------------------
    gllines, _r, cap_glong = _map_phase("general long-read", general, lreads, 3,
                                        ["chain_dp/lane"], total)
    n_par = parity("general longread", idx, lreads, gllines, cp_exact, mp)
    print(f"general long-read parity vs exact-window oracle: {n_par} reads byte-identical")
    print(f"general long reads equal to the default oracle: "
          f"{_agree(idx, lreads, gllines, cp_gen, mp)} of {n_par} reads")
    profile("general long-read", general)

    # ---- ont_10pct: 256 reads of 1-2 kb at 10% error (bench.py:391-399) --
    r_ont = [(n, s) for n, s, *_ in simulate_reads(genome, 256, read_len=(1000, 2000),
                                                   error_rate=0.10, seed=19)]
    l_ont, _r, _c = _map_phase("ont_10pct", mapper, r_ont, 1, ["chain_dp_aux/static"], total)
    n_par = parity("ont_10pct", idx, r_ont, l_ont, cp, mp)
    print(f"ont_10pct parity vs oracle: {n_par} reads byte-identical, {len(l_ont)} PAF lines")

    # ---- the 4x tier and the lazy wide pass, forced ------------------
    _forced_phases(cp, mp, total)

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

    # ---- hpc: an HPC index (queries stay non-HPC, seeds.rs:7-11) --------
    t0 = time.perf_counter()
    idx_hpc = build_index_native([("chrP", g19)], IndexParams(w=10, k=15, flag=1))
    m_hpc = Mapper.from_oracle_index(idx_hpc, cp, mp, device="cuda", batch_size=1024)
    r_hpc = [(n, s) for n, s, *_ in simulate_reads(g19, 128, read_len=(500, 1000), seed=17)]
    print(f"hpc set-up {time.perf_counter() - t0:.1f} s: {idx_hpc.keys.shape[0]} keys")
    l_hpc, _r, _c = _map_phase("hpc", m_hpc, r_hpc, 1, ["chain_dp_aux/static"], total)
    n_par = parity("hpc", idx_hpc, r_hpc, l_hpc, cp, mp)
    print(f"hpc parity vs oracle: {n_par} reads byte-identical, {len(l_hpc)} PAF lines")

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
    del bmapper, idx_big, big, brl, blines

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

    # ---- bench_torch.py at a cut size (before any process group exists) --
    _bench_phase()

    # ---- the multi-GPU mapper: a 1-rank NCCL mesh, the CLI, 2 gloo ranks --
    cap_mesh_dp, n_mesh_dp = _mesh_dp_phase(idx, cp, mp, reads, lines, mapper, runs,
                                            trace_dir)
    _mesh_cli_phase(cli, cli_dir, genome, reads)
    cap_mesh_sh, n_mesh_sh = _mesh_sharded_phase(cp, mp, cli_dir)
    print(f"main-path launches per kernel/shape, the single-device phases: {total}; "
          f"mesh dp: {n_mesh_dp}; mesh sharded (both ranks): {n_mesh_sh}")

    # ---- kernels against their plain versions --------------------------
    # on the inputs each path's warm pass gave its kernel, every band and
    # anchor capacity it ran (hifi_k19's beside the lite headline's); the
    # dynamic-window shape (A < 1024, window < A), which no mapper path
    # launches, on the same inputs at window 128
    src = "minimap2_rs_torch/csrc/chain_dp.cu"
    pallas = "minimap2_rs_tpu/ops/chain_pallas.py"
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
    # phase; the mesh rows over their own phase's timed passes
    rows = [(*r, total) for r in rows] + [
        ("chain_dp_aux (mesh dp, NCCL 1 rank)", 291, cap_mesh_dp, "chain_dp_aux/static",
         None, 5, n_mesh_dp),
        ("chain_dp_aux (mesh sharded, 2 gloo ranks)", 291, cap_mesh_sh,
         "chain_dp_aux/static", None, 5, n_mesh_sh),
        ("chain_dp_aux (mesh sharded long reads, 2 gloo ranks)", 553, cap_mesh_sh,
         "chain_dp_aux/lane", None, 1, n_mesh_sh),
    ]
    from minimap2_rs_torch.kernels import chain_dp as kchain

    for name, line, cap, key, window, plain_reps, counts in rows:
        # a phase's dict of captures, or the ranks' [(key, entry)] list
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
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n_launch, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library_note=LIBRARY_NOTE, **extra,
            shape=held.split("/")[1], timed_at=timed, on_main_path=n_launch > 0,
        ))

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

    # ---- the lane, short-read and pruned kernels on synthetic edge cases --
    t0 = time.perf_counter()
    for want_design, cases in _synthetic_cases().items():
        _synthetic_phase(tab, want_design, cases)
    print(f"synthetic phase {time.perf_counter() - t0:.1f} s")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    torch.distributed.destroy_process_group()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
