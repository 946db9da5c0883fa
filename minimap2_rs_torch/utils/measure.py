"""Measuring helpers shared by chip_smoke.py, bench_torch.py and the A/B
scripts: medians, CUDA-event timings, the H100's peaks, the least time a
chain-DP or window-scan call could take on them, the card's name and
power limit, and the byte-parity gate against the host oracle.

Nothing here runs when the module is imported; the timings need a card.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import chain_ops
from ..ops.sketch import KS_INVALID
from ..oracle.pipeline import map_reads as oracle_map


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def median(xs):
    return sorted(xs)[len(xs) // 2]


def time_ms(fn, reps: int = 5, warm: bool = True, inner: int = 1) -> float:
    """Median of `reps` CUDA-event timings of `inner` back-to-back calls
    of fn(), divided by `inner` (after one warm-up unless the caller has
    just run it). With inner > 1 the card queues each launch while the
    previous one runs, so a kernel's time no longer holds the host's cost
    of a call."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return median(times)


# back-to-back launches a kernel timing covers (time_ms)
KERNEL_INNER = 10


# cycles the card spins before a device_ms timing (about 30 ms on an
# H100), long enough for the host to queue every call behind it
SPIN_CYCLES = 50_000_000


def device_ms(fn, reps: int = 5, inner: int = KERNEL_INNER) -> float:
    """The card's time for one call of fn(): the median of `reps`
    CUDA-event timings of `inner` back-to-back calls, each queued behind
    a spin kernel (torch.cuda._sleep) while the host issues them, so the
    card runs the calls back to back and the host's cost of a call drops
    out. Where the host takes longer to issue a call than the card to run
    it, time_ms measures the host, and this the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return median(times)


# The card's peaks (H100 SXM data sheet, dense, at 700 W): float32 outside
# the tensor cores, and device memory
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operations one candidate pair costs in score() of csrc/chain_dp.cu plus
# the running-best update: the group compare, the two differences,
# |dr - dq| (compare and subtract), six admissibility compares, two minima
# (dg, sc), the penalty condition (two), the table index clamp, two
# int-to-float conversions, three f32 multiplies and two adds, the
# truncation, the penalty subtract, the add of f[j], and the compare and
# two selects of the best: 29.
CHAIN_OPS_PER_PAIR = 29
# Operations of one position's step of the reference's recurrence (the
# sequential design in csrc/window_scan.cu) outside the data-dependent
# rescan: the validity select, the ring write (two), the l compares (two),
# the minimum compare, its update (three selects), the slot compare and
# the slot advance (two): 12.
SCAN_OPS_PER_POSITION = 12


def sketch_ops_per_position(w: int) -> int:
    """Operations of one position in csrc/sketch.cu, outside the halos
    each tile computes again: decoding its code from the wire and its
    share of the three ballots (8), l from the no-base flags (8), the
    k-mer's funnel shift, mask and complement (10), the bit reversal to
    the forward k-mer (8), the strand compare and select (3), hash64
    (20), the word and its pos << 1 | strand (7), the step's rules (15),
    its compaction share (10): 89; and the step's argmin, four a window
    slot: 4 (w - 1)."""
    return 89 + 4 * (w - 1)


def bound(ops: int, nbytes: int):
    """(bound ms, what bounds it): the larger of the operations over the
    float32 peak and the bytes over the memory rate."""
    t_ops = ops / PEAK_F32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def valid_rows(grp):
    """(B,) int64: n_b, one past read b's last valid anchor (grp != -1),
    the rows the kernels walk."""
    pos = torch.arange(1, grp.shape[1] + 1, device=grp.device, dtype=torch.int64)
    return torch.where(grp != -1, pos, 0).amax(dim=1)


def window_pairs(n, H: int):
    """The candidate pairs the exact window H scores over reads of n
    valid anchors (n an int64 tensor or array): sum_{i < n} min(i, H),
    n(n - 1)/2 for n <= H + 1, else H(H + 1)/2 + (n - 1 - H)H."""
    where = torch.where if isinstance(n, torch.Tensor) else np.where
    return where(n <= H + 1, n * (n - 1) // 2, H * (H + 1) // 2 + (n - 1 - H) * H)


def chain_bound(args, scal, window: int, n_out: int, tab, skip):
    """(bound ms, bound_by, pairs) of one chain-DP call: the pairs
    sum_b sum_{i < n_b} min(i, H), with n_b one past read b's last valid
    anchor (the rows the kernel walks), or with max_chain_skip only the
    pairs the walk visits before its break (chain_ops.scanned_pairs on
    the plain DP's own f and prev), times CHAIN_OPS_PER_PAIR; the bytes of
    4 (B, A) int32 inputs, n_out outputs and the log2 table."""
    grp = args[0]
    B, A = grp.shape
    H = min(window, A)
    if skip is None:
        pairs = int(window_pairs(valid_rows(grp), H).sum())
    else:
        f, prev = chain_ops.chain_dp_batch_ref(*args, scal, window, tab, max_chain_skip=skip)
        pairs = int(chain_ops.scanned_pairs(*args, f, prev, scal, window, tab, skip).sum())
    nbytes = (4 + n_out) * B * A * 4 + tab.shape[0] * 4
    return (*bound(pairs * CHAIN_OPS_PER_PAIR, nbytes), pairs)


def scan_bound(args):
    """(bound ms, bound_by) of one window-scan call: the positions
    sum_b lengths[b] times SCAN_OPS_PER_POSITION; the bytes of ks and ps
    (int64), l_eff (int32), lengths and emit_final, and the emitted mask
    (one byte a position)."""
    ks, ps, l_eff, lengths, emit_final = args
    B, L = ks.shape
    positions = int(lengths.long().sum())
    nbytes = B * L * (8 + 8 + 4 + 1) + B * (4 + 1)
    return bound(positions * SCAN_OPS_PER_POSITION, nbytes)


def sketch_bound(rows, lengths, nex, wire: str, w: int, M: int):
    """(bound ms, bound_by) of one odd-k sketch call: the positions
    sum_b lengths[b] times sketch_ops_per_position(w); the bytes of the
    wire's rows, the N list and the lengths, and of the outputs (cks and
    cps, int64 each, n_mini and mini_ovf)."""
    B = rows.shape[0]
    positions = int(lengths.long().sum())
    nbytes = (rows.numel() * rows.element_size() + B * 4
              + (nex.numel() * 4 if wire == "2bit" else 0) + B * M * 16 + B * 5)
    return bound(positions * sketch_ops_per_position(w), nbytes)


# Bytes one query key of the prefix probe reads at least: one random 32-byte
# sector of the key table (port_bench/metrics/probe_roofline.py's yardstick)
PROBE_BYTES_PER_QUERY = 32


def probe_bound(sks):
    """(bound ms, bound_by) of one prefix-probe call: its real query keys
    (the slots of sks that are not padding, KS_INVALID) times
    PROBE_BYTES_PER_QUERY over the memory rate."""
    queries = int((sks != KS_INVALID).sum())
    return bound(0, queries * PROBE_BYTES_PER_QUERY)


def parity(tag, idx, sample, lines, cp, mp) -> int:
    """Hold the PAF `lines` of the reads of `sample` byte for byte to the
    host oracle's (oracle/pipeline.map_reads); raises AssertionError with
    the first differing line. Returns the number of reads held."""
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
