"""Tracing/observability: a torch.profiler trace of a mapping run and a
per-stage wall-time breakdown (the port's counterpart of
minimap2_rs_tpu/utils/profiling.py, whose trace is jax.profiler's)."""

from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device):
    """A torch.profiler trace of the block, written to
    trace_dir/trace.json, with CUDA activity when `device` is a CUDA
    device; nothing when trace_dir is unset."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def print_stage_stats(stats: dict, n_reads: int, total_bp: int, dt: float, file=sys.stderr):
    """Per-stage wall-time breakdown in the spirit of the reference's
    index stats line (main.rs:154-155)."""
    parts = " ".join(
        f"{k}:{v:.2f}s" for k, v in sorted(stats.items())
        if isinstance(v, (int, float))
    )
    print(
        f"[mm2t] mapped {n_reads} reads ({total_bp} bp) in {dt:.2f}s "
        f"({total_bp / max(dt, 1e-9):.0f} bp/s) | {parts}",
        file=file,
    )
