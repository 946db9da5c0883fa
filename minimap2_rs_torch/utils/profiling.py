"""Tracing/observability: host spans of the mapper's work, a
torch.profiler trace of a mapping run and a per-stage breakdown (the
port's counterpart of minimap2_rs_tpu/utils/profiling.py, whose trace is
jax.profiler's)."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# the prefix of every span's torch.profiler range
SPAN_PREFIX = "mm2t."
# stats keys printed as counts, not seconds: by suffix, and by name
_COUNT_SUFFIXES = ("_bytes", "_reads", "_stages", "_batches")
_COUNT_KEYS = ("anchors", "chain_pairs", "probe_queries")


class _Span:
    """span()'s context manager: the block's host seconds go to
    stats[key] (and to `seconds`); while a torch profiler records, the
    block is also the range SPAN_PREFIX + key."""

    __slots__ = ("stats", "key", "seconds", "_t0", "_range")

    def __init__(self, stats: dict, key: str):
        self.stats, self.key = stats, key
        self.seconds = 0.0

    def __enter__(self):
        self._range = None
        if getattr(_autograd_profiler, "_is_profiler_enabled", False):
            self._range = torch.profiler.record_function(SPAN_PREFIX + self.key)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self.stats[self.key] = self.stats.get(self.key, 0) + self.seconds
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(stats: dict, key: str) -> _Span:
    """`with span(stats, key):` adds the block's host seconds to
    stats[key]. While a torch profiler is recording, the block is also a
    record_function range named "mm2t.<key>" (on a thread other than the
    profiler's only when it profiles all threads)."""
    return _Span(stats, key)


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device):
    """A torch.profiler trace of the block, written to
    trace_dir/trace.json, with CUDA activity when `device` is a CUDA
    device and every thread's spans (the mapper's submit thread too);
    nothing when trace_dir is unset."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _is_count(key: str) -> bool:
    return key.endswith(_COUNT_SUFFIXES) or key.startswith("graph_") or key in _COUNT_KEYS


def print_stage_stats(stats: dict, n_reads: int, total_bp: int, dt: float, file=sys.stderr):
    """Per-stage breakdown in the spirit of the reference's index stats
    line (main.rs:154-155): seconds, and the counters (bytes, reads,
    stages, batches, graph_*, anchors, chain_pairs, probe_queries) as
    integers."""
    parts = " ".join(
        f"{k}:{int(v)}" if _is_count(k) else f"{k}:{v:.2f}s"
        for k, v in sorted(stats.items()) if isinstance(v, (int, float))
    )
    print(
        f"[mm2t] mapped {n_reads} reads ({total_bp} bp) in {dt:.2f}s "
        f"({total_bp / max(dt, 1e-9):.0f} bp/s) | {parts}",
        file=file,
    )
