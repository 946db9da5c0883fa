"""Wrapper of the window-scan kernel (csrc/window_scan.cu), entry point
mm2t_window_scan.

It replaces the `lax.scan` window recurrence of
minimap2_rs_tpu/ops/sketch_scan.py (_window_scan, :109-241), the even-k
sketch. That scan is not a Pallas kernel; the port writes one because
the recurrence is sequential over positions. One thread per read walks
the positions with a w-slot ring buffer in a global scratch, so it is
bound by per-step latency (see the source's header).

On CUDA tensors the wrapper launches the kernel or raises; on CPU
tensors it runs the plain version, ops/sketch_scan._window_scan_ref.
Launches are counted per length class: "long" for rows longer than
4096 positions (the mapper's long-read buckets), else "short".
"""

from __future__ import annotations

import torch

from ..ops.sketch_scan import _window_scan_ref
from .chain_dp import _check

SHAPES = ("short", "long")
LONG_L = 4096

# kernel launches per "window_scan/<length class>"; the plain version
# does not count
launches = {f"window_scan/{s}": 0 for s in SHAPES}
# when a dict, each launch's inputs are kept under (key, L), the first
# launch of each key winning
captured: dict | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def shape_class(L: int) -> str:
    return "long" if L > LONG_L else "short"


def window_scan(
    ks: torch.Tensor,        # (B, L) int64 key<<8|span bit patterns
    ps: torch.Tensor,        # (B, L) int64 pos<<1|strand, 0xFFFFFFFF invalid
    l_eff: torch.Tensor,     # (B, L) int32 the reference's l counter
    lengths: torch.Tensor,   # (B,) int32 true lengths
    w: int,
    k: int,
    emit_final: torch.Tensor,  # (B,) bool: flush the minimum at the end
) -> torch.Tensor:
    """(B, L) bool mask of the positions the reference's scan emits."""
    if ks.dim() != 2:
        raise ValueError(f"ks: expected (B, L), got shape {tuple(ks.shape)}")
    B, L = ks.shape
    dev = ks.device
    _check("ks", ks, (B, L), torch.int64, dev)
    _check("ps", ps, (B, L), torch.int64, dev)
    _check("l_eff", l_eff, (B, L), torch.int32, dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    _check("emit_final", emit_final, (B,), torch.bool, dev)
    if not 1 <= w < 256 or not 1 <= k <= 28:
        raise ValueError(f"need 1 <= w < 256 and 1 <= k <= 28, got w={w}, k={k}")
    if dev.type == "cpu":
        return _window_scan_ref(ks, ps, l_eff, lengths, w, k, emit_final)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from .build import library

    emitted = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    ring_x = torch.empty((w, B), dtype=torch.int64, device=dev)
    ring_y = torch.empty((w, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().mm2t_window_scan(
            ks.data_ptr(), ps.data_ptr(), l_eff.data_ptr(), lengths.data_ptr(),
            emit_final.data_ptr(), emitted.data_ptr(), ring_x.data_ptr(),
            ring_y.data_ptr(), B, L, w, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"mm2t_window_scan launch failed: cudaError {err}")
    key = f"window_scan/{shape_class(L)}"
    launches[key] += 1
    if captured is not None:
        captured.setdefault((key, L), (
            tuple(t.clone() for t in (ks, ps, l_eff, lengths, emit_final)), w, k))
    return emitted.view(torch.bool)
