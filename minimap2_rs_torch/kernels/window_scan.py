"""Wrapper of the window-scan kernel (csrc/window_scan.cu), entry point
mm2t_window_scan_tile.

It replaces the `lax.scan` window recurrence of
minimap2_rs_tpu/ops/sketch_scan.py (_window_scan, :109-241), the even-k
sketch. That scan is not a Pallas kernel; the port writes one because
the recurrence, as the reference states it, is sequential over
positions. The kernel computes each position's step from the window
around it alone (the tracked minimum is always the window's argmin), a
thread a position, a block a tile of 256 positions of one read (see the
source's header). `sequential_scan` keeps the first design, one thread
per read walking a w-slot ring in a global scratch (mm2t_window_scan),
callable for timing beside it.

On CUDA tensors the wrapper launches the kernel or raises; on CPU
tensors it runs the plain version, ops/sketch_scan._window_scan_ref.
Launches are counted per length class: "long" for rows longer than
4096 positions (the mapper's long-read buckets), else "short".
"""

from __future__ import annotations

import torch

from ..ops.sketch_scan import _window_scan_ref
from . import counts
from .chain_dp import _check

SHAPES = ("short", "long")
LONG_L = 4096

# kernel launches per "window_scan/<length class>", replays of a captured
# program included (kernels/counts.py); the plain version does not count
launches = {f"window_scan/{s}": 0 for s in SHAPES}
# when a dict, each launch's inputs are kept under (key, L), the first
# launch of each key winning (launches outside a capture only)
captured: dict | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def shape_class(L: int) -> str:
    return "long" if L > LONG_L else "short"


def _validate(ks, ps, l_eff, lengths, w: int, k: int, emit_final) -> torch.device:
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(entry: str, ks, ps, l_eff, lengths, w: int, k: int, emit_final) -> torch.Tensor:
    """One launch of the library's `entry` on validated CUDA inputs;
    returns the (B, L) bool mask. Raises if the launch is refused."""
    from .build import library

    B, L = ks.shape
    dev = ks.device
    emitted = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    # the sequential design's ring scratch
    scratch = ((torch.empty((w, B), dtype=torch.int64, device=dev),
                torch.empty((w, B), dtype=torch.int32, device=dev))
               if entry == "mm2t_window_scan" else ())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(library(), entry)(
            ks.data_ptr(), ps.data_ptr(), l_eff.data_ptr(), lengths.data_ptr(),
            emit_final.data_ptr(), emitted.data_ptr(), *(t.data_ptr() for t in scratch),
            B, L, w, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return emitted.view(torch.bool)


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
    dev = _validate(ks, ps, l_eff, lengths, w, k, emit_final)
    if dev.type == "cpu":
        return _window_scan_ref(ks, ps, l_eff, lengths, w, k, emit_final)
    emitted = _launch("mm2t_window_scan_tile", ks, ps, l_eff, lengths, w, k, emit_final)
    L = ks.shape[1]
    key = f"window_scan/{shape_class(L)}"
    if counts.count(launches, key) and captured is not None:
        captured.setdefault((key, L), (
            tuple(t.clone() for t in (ks, ps, l_eff, lengths, emit_final)), w, k))
    return emitted


def sequential_scan(ks, ps, l_eff, lengths, w: int, k: int, emit_final) -> torch.Tensor:
    """The same mask through the first design (mm2t_window_scan: one
    thread per read), on CUDA tensors, kept callable so a run can time
    both designs on the same inputs. Not a path of the mapper, and not
    counted."""
    if _validate(ks, ps, l_eff, lengths, w, k, emit_final).type != "cuda":
        raise ValueError("sequential_scan launches a kernel: CUDA tensors only")
    return _launch("mm2t_window_scan", ks, ps, l_eff, lengths, w, k, emit_final)
