"""Wrapper of the odd-k sketch kernel (csrc/sketch.cu), entry point
mm2t_sketch_minimizers.

It replaces the XLA elementwise sketch of minimap2_rs_tpu/ops/sketch.py
(sketch_positions at odd k) together with the wire unpack before it and
the compaction after it, none of which was a Pallas kernel: the
mapper's query sketch, from one batch's H2D wire to the compacted
minimizers, in one launch that keeps every intermediate in registers
and shared memory (see the source's header).

On CUDA tensors the wrapper launches the kernel or raises; on CPU
tensors it runs the plain version, the chain it replaces:
ops/sketch.wire_codes (unpack_codes2 / unpack_codes4), sketch_positions,
compact_minimizers. Launches are counted per length class by the window
scan's rule (kernels/window_scan.shape_class): "long" for rows longer
than 4096 positions, else "short".
"""

from __future__ import annotations

import torch

from ..ops.sketch import WIRE_CODES, compact_minimizers, sketch_positions, wire_codes
from . import counts
from .chain_dp import _check
from .window_scan import SHAPES, shape_class

# the kernel's codes for the wires, and the dtype of each wire's rows
_WIRE_ID = {"2bit": 0, "4bit": 1, "nt4": 2}
_WIRE_DTYPE = {"2bit": torch.uint8, "4bit": torch.uint8, "nt4": torch.int32}
MAX_W = 255  # the kernel's halos are sized for w <= 255
MAX_K = 27   # the largest odd k (ops/sketch.MAX_K is 28)

# kernel launches per "sketch/<length class>", replays of a captured
# program included (kernels/counts.py); the plain version does not count
launches = {f"sketch/{s}": 0 for s in SHAPES}
# when a dict, each launch's inputs are kept under (key, L), the first
# launch of each key winning (launches outside a capture only)
captured: dict | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def total_launches() -> int:
    return sum(launches.values())


def _validate(rows, lengths, nex, wire: str, w: int, k: int, M: int) -> int:
    """Checks the inputs of a launch; returns L."""
    if rows.dim() != 2:
        raise ValueError(f"rows: expected (B, L/{WIRE_CODES[wire]}), got shape "
                         f"{tuple(rows.shape)}")
    B, dev = rows.shape[0], rows.device
    L = rows.shape[1] * WIRE_CODES[wire]
    _check("rows", rows, tuple(rows.shape), _WIRE_DTYPE[wire], dev)
    if tuple(lengths.shape) != (B,) or lengths.device != dev or lengths.is_floating_point():
        raise ValueError(f"lengths: expected ({B},) integers on {dev}, got "
                         f"{tuple(lengths.shape)} {lengths.dtype} on {lengths.device}")
    if wire == "2bit":
        if nex is None or nex.dim() != 1:
            raise ValueError("the 2-bit wire needs its (n,) N list nex")
        _check("nex", nex, tuple(nex.shape), torch.int32, dev)
    if L > 1 << 22:
        raise ValueError("reads longer than 4M bases are unsupported")
    if not 1 <= w <= MAX_W or not 1 <= k <= MAX_K or k % 2 == 0 or M < 0:
        raise ValueError(f"the sketch kernel takes 1 <= w <= {MAX_W}, odd k <= {MAX_K} and "
                         f"M >= 0, got w={w}, k={k}, M={M}")
    return L


def sketch_minimizers(
    rows: torch.Tensor,      # the batch on `wire`: (B, L/4) or (B, L/2) uint8, or (B, L) int32
    lengths: torch.Tensor,   # (B,) true lengths
    nex: torch.Tensor | None,  # the 2-bit wire's flat N positions b*L+p, ascending, padded with B*L
    wire: str,               # "2bit", "4bit" or "nt4"
    w: int,
    k: int,
    M: int,
):
    """The query sketch's compacted minimizers, compact_minimizers(
    *sketch_positions(codes, lengths, w, k), M) of the batch's nt4 codes:
    (cks (B, M) int64 key<<8|span padded with KS_INVALID, cps (B, M)
    int64 pos<<1|strand padded with INV32, n_mini (B,) int32, mini_ovf
    (B,) bool). The kernel takes odd k only, and the 2-bit wire's N list
    in increasing order, as the host encoder writes it."""
    if wire not in WIRE_CODES:
        raise ValueError(f"unknown wire {wire!r}")
    dev = rows.device
    if dev.type == "cpu":
        ks, ps, emitted = sketch_positions(wire_codes(rows, lengths, nex, wire), lengths, w, k)
        return compact_minimizers(ks, ps, emitted, M)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L = _validate(rows, lengths, nex, wire, w, k, M)
    B = rows.shape[0]
    if B * L >= 1 << 31:
        raise ValueError(f"B * L = {B * L} must stay below 2^31 (the N list is int32)")
    from .build import library

    lengths = lengths.to(torch.int32).contiguous()
    if nex is None:
        nex = torch.empty(0, dtype=torch.int32, device=dev)
    cks = torch.empty((B, M), dtype=torch.int64, device=dev)
    cps = torch.empty((B, M), dtype=torch.int64, device=dev)
    n_mini = torch.empty(B, dtype=torch.int32, device=dev)
    mini_ovf = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().mm2t_sketch_minimizers(
            rows.data_ptr(), _WIRE_ID[wire], lengths.data_ptr(), nex.data_ptr(),
            nex.shape[0], cks.data_ptr(), cps.data_ptr(), n_mini.data_ptr(),
            mini_ovf.data_ptr(), B, L, w, k, M, stream,
        )
    if err != 0:
        raise RuntimeError(f"mm2t_sketch_minimizers launch failed: cudaError {err}")
    key = f"sketch/{shape_class(L)}"
    if counts.count(launches, key) and captured is not None:
        captured.setdefault((key, L), (
            tuple(t.clone() for t in (rows, lengths, nex)), wire, w, k, M))
    return cks, cps, n_mini, mini_ovf
