"""Wrapper of the aux chain-DP kernel (csrc/chain_dp.cu).

Replaces minimap2_rs_tpu/ops/chain_pallas.py's `_static_aux_kernel`
(A < 1024, full window) and `_chain_aux_kernel_lane` (A >= 1024, sliding
window), both reached through chain_dp_aux_batch_pallas: one CUDA kernel
with a runtime window H = min(window, A) covers both. It is bound by
per-step latency and global-memory window reads, not FLOPs (one warp per
read walks the sequential DP; see the source's header).

On CUDA tensors `chain_dp_aux_batch` launches the kernel or raises; on
CPU tensors it runs the plain version, ops/chain_ops.chain_dp_aux_batch_ref.
"""

from __future__ import annotations

import torch

from ..ops.chain_ops import ChainScalars, chain_dp_aux_batch_ref

# kernel launches made by chain_dp_aux_batch (the main path's proof that
# it ran through the kernel); the plain version does not count
launches = 0


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def chain_dp_aux_batch(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32 on grp's device
):
    """(f, cnt, sq, sr), each (B, A) int32 — see chain_dp_aux_batch_ref."""
    global launches
    if grp.dim() != 2:
        raise ValueError(f"grp: expected (B, A), got shape {tuple(grp.shape)}")
    dev = grp.device
    for name, t in (("grp", grp), ("rpos", rpos), ("qpos", qpos), ("span", span)):
        _check(name, t, grp.shape, torch.int32, dev)
    if log2_tab.dim() != 1 or log2_tab.shape[0] <= scalars.bw:
        raise ValueError("log2_tab must be 1-D with at least bw + 1 entries")
    _check("log2_tab", log2_tab, log2_tab.shape, torch.float32, dev)
    if window < 1:
        raise ValueError("window must be >= 1")
    if dev.type == "cpu":
        return chain_dp_aux_batch_ref(grp, rpos, qpos, span, scalars, window, log2_tab)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from .build import library

    lib = library()
    B, A = grp.shape
    outs = [torch.empty((B, A), dtype=torch.int32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mm2t_chain_dp_aux(
            grp.data_ptr(), rpos.data_ptr(), qpos.data_ptr(), span.data_ptr(),
            *(o.data_ptr() for o in outs),
            log2_tab.data_ptr(), log2_tab.shape[0],
            B, A, min(window, A),
            scalars.max_dist_x, scalars.max_dist_y, scalars.bw,
            scalars.chn_pen_gap, scalars.chn_pen_skip,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mm2t_chain_dp_aux launch failed: cudaError {err}")
    launches += 1
    return tuple(outs)
