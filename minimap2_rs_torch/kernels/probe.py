"""Wrapper of the prefix-probe kernel (csrc/probe.cu), entry point
mm2t_probe_prefix.

It replaces the body of the prefix-probe branch of the index lookup
(ops/index_ops.prefix_probe, which stays as its plain version): the map
programs' stage "probe" on an index with no direct table, where
models/stages.probe routes it. Each query key reads only its own
bucket's rows of the key table `kv`, in place of the gather, compares
and reductions over all bucket_slots rows (see the source's header).

On CUDA tensors the wrapper launches the kernel or raises; on CPU
tensors it runs the plain version. Launches are counted under
"probe_prefix" (kernels/counts.py), replays of a captured program
included; the plain version does not count.
"""

from __future__ import annotations

import torch

from ..ops.index_ops import DeviceIndex, prefix_probe
from ..ops.sketch import ks_keys
from . import counts
from .chain_dp import _check

KEY = "probe_prefix"
# kernel launches, replays of a captured program included
launches = {KEY: 0}
# when a dict, each launch's inputs are kept under (KEY, B, M): the
# slots' tensors and the index, the first launch of each shape winning
# (launches outside a capture only)
captured: dict | None = None


def reset_launches() -> None:
    launches[KEY] = 0


def total_launches() -> int:
    return launches[KEY]


def _validate(idx: DeviceIndex, sks: torch.Tensor, keep: torch.Tensor) -> None:
    """Checks the inputs of a launch."""
    dev = sks.device
    _check("sks", sks, tuple(sks.shape), torch.int64, dev)
    _check("keep", keep, tuple(sks.shape), torch.bool, dev)
    kv, prefix = idx.kv, idx.prefix
    if kv.dim() != 2 or kv.shape[1] != 4 or not 1 <= kv.shape[0] < 1 << 31:
        raise ValueError(f"kv: expected (rows, 4) with 1 <= rows < 2^31, got "
                         f"{tuple(kv.shape)}")
    _check("kv", kv, tuple(kv.shape), torch.int32, dev)
    if kv.data_ptr() % 16:
        raise ValueError("kv: its rows must be 16-byte aligned")
    if prefix.dim() != 1 or not 2 <= prefix.shape[0] < 1 << 31:
        raise ValueError(f"prefix: expected (2^bits + 1,), got {tuple(prefix.shape)}")
    _check("prefix", prefix, tuple(prefix.shape), torch.int32, dev)
    if not 0 <= idx.prefix_shift < 64:
        raise ValueError(f"prefix_shift {idx.prefix_shift} out of [0, 64)")


def probe_prefix(idx: DeviceIndex, sks: torch.Tensor, keep: torch.Tensor):
    """The index lookup of every minimizer slot on an index with no direct
    table, as ops/seeds_ops.lookup_keys defines it: (start, count) int64
    of the shape of sks (int64 key_span words) of its key's occurrence
    block, 0 and 0 when absent; slots where keep is False probe key 0."""
    if idx.dm_slots:
        raise ValueError("the index has a direct table: its lookup is index_lookup's")
    dev = sks.device
    if dev.type == "cpu":
        return prefix_probe(idx, torch.where(keep, ks_keys(sks), 0))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _validate(idx, sks, keep)
    from .build import library

    start = torch.empty(sks.shape, dtype=torch.int64, device=dev)
    count = torch.empty(sks.shape, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = library().mm2t_probe_prefix(
            sks.data_ptr(), keep.data_ptr(), sks.numel(), idx.prefix.data_ptr(),
            idx.prefix.shape[0], idx.kv.data_ptr(), idx.prefix_shift, start.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mm2t_probe_prefix launch failed: cudaError {err}")
    if counts.count(launches, KEY) and captured is not None:
        captured.setdefault((KEY, *sks.shape), ((sks.clone(), keep.clone()), idx))
    return start, count
