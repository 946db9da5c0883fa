"""Build the port's CUDA kernels into one shared library and load it.

The sources under minimap2_rs_torch/csrc are compiled by nvcc for
Hopper (sm_90a), one nvcc process per source, all started together, and
linked into <checkout>/build/kernels/libmm2t_torch_kernels.so at first
use, with a plain C interface that kernels/*.py bind through ctypes. A
library older than any source is rebuilt. Nothing is built or loaded
when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmm2t_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # the chain penalty must round after every f32 op (the kernel also
    # spells it with __fmul_rn/__fadd_rn)
    "-fmad=false",
    "-Xptxas", "-v",
]

# the chain-DP entry points of csrc/chain_dp.cu, each with its count of
# output and scratch pointers and whether it takes max_chain_skip
CHAIN_ENTRIES = (
    ("mm2t_chain_dp_aux", 4, False), ("mm2t_chain_dp", 2, False),
    ("mm2t_chain_dp_aux_short", 4, False), ("mm2t_chain_dp_short", 2, False),
    ("mm2t_chain_dp_aux_lane", 4, False), ("mm2t_chain_dp_lane", 2, False),
    ("mm2t_chain_dp_aux_prune", 6, True), ("mm2t_chain_dp_prune", 3, True),
    ("mm2t_chain_dp_aux_prune_smem", 4, True), ("mm2t_chain_dp_prune_smem", 2, True),
)

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile every csrc/*.cu into the library (if stale); returns its
    path. ptxas's register/spill report is kept in `build_log`."""
    global build_log
    out = BUILD_DIR / LIB_NAME
    srcs = sorted(CSRC.glob("*.cu"))
    if out.exists() and all(
        out.stat().st_mtime >= s.stat().st_mtime for s in srcs
    ):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
    tmp = out.with_suffix(f".{tag}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for o in objs:
        o.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, n_out, prune in CHAIN_ENTRIES:
            fn = getattr(lib, name)
            fn.restype = ci
            fn.argtypes = [
                vp, vp, vp, vp,      # grp, rpos, qpos, span
                *[vp] * n_out,       # outputs (f, cnt, sq, sr / f, prev), scratch
                vp, ci,              # log2 table, its length
                ci, ci, ci,          # B, A, H
                ci, ci, ci,          # max_dist_x, max_dist_y, bw
                cf, cf,              # pen_gap, pen_skip
                *[ci] * prune,       # max_chain_skip
                vp,                  # stream
            ]
        for name, n_scratch in (("mm2t_window_scan", 2), ("mm2t_window_scan_tile", 0)):
            fn = getattr(lib, name)
            fn.restype = ci
            fn.argtypes = [
                vp, vp, vp, vp, vp,  # ks, ps, l_eff, lengths, emit_final
                vp,                  # emitted
                *[vp] * n_scratch,   # ring_x, ring_y (the sequential design)
                ci, ci, ci, ci,      # B, L, w, k
                vp,                  # stream
            ]
        fn = lib.mm2t_sketch_minimizers
        fn.restype = ci
        fn.argtypes = [
            vp, ci, vp, vp, ci,  # rows, wire, lengths, nex, its length
            vp, vp, vp, vp,      # cks, cps, n_mini, mini_ovf
            ci, ci, ci, ci, ci,  # B, L, w, k, M
            vp,                  # stream
        ]
        fn = lib.mm2t_probe_prefix
        fn.restype = ci
        fn.argtypes = [
            vp, vp, ctypes.c_longlong,  # sks, keep, slots
            vp, ci, vp, ci,             # prefix, its length, kv, prefix_shift
            vp, vp,                     # start, count
            vp,                         # stream
        ]
        _lib = lib
    return _lib
