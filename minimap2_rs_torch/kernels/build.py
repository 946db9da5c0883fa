"""Build the port's CUDA kernels into one shared library and load it.

The sources under minimap2_rs_torch/csrc are compiled by nvcc for
Hopper (sm_90a) into <checkout>/build/kernels/libmm2t_torch_kernels.so
at first use, with a plain C interface that kernels/*.py bind through
ctypes. A library older than any source is rebuilt. Nothing is built or
loaded when this module is imported.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # the chain penalty must round after every f32 op (the kernel also
    # spells it with __fmul_rn/__fadd_rn)
    "-fmad=false",
    "-Xptxas", "-v",
]

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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn, n_out in ((lib.mm2t_chain_dp_aux, 4), (lib.mm2t_chain_dp, 2)):
            fn.restype = ci
            fn.argtypes = [
                vp, vp, vp, vp,      # grp, rpos, qpos, span
                *[vp] * n_out,       # f, cnt, sq, sr / f, prev
                vp, ci,              # log2 table, its length
                ci, ci, ci,          # B, A, H
                ci, ci, ci,          # max_dist_x, max_dist_y, bw
                cf, cf,              # pen_gap, pen_skip
                vp,                  # stream
            ]
        _lib = lib
    return _lib
