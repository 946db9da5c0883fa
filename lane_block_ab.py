"""A/B of the chain-DP lane kernel's block size on one GPU.

    python3 lane_block_ab.py

Builds minimap2_rs_torch/csrc/chain_dp.cu three times, with
kLaneThreads = 256, 512 and 1024 (one nvcc each, in parallel, into
build/lane_ab/), then times the two lane entry points of each on the
same inputs, in turns (256, 512, 1024, then 1024, 512, 256; CUDA events
around 10 back-to-back launches, median of 5 each), beside the
warp-per-read template and the bound (chip_smoke._chain_bound).
Inputs, made from a seed: B = 128 reads of
A = 4480 anchor slots all valid; the same with every other read empty;
B = 16 at A = 11,904. Each is run at H = 1024 and 5000 (aux) and 5000
((f, prev)), and every output must be torch.equal to the template's.
Needs one CUDA GPU; exits non-zero otherwise or on any mismatch.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

BLOCKS = (256, 512, 1024)


def with_constants(src: str, **consts) -> str:
    """chain_dp.cu's source with each `constexpr int <name> = <value>;`
    of `consts` set (each must appear once)."""
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise RuntimeError(f"chain_dp.cu: {name} not found once")
    return src


def build_variants(out: Path, sources: dict, design: str):
    """One library per {name: source of chain_dp.cu}, built in parallel,
    with the two entry points of `design` ("lane", "short" or
    "prune_smem") bound; prints each build's ptxas registers, shared
    memory and spills of that design's kernels. Returns {name:
    ctypes.CDLL}."""
    from minimap2_rs_torch.kernels import build as kbuild

    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(out / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for i, (name, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        print(f"{name}: ptxas")
        for k, l in enumerate(lines):
            if "Compiling entry" in l and f"_{design.split('_')[0]}_kernel" in l:
                print("  ", " | ".join(x.strip() for x in lines[k:k + 4]))
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        for aux in (True, False):
            fn = getattr(lib, entry_name(aux, design))
            fn.restype = ci
            fn.argtypes = ([vp] * 4 + [vp] * (4 if aux else 2) + [vp, ci] + [ci] * 6 + [cf, cf]
                           + [ci] * design.startswith("prune") + [vp])
        libs[name] = lib
    return libs


def entry_name(aux: bool, design: str) -> str:
    return f"mm2t_chain_dp{'_aux' if aux else ''}_{design}"


def call_entry(lib, design, aux, args, scal, H, tab, outs=None, skip=None):
    """One launch of `design`'s entry point of `lib` on CUDA tensors, into
    `outs` (allocated here when None, which a short kernel's timing would
    then hold), with max_chain_skip `skip` for a pruned design; the
    outputs."""
    import torch

    B, A = args[0].shape
    if outs is None:
        outs = [torch.empty((B, A), dtype=torch.int32, device=args[0].device)
                for _ in range(4 if aux else 2)]
    fn = getattr(lib, entry_name(aux, design))
    err = fn(*[a.data_ptr() for a in args], *[o.data_ptr() for o in outs], tab.data_ptr(),
             tab.shape[0], B, A, min(H, A), scal.max_dist_x, scal.max_dist_y, scal.bw,
             scal.chn_pen_gap, scal.chn_pen_skip, *(() if skip is None else (skip,)),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{design} launch refused: cudaError {err}")
    return outs


def _inputs(rng, B, A, n_of):
    """(grp, rpos, qpos, span) on the card: read b holds n_of(b) anchors of
    one group along a jittered diagonal, padding after."""
    import numpy as np
    import torch

    cols = np.stack([np.full((B, A), -1, np.int64)] * 3 + [np.full((B, A), 255, np.int64)])
    for b in range(B):
        n = n_of(b)
        r = np.sort(rng.integers(0, 300_000, n))
        q = np.clip(r // 20 + rng.integers(-50, 50, n), 0, None)
        cols[0, b, :n], cols[1, b, :n], cols[2, b, :n], cols[3, b, :n] = 0, r, q, 15
    return tuple(torch.from_numpy(c.astype(np.uint32).view(np.int32).copy()).cuda()
                 for c in cols)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lane_block_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from minimap2_rs_torch.config import ChainParams
    from minimap2_rs_torch.kernels import chain_dp as kchain
    from minimap2_rs_torch.ops.chain_ops import chain_scalars_from_params, log2_table

    print(cs._nvidia_smi())
    out = Path(__file__).resolve().parent / "build" / "lane_ab"
    out.mkdir(parents=True, exist_ok=True)
    from minimap2_rs_torch.kernels import build as kbuild

    src = (kbuild.CSRC / "chain_dp.cu").read_text()
    libs = build_variants(out, {T: with_constants(src, kLaneThreads=T) for T in BLOCKS},
                          "lane")
    rng = np.random.default_rng(1)
    tab = log2_table(20001).cuda()
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    cases = [
        ("full B=128 A=4480", _inputs(rng, 128, 4480, lambda b: 4480)),
        ("half empty B=128 A=4480, n 500-4480", _inputs(
            rng, 128, 4480, lambda b: 0 if b % 2 else int(rng.integers(500, 4481)))),
        ("B=16 A=11904", _inputs(rng, 16, 11904, lambda b: 11904 - 500 * b)),
    ]
    for name, args in cases:
        A = args[0].shape[1]
        for aux, H in ((True, 1024), (False, 5000), (True, 5000)):
            ref = kchain.template_batch(aux, *args, scal, H, tab)
            res: dict = {}
            for order in (BLOCKS, BLOCKS[::-1]):
                for T in order:
                    got = call_entry(libs[T], "lane", aux, args, scal, H, tab)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, ref)):
                        raise AssertionError(f"{name}, T={T}, aux={aux}: != template")
                    res.setdefault(T, []).append(cs._time_ms(
                        lambda: call_entry(libs[T], "lane", aux, args, scal, H, tab),
                        inner=cs.KERNEL_INNER))
            tmpl = cs._time_ms(lambda: kchain.template_batch(aux, *args, scal, H, tab),
                               inner=cs.KERNEL_INNER)
            bound_ms, bound_by, _pairs = cs._chain_bound(args, scal, H, 4 if aux else 2,
                                                         tab, None)
            print(f"{name} aux={aux} H={min(H, A)}: "
                  + ", ".join(f"T={T} {v[0]:.4f}/{v[1]:.4f} ms" for T, v in res.items())
                  + f"; template {tmpl:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
