"""Wrappers of the chain-DP kernel's two variants (csrc/chain_dp.cu).

`chain_dp_aux_batch` -> (f, cnt, sq, sr), the lite path's DP, entry point
mm2t_chain_dp_aux. It replaces the aux kernels of
minimap2_rs_tpu/ops/chain_pallas.py reached through
chain_dp_aux_batch_pallas: `_static_aux_kernel` (A < 1024, full window),
`_chain_aux_kernel` (A < 1024, truncated window) and
`_chain_aux_kernel_lane` (A >= 1024).

`chain_dp_batch` -> (f, prev), the general path's DP, entry point
mm2t_chain_dp. It replaces the kernels reached through
chain_dp_batch_pallas: `_static_kernel`, `_chain_kernel` and
`_chain_kernel_lane`, at the same shapes.

With max_chain_skip set, each wrapper launches the variant's pruned
instance instead (mm2t_chain_dp_prune, mm2t_chain_dp_aux_prune, and their
"_smem" design): the reference's max_chain_skip early break, which the
JAX package runs in its lax.scan DP under MM2T_SKIP_PRUNE
(ops/chain_ops.py:80-137); it has no Pallas counterpart.

Four designs, picked by shape before the launch (`design`), each with a
runtime window H = min(window, A):
- "short", at A < 1024 with an exact window (the static and dynamic
  shape classes): the short-read kernel (mm2t_chain_dp_aux_short,
  mm2t_chain_dp_short), a warp per read with the whole read in shared
  memory, 32-bit scoring and hardware warp reductions, when its block of
  SHORT_READS reads fits shared memory;
- "lane", at A >= 1024 with an exact window whose shared-memory ring
  fits a block: the block-per-read kernel (mm2t_chain_dp_aux_lane,
  mm2t_chain_dp_lane: the window in shared memory, one barrier per row);
- "smem", with max_chain_skip, when the read fits a block's shared
  memory: the pruned kernel (mm2t_chain_dp_aux_prune_smem,
  mm2t_chain_dp_prune_smem), a warp per read with the read in shared
  memory, walking each row's window in chunks of 32 with warp scans in
  place of a serial walk;
- "template" for every other call (blocks that would not fit): the
  warp-per-read template, which reads the window from global memory.
All are bound by the sequential row walk's per-step latency, not FLOPs
(see the source's headers).

Anchor order. The plain versions, the template, the lane kernel and the
pruned kernel admit a predecessor with dr != 0, so an anchor to the
right of i in the reference (dr < 0) may chain; the short-read kernel,
like the Pallas static kernel, rejects dr < 0 with an unsigned compare.
The designs agree on anchors sorted by reference position within each
group, which every caller passes (models/stages.chain_inputs and the
CLI), so no output depends on the design.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain version in ops/chain_ops.py. Launches are
counted per variant (a pruned launch under "<variant>_prune") and per
the Pallas kernel's shape class, whichever design runs it.
"""

from __future__ import annotations

import torch

from ..ops.chain_ops import ChainScalars, chain_dp_aux_batch_ref, chain_dp_batch_ref
from . import counts

SHAPES = ("static", "dynamic", "lane")

# kernel launches per "variant/shape" (the main path's proof that it ran
# through each kernel at each shape), replays of a captured program
# included (kernels/counts.py); the plain versions do not count
VARIANTS = ("chain_dp_aux", "chain_dp", "chain_dp_aux_prune", "chain_dp_prune")
launches = {f"{v}/{s}": 0 for v in VARIANTS for s in SHAPES}
# when a dict, each launch's inputs are kept under (variant/shape, bw, A),
# the first launch of each key winning, so the kernel can be held against
# its plain version at exactly the shapes a run gave it (launches outside
# a capture only)
captured: dict | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def shape_class(A: int, window: int) -> str:
    """The Pallas kernel a (B, A) call with this window stands for
    (chain_dp_batch_pallas, chain_pallas.py:661-688): "lane" at
    A >= 1024, "static" for a full window, else "dynamic"."""
    if A >= 1024:
        return "lane"
    return "static" if window >= A else "dynamic"


# the lane kernel's block size and tile (kLaneThreads = kLaneTile in
# csrc/chain_dp.cu), and the dynamic shared memory its ring may take: a
# block's 227 KB, less 1 KB for its static partials
LANE_THREADS = 512
LANE_SMEM_MAX = 227 * 1024 - 1024


def lane_ring_bytes(H: int, aux: bool) -> int:
    """Shared memory of the lane kernel's ring at window H: H + one tile
    of slots, 8 words a slot for aux (grp, rpos, qpos, span, f, cnt, sq,
    sr), 5 for (f, prev)."""
    return (H + LANE_THREADS) * (8 if aux else 5) * 4


# the short-read kernel's reads per block and staged table entries
# (kShortReads, kShortTab in csrc/chain_dp.cu), and the dynamic shared
# memory its block may take: 227 KB, less 1 KB for its static partials
SHORT_READS = 4
SHORT_TAB = 1024
SHORT_SMEM_MAX = 227 * 1024 - 1024


def short_block_bytes(A: int, aux: bool) -> int:
    """Shared memory of a short-read kernel block: the staged table, and
    for each of its reads A slots of 8 words for aux (grp, rpos, qpos,
    span, f, cnt, sq, sr), 6 for (f, prev)."""
    return SHORT_TAB * 4 + SHORT_READS * A * (8 if aux else 6) * 4


# the dynamic shared memory a pruned kernel's block may take: 227 KB
PRUNE_SMEM_MAX = 227 * 1024


def prune_block_bytes(A: int, aux: bool) -> int:
    """Shared memory of a pruned kernel's block, one read: A slots of 10
    words for aux (grp, rpos, qpos, span, f, prev, the marks t, cnt, sq,
    sr), 7 for (f, prev)."""
    return A * (10 if aux else 7) * 4


def design(A: int, window: int, aux: bool, max_chain_skip: int | None) -> str:
    """The design a (B, A) call takes, by shape, before the launch:
    "short" for the exact window at A < 1024, "lane" for the exact window
    at A >= 1024, "smem" with max_chain_skip, each when its block fits
    shared memory, else "template"."""
    if max_chain_skip is not None:
        return "smem" if prune_block_bytes(A, aux) <= PRUNE_SMEM_MAX else "template"
    if shape_class(A, window) == "lane":
        fits = lane_ring_bytes(min(window, A), aux) <= LANE_SMEM_MAX
        return "lane" if fits else "template"
    return "short" if short_block_bytes(A, aux) <= SHORT_SMEM_MAX else "template"


def entry_point(variant: str, design_: str) -> str:
    """The library entry of `variant` ("chain_dp_aux", "chain_dp", or
    either with "_prune") in a design."""
    return f"mm2t_{variant}" + ("" if design_ == "template" else f"_{design_}")


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _validate(grp, rpos, qpos, span, scalars: ChainScalars, window: int,
              log2_tab: torch.Tensor, max_chain_skip: int | None) -> torch.device:
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
    if max_chain_skip is not None and max_chain_skip < 0:
        raise ValueError("max_chain_skip must be >= 0")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(entry: str, n_out: int, grp, rpos, qpos, span, scalars: ChainScalars,
            window: int, log2_tab: torch.Tensor, max_chain_skip: int | None):
    """One launch of the library's `entry` on validated CUDA inputs;
    returns its n_out (B, A) int32 outputs. Raises if the launch is
    refused."""
    from .build import library

    fn = getattr(library(), entry)
    dev = grp.device
    B, A = grp.shape
    new = lambda: torch.empty((B, A), dtype=torch.int32, device=dev)
    outs = [new() for _ in range(n_out)]
    prune = max_chain_skip is not None
    # the template's pruned instances' scratch: prev (aux only) and the
    # marks t
    scratch = [new() for _ in range(1 + (n_out == 4))] if entry.endswith("_prune") else []
    tail = (max_chain_skip,) if prune else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            grp.data_ptr(), rpos.data_ptr(), qpos.data_ptr(), span.data_ptr(),
            *(o.data_ptr() for o in outs + scratch),
            log2_tab.data_ptr(), log2_tab.shape[0],
            B, A, min(window, A),
            scalars.max_dist_x, scalars.max_dist_y, scalars.bw,
            scalars.chn_pen_gap, scalars.chn_pen_skip,
            *tail, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return tuple(outs)


def _run(variant: str, n_out: int, ref, grp, rpos, qpos, span,
         scalars: ChainScalars, window: int, log2_tab: torch.Tensor,
         max_chain_skip: int | None):
    """Validate, then the plain version on the CPU or one kernel launch
    on CUDA; returns n_out (B, A) int32 tensors."""
    dev = _validate(grp, rpos, qpos, span, scalars, window, log2_tab, max_chain_skip)
    if dev.type == "cpu":
        return ref(grp, rpos, qpos, span, scalars, window, log2_tab,
                   max_chain_skip=max_chain_skip)
    A = grp.shape[1]
    if max_chain_skip is not None:
        variant += "_prune"
    entry = entry_point(variant, design(A, window, n_out == 4, max_chain_skip))
    outs = _launch(entry, n_out, grp, rpos, qpos, span, scalars, window, log2_tab,
                   max_chain_skip)
    key = f"{variant}/{shape_class(A, window)}"
    if counts.count(launches, key) and captured is not None:
        captured.setdefault((key, scalars.bw, A), (
            tuple(t.clone() for t in (grp, rpos, qpos, span)), scalars, window,
            max_chain_skip))
    return outs


def template_batch(aux: bool, grp, rpos, qpos, span, scalars: ChainScalars,
                   window: int, log2_tab: torch.Tensor, max_chain_skip: int | None = None):
    """The DP through the warp-per-read template (its pruned instance
    with max_chain_skip) at any shape, on CUDA tensors: the design the
    short, lane and pruned shapes ran before their own kernels, kept
    callable so a run can time both on the same inputs. Not a path of
    the mapper, and not counted."""
    dev = _validate(grp, rpos, qpos, span, scalars, window, log2_tab, max_chain_skip)
    if dev.type != "cuda":
        raise ValueError("template_batch launches a kernel: CUDA tensors only")
    variant = ("chain_dp_aux" if aux else "chain_dp") + (
        "" if max_chain_skip is None else "_prune")
    return _launch(entry_point(variant, "template"), 4 if aux else 2, grp, rpos, qpos,
                   span, scalars, window, log2_tab, max_chain_skip)


def chain_dp_aux_batch(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32 on grp's device
    max_chain_skip: int | None = None,
):
    """(f, cnt, sq, sr), each (B, A) int32 — see chain_dp_aux_batch_ref.
    max_chain_skip=None scores the window exactly; an int runs the
    reference's pruned walk."""
    return _run("chain_dp_aux", 4, chain_dp_aux_batch_ref, grp, rpos, qpos,
                span, scalars, window, log2_tab, max_chain_skip)


def chain_dp_batch(
    grp: torch.Tensor,   # (B, A) int32 rev<<31|rid (padding -1)
    rpos: torch.Tensor,  # (B, A) int32
    qpos: torch.Tensor,  # (B, A) int32
    span: torch.Tensor,  # (B, A) int32
    scalars: ChainScalars,
    window: int,
    log2_tab: torch.Tensor,  # (>= bw + 1,) float32 on grp's device
    max_chain_skip: int | None = None,
):
    """(f, prev), each (B, A) int32 — see chain_dp_batch_ref.
    max_chain_skip as in chain_dp_aux_batch."""
    return _run("chain_dp", 2, chain_dp_batch_ref, grp, rpos, qpos, span,
                scalars, window, log2_tab, max_chain_skip)
