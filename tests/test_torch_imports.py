"""The port never imports jax nor anything of the JAX package
(minimap2_rs_tpu), and its kernel wrappers validate what they are given
before any launch."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minimap2_rs_torch.device import resolve_device
from minimap2_rs_torch.kernels.chain_dp import chain_dp_aux_batch, chain_dp_batch
from minimap2_rs_torch.kernels.window_scan import window_scan
from minimap2_rs_torch.ops.chain_ops import ChainScalars, log2_table

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "minimap2_rs_torch").rglob("*.py")
    )
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    for m in ("models.mapper", "models.index_builder", "cli", "ops.sketch_scan",
              "ops.index_build", "ops.extend_ops", "kernels.window_scan", "config",
              "io.fasta", "oracle.pipeline", "runtime.host", "utils.profiling",
              "parallel.mesh", "parallel.sharded_index", "parallel.pipeline",
              "parallel.ranks", "models.mesh_mapper", "utils.measure"):
        assert f"minimap2_rs_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['bench_torch']!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'minimap2_rs_tpu')))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _port_sources():
    return sorted((ROOT / "minimap2_rs_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "dryrun_multigpu_torch.py", ROOT / "bench_torch.py"]


def _imported(tree: ast.AST):
    """Every module name an import statement of `tree` names, at any depth
    (relative imports as written, without their package)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_never_imports_jax_package(path):
    """No import statement of the port, of chip_smoke.py, of
    dryrun_multigpu_torch.py or of bench_torch.py, at module level or
    inside a function, names minimap2_rs_tpu or jax."""
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in ("minimap2_rs_tpu", "jax", "jaxlib")]
    assert not bad, bad


SCAL = ChainScalars(max_dist_x=5000, max_dist_y=5000, bw=500,
                    chn_pen_gap=0.12, chn_pen_skip=0.0)


def _args(B=2, A=16):
    return [torch.zeros((B, A), dtype=torch.int32) for _ in range(4)]


BAD = ["dtype", "noncontig", "shape", "ndim", "table"]


def _rejects(wrapper, bad):
    args = _args()
    tab = log2_table(SCAL.bw + 1)
    if bad == "dtype":
        args[1] = args[1].to(torch.int64)
    elif bad == "noncontig":
        args[2] = torch.zeros((16, 2), dtype=torch.int32).t()
    elif bad == "shape":
        args[3] = torch.zeros((2, 8), dtype=torch.int32)
    elif bad == "ndim":
        args = [a.reshape(-1) for a in args]
    elif bad == "table":
        tab = log2_table(SCAL.bw)  # one entry short
    with pytest.raises((TypeError, ValueError)):
        wrapper(*args, SCAL, 8, tab)


@pytest.mark.parametrize("bad", BAD)
def test_chain_wrapper_rejects_bad_inputs(bad):
    _rejects(chain_dp_aux_batch, bad)


@pytest.mark.parametrize("bad", BAD)
def test_prev_chain_wrapper_rejects_bad_inputs(bad):
    _rejects(chain_dp_batch, bad)


def test_wrappers_reject_other_devices():
    args = [a.to("meta") for a in _args()]
    tab = log2_table(SCAL.bw + 1).to("meta")
    for wrapper in (chain_dp_aux_batch, chain_dp_batch):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(*args, SCAL, 8, tab)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _scan_args(B=2, L=16):
    z = lambda dt: torch.zeros((B, L), dtype=dt)
    return [z(torch.int64), z(torch.int64), z(torch.int32),
            torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool)]


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "shape", "w", "k", "device"])
def test_window_scan_wrapper_rejects_bad_inputs(bad):
    args, w, k = _scan_args(), 10, 14
    if bad == "dtype":
        args[2] = args[2].to(torch.int64)
    elif bad == "noncontig":
        args[0] = torch.zeros((16, 2), dtype=torch.int64).t()
    elif bad == "shape":
        args[3] = torch.zeros(3, dtype=torch.int32)
    elif bad == "w":
        w = 256
    elif bad == "k":
        k = 29
    elif bad == "device":
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        window_scan(args[0], args[1], args[2], args[3], w, k, args[4])
