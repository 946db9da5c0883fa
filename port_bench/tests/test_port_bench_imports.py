"""What the benchmark loads: no module of JAX or of the JAX package in
a run's process, and nothing of the mapper in the reference. Top-level
names are compared whole (minimap2_rs_torch begins with minimap2_rs)."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "minimap2_rs_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = ["port_bench.harness", "port_bench.control", "port_bench.generate",
            "minimap2_rs_torch.config", "minimap2_rs_torch.models.index_builder",
            "minimap2_rs_torch.models.mapper"]
    metrics = sorted(p.stem for p in (ROOT / "port_bench/metrics").glob("*.py"))
    code = "\n".join(f"import {m}" for m in mods) + "\nfrom port_bench import harness\n" + \
        "\n".join(f"harness.metric_reader(harness.Path({str(ROOT)!r}), {m!r})" for m in metrics)
    assert _loaded(code) & JAX == set()


def test_the_reference_loads_nothing_of_the_mapper():
    code = "\n".join(f"import port_bench.reference.{p.stem}"
                     for p in (ROOT / "port_bench/reference").glob("*.py"))
    assert _loaded(code) & (JAX | {"minimap2_rs_torch"}) == set()


def test_no_source_of_the_benchmark_imports_jax():
    for path in (ROOT / "port_bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            tops = {n.split(".", 1)[0] for n in names}
            assert tops & JAX == set(), path
            if "reference" in path.parts:
                assert "minimap2_rs_torch" not in tops, path
