"""The port's benchmark: one run of one cell (see port_bench/harness.py).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds minimap2_rs_torch. It needs a
CUDA device and exits non-zero, printing no result, without one.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def apply_program_env(root: Path, argv: list[str]) -> dict:
    """Set the cell's configuration's `program_env` before NumPy or torch
    is imported, since some settings (NPY_DISABLE_CPU_FEATURES) are read
    at import; the harness sets them again for the run. Nothing is set
    when the cell cannot be found: the harness then says why."""
    try:
        name = argv[argv.index("--workload") + 1]
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cell = next(c for c in bench["workloads"] if c["name"] == name)
        cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
        env = json.loads((root / cfg["file"]).read_text()).get("program_env", {})
    except (ValueError, IndexError, OSError, StopIteration, KeyError):
        return {}
    env = {k: str(v) for k, v in env.items()}
    os.environ.update(env)
    return env


def main() -> int:
    apply_program_env(ROOT, sys.argv[1:])
    sys.path.insert(0, str(ROOT))
    from port_bench.harness import RunError, run

    try:
        return run(sys.argv[1:], root=ROOT, t_start=T_START)
    except RunError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return e.code


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the mapper's submit thread is a daemon; nothing is left running
    os._exit(code)
