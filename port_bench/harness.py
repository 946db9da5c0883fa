"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration, whose file
holds the genome's sequences and the minimap2 preset, and a traffic mix,
port_bench/traffic/<mix>.json. Each metric is read from the run's record
by port_bench/metrics/<metric>.py. Nothing else is named in code, so a
later cell, mix or metric is a new file.

A configuration's file may hold `program_env`, settings of the
program's environment that choose its path (run.py applies them before
NumPy is imported; see program_env).

Set-up, in the order a user of `align` pays for it: the genome and the
read pool from --seed (port_bench/generate.py); the index, built as
`align` builds one from a FASTA (build_index_native); the mapper
(Mapper.from_oracle_index with the preset's ChainParams and the default
MapParams, batch size and buckets); then warm-up: every call of the pool
the mix's warmup_passes times (a program key runs eagerly on its first
batch and is captured on its second, so two passes leave every key the
window uses captured).

The window: calls of Mapper.map_reads_paf, one call per pool entry
(cycled), back to back, until --seconds have passed; the call in flight
finishes. read_bp_per_s is every base of every call over the window. A
window in which a stage ran eagerly or a program was captured gives no
result.

Then the judge: after the window, with the mapper freed, a sample drawn
from the seed of the reads the window mapped (uniform, the longest, and
some that the mapper left unmapped or covered too little) goes through
the plain reference (port_bench/reference), whose index is worked out
again from the genome; a read's PAF lines must equal the
reference's under the reference's pruned chain DP or under the exact
window the mapper's device DP scores by default (reference/chain.py).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import generate
from . import trace as tracing
from .reference import chain as rchain
from .reference import index as rindex
from .reference import pipeline as rpipe
from .reference import sketch as rsketch

FORBIDDEN = ("jax", "jaxlib", "flax", "minimap2_rs_tpu")


class RunError(Exception):
    """A run that must print no result; its exit code and message."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def load_cell(root: Path, name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration file, its mix file)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise RunError(2, f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "port_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, mix


def metric_reader(root: Path, name: str):
    """port_bench/metrics/<name>.py's read(record) -> number or None."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card(device: torch.device) -> str:
    """The card's name and power limit, for the log."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def _numpy_avx512f():
    """Whether NumPy dispatches its AVX-512 kernels (False where the CPU
    lacks AVX-512 or NPY_DISABLE_CPU_FEATURES names AVX512F)."""
    try:
        from numpy._core._multiarray_umath import __cpu_features__
    except ImportError:
        from numpy.core._multiarray_umath import __cpu_features__
    return __cpu_features__.get("AVX512F")


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if isinstance(v, (int, float))}


def _lines_by_read(blob: bytes) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for line in blob.decode().split("\n"):
        if line:
            out.setdefault(line.split("\t", 1)[0], []).append(line)
    return out


def choose_sample(judged: list[tuple[list, bytes]], mix: dict,
                  seed: int) -> tuple[list[tuple[int, int]], dict[str, int]]:
    """(call, read) pairs to judge among `judged`, each distinct pool call
    of the window with its first output, and how many of each kind:
    check_reads["uniform"] drawn from the seed, the longest read, and up
    to check_reads["per_path"] of those that the mapper left unmapped and
    of those whose first PAF line covers too little of the read for the
    reference's rescue test (more than 1,000 bases or 10% uncovered,
    lchain.rs:321-326), where the wide band decides the answer."""
    rng = np.random.default_rng(generate.sub_seed(seed, "check"))
    spec = mix["check_reads"]
    per = len(judged[0][0])
    if any(len(reads) != per for reads, _out in judged):
        raise ValueError("the calls differ in size")
    total = len(judged) * per
    take = set(rng.choice(total, size=min(int(spec["uniform"]), total), replace=False).tolist())
    where = {name: ci * per + r for ci, (reads, _o) in enumerate(judged)
             for r, (name, _s) in enumerate(reads)}
    longest = max(where, key=lambda n: len(judged[where[n] // per][0][where[n] % per][1]))
    take.add(where[longest])
    kinds = {"unmapped": set(where), "low_cover": set()}
    for _reads, out in judged:
        for name, lines in _lines_by_read(out).items():
            kinds["unmapped"].discard(name)
            f = lines[0].split("\t", 4)
            qlen, cov = int(f[1]), int(f[3]) - int(f[2])
            if qlen - cov > 1000 or cov < 0.9 * qlen:
                kinds["low_cover"].add(name)
    counts = {"uniform": len(take)}
    for kind in sorted(kinds):
        names = sorted(kinds[kind])
        picked = [where[names[n]] for n in rng.permutation(len(names))[: int(spec["per_path"])]]
        counts[kind] = len(picked)
        take.update(picked)
    return [divmod(i, per) for i in sorted(take)], counts


def _reads_differing(a: bytes, b: bytes) -> int:
    """Reads whose PAF lines differ between two outputs of one call."""
    la, lb = _lines_by_read(a), _lines_by_read(b)
    return sum(la.get(n) != lb.get(n) for n in set(la) | set(lb))


def reference_index(reads: list[tuple[str, bytes]], recs, config: dict, device):
    """The reference's index of the genome `recs`, keeping the
    occurrences of the keys of `reads`."""
    w, k = int(config["w"]), int(config["k"])
    mp = rpipe.MapParams()
    want = np.array([m[0] >> 8 for _n, s in reads for m in rsketch.query_minimizers(s, w, k)],
                    dtype=np.uint64)

    def fetch(rid, lo, hi):
        codes = rsketch.nt4(recs[rid][1][lo:hi])
        return torch.from_numpy(codes).to(device).long()

    return rindex.build_index([n for n, _s in recs], [len(s) for _n, s in recs], fetch, w, k,
                              want, mp.frac_top_repetitive, mp.mid_occ_floor, device)


def judge(idx, reads: list[tuple[str, bytes]], got: list[list[str]], err) -> dict:
    """Count the reads whose PAF lines `got` differ from the reference's
    under both chain DPs (reference/chain.py), with the first examples on
    `err`."""
    cp, mp = rchain.ChainParams(k=idx.k), rpipe.MapParams()
    bad, exact_only, examples = 0, 0, []
    for (name, seq), lines in zip(reads, got):
        if lines == rpipe.map_read(idx, name, seq, cp, mp, mode="prune"):
            continue
        ref = rpipe.map_read(idx, name, seq, cp, mp, mode="exact")
        if lines == ref:
            exact_only += 1
            continue
        bad += 1
        if len(examples) < 3:
            examples.append((name, lines, ref))
    for name, lines, ref in examples:
        print(f"mismatch {name}: judged {lines!r}", file=err)
        print(f"mismatch {name}: reference {ref!r}", file=err)
    return {"mismatched": bad, "judged": len(reads), "exact_window_only": exact_only}


def run(argv, *, root: Path, t_start: float, device: str = "cuda", mapper_wrap=None,
        out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line last on `out` and returns 0, or
    raises RunError. device="cpu" and mapper_wrap (mapper -> object
    with map_reads_paf) serve the CPU tests."""
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, mix = load_cell(root, args.workload)
    with program_env(config):
        return _run_cell(args, bench, cell, config, mix, root=root, t_start=t_start,
                         device=device, mapper_wrap=mapper_wrap, out=out, err=err)


@contextlib.contextmanager
def program_env(config: dict):
    """The configuration's `program_env`, settings of the program's
    environment that choose its path, set for the run and restored after
    it (run.py sets them before NumPy is imported as well)."""
    env = {k: str(v) for k, v in config.get("program_env", {}).items()}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_cell(args, bench, cell, config, mix, *, root: Path, t_start: float, device: str,
              mapper_wrap, out, err) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(2, f"the cell needs {cell['chips']} CUDA device(s); "
                              f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        dev = torch.device("cuda", 0)
        print(f"card: {_card(dev)}", file=err)
    print(f"program env {json.dumps(config.get('program_env', {}))}; numpy {np.__version__}, "
          f"AVX512F dispatched {_numpy_avx512f()}", file=err)

    from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_torch.models.index_builder import build_index_native
    from minimap2_rs_torch.models.mapper import Mapper

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    w, k = int(config["w"]), int(config["k"])
    t = time.perf_counter()
    recs, codes = generate.genome([tuple(s) for s in config["sequences"]], args.seed, dev)
    n_calls = min(int(mix["pool_calls"]), int(config.get("pool_calls_max", 1 << 30)))
    pool = generate.read_pool(codes, mix, args.seed, n_calls, dev)
    del codes
    sync()
    setup = {"inputs_s": time.perf_counter() - t}
    t = time.perf_counter()
    idx = build_index_native(recs, IndexParams(w=w, k=k))
    setup["index_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mapper = Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(k), MapParams(),
                                      device=dev)
    sync()
    setup["index_upload_s"] = time.perf_counter() - t
    entry = mapper_wrap(mapper) if mapper_wrap else mapper
    t = time.perf_counter()
    warm = int(mix["warmup_passes"]) * len(pool)
    for i in range(warm):
        entry.map_reads_paf(pool[i % len(pool)])
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    setup["warmup_calls"] = warm

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    span = (lambda name: torch.profiler.record_function(name)) if prof else \
        (lambda name: contextlib.nullcontext())
    before = dict(mapper.stats)
    # each pool call's first output in the window; a later call of the
    # same reads has to give the same bytes (checked at once, so that
    # the window holds no more than the pool's outputs)
    first_out: dict[int, bytes] = {}
    differing: list[tuple[int, bytes]] = []
    order: list[int] = []
    call_s: list[float] = []
    call_cpu = [os.times()[:2]]
    gc_s = {g: [0, 0.0] for g in range(3)}
    gc_t0 = [0.0]

    def gc_watch(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[info["generation"]][0] += 1
            gc_s[info["generation"]][1] += time.perf_counter() - gc_t0[0]
    gc.callbacks.append(gc_watch)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    with span(tracing.WINDOW):
        while True:
            pi = (warm + len(order)) % len(pool)
            with span(f"{tracing.CALL}{len(order)}"):
                got = entry.map_reads_paf(pool[pi])
            kept = first_out.setdefault(pi, got)
            if kept is not got and kept != got:
                differing.append((pi, got))
            order.append(pi)
            t_w1 = time.perf_counter()
            call_s.append(t_w1 - (t_w0 + sum(call_s)))
            call_cpu.append(os.times()[:2])
            if t_w1 - t_w0 >= args.seconds:
                break
    gc.callbacks.remove(gc_watch)
    window_s = t_w1 - t_w0
    summary = None
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        t = time.perf_counter()
        summary = tracing.summarize(prof.profiler.kineto_results.events())
        print(f"trace read in {time.perf_counter() - t:.1f} s", file=err)
        del prof
    stats = _delta(mapper.stats, before)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    n_reads = sum(len(pool[pi]) for pi in order)
    pool_bp = {pi: sum(len(x) for _n, x in pool[pi]) for pi in first_out}
    bases = sum(pool_bp[pi] for pi in order)
    print(f"set-up {json.dumps({k2: round(v, 3) for k2, v in setup.items()})}; "
          f"window {window_s:.3f} s, {len(order)} calls, {n_reads} reads, {bases} bases; "
          f"captures in the window {stats.get('graph_captures', 0)}, eager stages "
          f"{stats.get('eager_stages', 0)}; peak device memory {peak} B; "
          f"mapper mid_occ {mapper.mid_occ}", file=err)
    print("calls (s, process user s, system s, Mbp): " + str([
        (round(d, 3), round(b[0] - a[0], 3), round(b[1] - a[1], 3), round(pool_bp[pi] / 1e6, 3))
        for d, a, b, pi in zip(call_s, call_cpu, call_cpu[1:], order)]), file=err)
    print(f"garbage collections in the window (count, s) by generation: {gc_s}; "
          f"objects the collector tracks {len(gc.get_objects())}", file=err)
    print(f"window stats {json.dumps({k2: round(v, 4) for k2, v in sorted(stats.items())})}",
          file=err)
    if mapper.programs is not None and (stats.get("graph_captures", 0)
                                        or stats.get("eager_stages", 0)):
        raise RunError(4, "the window captured programs or ran stages eagerly: warm-up "
                          "left a program key of the cell's calls uncaptured")

    mapper_mid_occ = mapper.mid_occ
    judged = [(pool[pi], out) for pi, out in first_out.items()]
    repeat_bad = sum(_reads_differing(first_out[pi], got) for pi, got in differing)
    del mapper, entry, idx, pool, first_out, differing
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample, kinds = choose_sample(judged, mix, args.seed)
    reads = [judged[c][0][r] for c, r in sample]
    t = time.perf_counter()
    idx_ref = reference_index(reads, recs, config, dev)
    t_idx = time.perf_counter() - t
    by_call = {c: _lines_by_read(judged[c][1]) for c in {c for c, _r in sample}}
    verdict = judge(idx_ref, reads, [by_call[c].get(name, []) for (c, _r), (name, _s)
                                     in zip(sample, reads)], err)
    print(f"judged {verdict['judged']} reads ({json.dumps(kinds)} by how chosen), "
          f"{verdict['exact_window_only']} equal under the exact window only; reference "
          f"mid_occ {idx_ref.mid_occ} (mapper {mapper_mid_occ}); reference index "
          f"{t_idx:.1f} s, reads {time.perf_counter() - t - t_idx:.1f} s; "
          f"{repeat_bad} reads of repeated calls differ from their call's first output",
          file=err)

    record = {"cell": cell["name"], "reads": n_reads, "bases": bases, "calls": len(order),
              "window_s": window_s, "setup_s": setup_s, "setup": setup, "stats": stats,
              "trace": summary}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        v = metric_reader(root, m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {"mismatched_reads": {"value": verdict["mismatched"] + repeat_bad, "limit": 0}}
    correct = verdict["judged"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": n_reads, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        top = sorted(summary["op_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in top],
                               "idle_gaps": [list(g) for g in summary["gaps"]]}
    result["checks"] = checks
    loaded = sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RunError(3, f"modules loaded in the run: {', '.join(loaded)}")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
