"""Ranks as spawned processes, and the work each rank of a run does.

`spawn(task, world_size, *args, store_dir=..., device=..., task_kw=...)`
starts world_size processes with the spawn start method; rank r joins
the group through a FileStore in store_dir, pins torch to one thread (or
`threads`), runs task(rank, world_size, *args, device=...,
share_device=..., **task_kw) and sends back what it returns (numpy
arrays, bytes and plain Python values: never tensors). The device is
explicit: "cpu" for gloo ranks on the host, "cuda" for one card a rank
(NCCL; rank r takes cuda:r), or a card with share_device=True for gloo
ranks that share it. The parent fails as soon as a rank fails or dies,
and after timeout_s; it stops every process it started.

The tasks live here, in the port, so that a spawned rank imports torch
and the port only:
  * `step_checks`: the dp and sharded chain-score steps, the collective
    index statistics and the occurrence quantile;
  * `mesh_map`: MeshMapper runs over read sets, with timed passes,
    kernel launch counts, the chain kernels' captured inputs held to
    their plain versions and timed replays of the held programs.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT_S, init_process_group, make_mesh, rank_device


def _rank_main(rank, world_size, store_path, device, share_device, timeout_s, threads,
               task, args, task_kw, results):
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda" and not share_device:
        # one card a rank: rank_device takes cuda:LOCAL_RANK, and every
        # rank of a spawn runs on this host
        os.environ["LOCAL_RANK"] = str(rank)
    try:
        dev = rank_device(device, share_device)
        init_process_group(dev, share_device=share_device,
                           store=dist.FileStore(store_path, world_size), rank=rank,
                           world_size=world_size, timeout_s=timeout_s)
        out = task(rank, world_size, *args, device=device, share_device=share_device,
                   **task_kw)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(task, world_size: int, *args, store_dir, device: str | torch.device,
          share_device: bool = False, timeout_s: float = DEFAULT_TIMEOUT_S,
          task_kw: dict | None = None, threads: int | None = 1) -> list:
    """task(rank, world_size, *args, device=device, share_device=share_device,
    **task_kw) on world_size spawned ranks; returns
    their results in rank order. Raises when a rank raises or exits
    without a result, or when the run outlasts timeout_s. Each rank runs
    torch on `threads` threads (None: torch's default)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(str(store_dir), f"store.{os.getpid()}.{time.monotonic_ns()}")
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, world_size, store_path, device, share_device, timeout_s,
                          threads, task, args, task_kw or {}, results))
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"gave no result within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with (rank, code) {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world_size)]


def _rows(t, rank: int, n: int):
    """Rows [rank * B / n, (rank + 1) * B / n) of a batch array."""
    b = t.shape[0] // n
    return t[rank * b:(rank + 1) * b]


def step_checks(rank: int, world_size: int, idx, codes: np.ndarray, lengths: np.ndarray,
                cp, statics: dict, ix: int, fracs=(2e-4,), stats_idx=None, *,
                device: str | torch.device, share_device: bool = False) -> dict:
    """This rank's part of the chain-score steps on a (B, L) int32 nt4
    batch, on `device`: the dp step over a (world, 1) mesh and the
    sharded step over a (world // ix, ix) mesh, each on its own rows (the
    anchor words, n_anchors, anc_ovf, f, prev); then over the sharded
    mesh the index statistics and the occurrence quantile at each of
    `fracs`, of stats_idx (default: idx) sharded ix ways."""
    from ..ops.chain_ops import chain_scalars_from_params, log2_table
    from ..ops.index_ops import DeviceIndex
    from .pipeline import (
        calc_mid_occ_allreduce,
        index_stats_allreduce,
        map_batch_dp,
        map_batch_sharded,
    )
    from .sharded_index import ShardedDeviceIndex

    mesh = make_mesh(dp=world_size, ix=1, device=device, share_device=share_device)
    dev = mesh.device
    scalars = chain_scalars_from_params(cp)
    tab = log2_table(cp.bw + 1).to(dev)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    codes_t = _rows(torch.from_numpy(codes), rank, world_size).to(dev)
    lengths_t = _rows(torch.from_numpy(lengths), rank, world_size).to(dev)
    keep = ("x_hi", "x_lo", "y_hi", "y_lo", "f", "prev", "n_anchors", "anc_ovf")
    out = {}

    dev_idx = DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                    key_bits=2 * idx.k, device=dev)
    step = map_batch_dp(dev_idx, codes_t, lengths_t, scalars, mid_occ, statics, tab)
    out["dp"] = {kk: step[kk].cpu().numpy() for kk in keep}

    mesh = make_mesh(dp=world_size // ix, ix=ix, device=device, share_device=share_device)
    sidx = ShardedDeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                        n_shards=ix, key_bits=2 * idx.k,
                                        rank=mesh.ix_rank, device=dev)
    step = map_batch_sharded(mesh, sidx, codes_t, lengths_t, scalars, mid_occ,
                             {**statics, "window": min(statics["window"], ix * statics["A"])},
                             tab)
    out["sharded"] = {kk: step[kk].cpu().numpy() for kk in keep}
    out["dm_entry"] = sidx.dm_entry
    if stats_idx is not None:
        sidx = ShardedDeviceIndex.from_host(
            stats_idx.keys, stats_idx.starts, stats_idx.counts, stats_idx.positions,
            n_shards=ix, key_bits=2 * stats_idx.k, rank=mesh.ix_rank, device=dev)
    out["stats"] = index_stats_allreduce(mesh, sidx)
    out["mid_occ"] = {frac: calc_mid_occ_allreduce(mesh, sidx, frac) for frac in fracs}
    out["collectives"] = mesh.stats
    return out


def _hold_to_plain(captured: dict, log2_tab) -> list:
    """Each captured chain-kernel input (kernels/chain_dp.captured) run
    through the kernel and its plain version: they must be torch.equal.
    Returns (key, bw, A, (args as numpy), scalars, window, skip,
    max_abs_err) per entry."""
    from ..kernels import chain_dp as kchain
    from ..ops import chain_ops

    rows = []
    for (key, bw, A), (args, scal, window, skip) in sorted(captured.items(),
                                                           key=lambda kv: kv[0]):
        aux = key.startswith("chain_dp_aux")
        fn = kchain.chain_dp_aux_batch if aux else kchain.chain_dp_batch
        ref = chain_ops.chain_dp_aux_batch_ref if aux else chain_ops.chain_dp_batch_ref
        tab = log2_tab.to(args[0].device)
        got = fn(*args, scal, window, tab, skip)
        want = ref(*args, scal, window, tab, max_chain_skip=skip)
        err = 0
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(f"{key} (bw={bw}, A={A}): kernel != plain at {bad}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        rows.append((key, bw, A, tuple(a.cpu().numpy() for a in args), scal, window,
                     skip, err))
    return rows


def _portable(key: tuple) -> tuple:
    """A program key (models/programs.program_key) without the object
    identities it holds, which differ from rank to rank."""
    fn, shapes, statics = key
    return fn, shapes, tuple((name, "id" if isinstance(v, tuple) and v[:1] == ("id",) else v)
                             for name, v in statics)


def _replay_programs(mm, rounds: int) -> list:
    """Seconds of each of `rounds` rounds that replay every program the
    mapper holds once (the JAX scaling_bench's program-only time), ended
    by a synchronize on the card. Every rank replays the same keys in the
    same order: each graph of an NCCL mesh holds collectives that pair
    with the other ranks', so the key lists are held equal first."""
    if mm.programs is None:
        raise ValueError("the mapper holds no programs (an eager mapper)")
    progs = mm.programs.programs
    by_name = {repr(_portable(k)): p for k, p in progs.items()}
    names = sorted(by_name)
    if len(by_name) != len(progs) or not progs:
        raise AssertionError(f"{len(progs)} held programs, {len(by_name)} distinct keys")
    world = [None] * dist.get_world_size()
    dist.all_gather_object(world, names)
    if any(w != names for w in world):
        raise AssertionError(f"the ranks hold different programs: {world}")
    cuda = mm.device.type == "cuda"
    times = []
    for _ in range(rounds):
        if cuda:
            torch.cuda.synchronize(mm.device)
        t0 = time.perf_counter()
        for name in names:
            by_name[name].replay()
        if cuda:
            torch.cuda.synchronize(mm.device)
        times.append(time.perf_counter() - t0)
    return times


def mesh_map(rank: int, world_size: int, runs: list, *, device: str | torch.device,
             share_device: bool = False, passes: int = 0, hold_kernels: bool = False,
             fracs=(), dm_entry: int | None = None) -> dict:
    """MeshMapper runs on this rank, on `device`. Each run is a dict: name, idx (an
    OracleIndex), cp, mp, reads, dp, ix, sharded, kw (Mapper fields) and,
    optionally, passes (in place of `passes`), graph (the mapper's
    programs become ProgramCache(device, graph=graph): on the CPU,
    models/programs.ReplayStandIn runs the capture plumbing), warm (the
    untimed passes, default 1; a key captures on its second batch) and
    program_only (the rounds of timed replays of every held program,
    _replay_programs). Its result
    holds the PAF blob of a first pass (each further warm pass must give
    the same bytes), then, with passes > 0, the times
    of `passes` more passes, their kernel launch counts (set to
    0 just before them, read just after), each pass's stats and the last
    pass's apart; the
    collective stats of those passes (of the first without them); the
    collective payload of a sharded call by shape (payload_per_call); the
    seconds of each round of program-only replays; the
    mapper's dm_entry (this rank's shard's when sharded); with
    hold_kernels, the chain kernels' inputs captured in the first pass,
    each held to its plain version (_hold_to_plain); and, sharded, the
    index statistics and the occurrence quantile at each of `fracs` by
    collectives. With dm_entry, a sharded run's shard must have that
    direct-table entry."""
    from ..kernels import chain_dp as kchain
    from ..kernels import sketch as ksketch
    from ..kernels import window_scan as kscan
    from ..models.mesh_mapper import make_mesh_mapper
    from ..models.programs import ProgramCache
    from .pipeline import calc_mid_occ_allreduce, index_stats_allreduce

    out = {}
    for run in runs:
        mm = make_mesh_mapper(run["idx"], run["cp"], run["mp"], dp=run["dp"], ix=run["ix"],
                              index_sharded=run["sharded"], device=device,
                              share_device=share_device, **run.get("kw", {}))
        if run.get("graph") is not None:
            mm.programs = ProgramCache(mm.device, graph=run["graph"])
        rl = run["reads"]
        n_passes = run.get("passes", passes)
        res = {"dm_entry": mm.sidx.dm_entry if run["sharded"]
               else mm.dev_idx.dm_entry}
        if run["sharded"] and dm_entry is not None and res["dm_entry"] != dm_entry:
            raise AssertionError(f"rank {rank}: its shard has dm_entry {res['dm_entry']}, "
                                 f"not {dm_entry}")
        kchain.captured = {} if hold_kernels else None
        try:
            res["blob"] = mm.map_reads_paf(rl)
            captured = kchain.captured
        finally:
            kchain.captured = None
        res["first_stats"] = dict(mm.stats)
        for _ in range(run.get("warm", 1) - 1):
            if mm.map_reads_paf(rl) != res["blob"]:
                raise AssertionError("a warm pass gave other bytes than the first")
        if n_passes:
            times, pass_stats = [], []
            mm.mesh.stats.clear()
            for mod in (kchain, kscan, ksketch):
                mod.reset_launches()
            for _ in range(n_passes):
                mm.stats = {}
                t0 = time.perf_counter()
                blob = mm.map_reads_paf(rl)
                if mm.device.type == "cuda":
                    torch.cuda.synchronize(mm.device)
                times.append(time.perf_counter() - t0)
                pass_stats.append(dict(mm.stats))
            res["launches"] = {kk: v for mod in (kchain, kscan, ksketch)
                               for kk, v in mod.launches.items() if v}
            res["times"] = times
            res["pass_stats"] = pass_stats
            res["stats"] = pass_stats[-1]
            if blob != res["blob"]:
                raise AssertionError("a timed pass gave other bytes than the first")
        res["collectives"] = {kk: dict(v) for kk, v in mm.mesh.stats.items()}
        res["payload_per_call"] = dict(mm.payload_per_call)
        if run.get("program_only"):
            res["program_only"] = _replay_programs(mm, run["program_only"])
        if hold_kernels:
            res["kernels"] = _hold_to_plain(captured, mm._log2_tab)
        if run["sharded"]:
            sidx = mm.sidx
            res["stats_allreduce"] = index_stats_allreduce(mm.mesh, sidx)
            res["mid_occ"] = {f: calc_mid_occ_allreduce(mm.mesh, sidx, f) for f in fracs}
        out[run["name"]] = res
    return out
