"""Captured device programs: each device stage, once per shape, as a
CUDA graph that later batches replay.

The port's counterpart of the JAX mapper's executable per shape
(minimap2_rs_tpu/models/mapper.py:396-435: _device_stage_lite compiles
_fused_map_stage_lite once per key, :415-418, and keeps it in
_lite_exec; MeshMapper keeps its mesh steps in _mesh_exec). A CUDA
Mapper issues each device stage through a ProgramCache (Mapper.graphs;
models/mapper.py), and so does a MeshMapper on an NCCL mesh, whose
captured steps hold their collectives (models/mesh_mapper.py):

  * The first batch of a key runs the stage eagerly (run_eager): a key
    that never comes back, such as the single rescue call of a one-shot
    run, costs no capture and holds no memory. Its kernel launches
    count, and the kernel wrappers may keep their inputs.
  * The second batch of the key allocates the stage's static input
    buffers on the device (zeros) and captures the stage into a CUDA
    graph that reads them, keeping the graph's static output. Nothing
    runs during the capture; the batch then takes the replay path below.
  * Each batch from the second on copies its pinned host arrays into
    the static inputs, replays the graph, and starts the copy of the
    static output into a fresh pinned host buffer.

At most `max_programs` programs live at once; the least recently used
one goes first. A key once evicted is captured again when it comes back.

The key (program_key) holds every static of the stage: the function,
the shape and dtype of each batch input, and every keyword argument.
The band's scalars, mid_occ and the window are baked into the captured
launches, so they belong to it. Tensors and other unhashable objects
(the device index, the log2 table) enter by identity; a live program
keeps them alive, so its key's identities are not reused.

Ordering. All of a cache's copies, eager stages and replays run on one
stream, the one current on its device when the cache was made, in the
order the host issues them under the cache's lock. The copy-in of batch
i+1 and the replay that overwrites the static output of batch i are
therefore both queued after batch i's copy-out. Every capture runs on
one side stream of the cache, in one memory pool: a capture may reuse
the memory another program's capture freed (its temporaries, or the
static output of an evicted program), which is safe because replays
never overlap and every replay's copy-out is queued right after it.

Nothing in a captured stage may synchronise with the host or copy from
host memory: a capture that does raises, and so does a failed replay.
A CUDA mapper never falls back to running eagerly. A collective captured
with its stage is replayed with it: NCCL queues its kernels into the
capture (every communicator was made before, Mesh.start_communicators),
and Mesh.stats counts it on each replay (kernels/counts.py). A gloo
collective stages through host memory and cannot be captured.

Where there is no card, ReplayStandIn takes the graph's place and runs
the same plumbing (the CPU tests and their spawned ranks).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch

from ..kernels import counts

# the counters of Mapper.stats that show which path issued a stage
COUNTERS = ("device_stages", "eager_stages", "graph_captures", "graph_replays", "capture")


def program_key(fn, inputs, statics: dict) -> tuple:
    """The key of `fn` on batch inputs `inputs` (tensors) with keyword
    arguments `statics`: the function, each input's shape and dtype, and
    each static by value when hashable (numbers, strings, None, frozen
    dataclasses such as ChainScalars), else by identity (tensors, the
    device index)."""

    def static(v):
        if isinstance(v, torch.Tensor):
            return ("id", id(v))
        try:
            hash(v)
        except TypeError:
            return ("id", id(v))
        return v

    return (
        f"{fn.__module__}.{fn.__qualname__}",
        tuple((tuple(a.shape), a.dtype) for a in inputs),
        tuple(sorted((name, static(v)) for name, v in statics.items())),
    )


def fetch(out: torch.Tensor):
    """Start the copy of a stage's output on the card into a fresh pinned
    host buffer: (the buffer, the CUDA event recorded after the copy).
    On the CPU: (out, None)."""
    if not out.is_cuda:
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def run_eager(fn, inputs: tuple, stats: dict, device, /, **statics):
    """fn(*inputs on `device`, **statics) issued eagerly, for host tensors
    `inputs`; returns fetch() of its output. Adds eager_stages and the
    host seconds upload, stage_issue and d2h_issue to `stats`."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        inputs = tuple(a.pin_memory().to(device, non_blocking=True) for a in inputs)
    t1 = time.perf_counter()
    out = fn(*inputs, **statics)
    t2 = time.perf_counter()
    result = fetch(out)
    _issue_times(stats, t0, t1, t2)
    _add(stats, "eager_stages", 1)
    return result


class CudaGraph:
    """A program's graph on the card: torch.cuda.CUDAGraph, captured on
    the cache's side stream `stream` in its memory pool `pool`. Capture
    mode "thread_local": the drain thread may wait on events and read
    host buffers while the producer thread captures."""

    def __init__(self, pool, stream):
        self._graph = torch.cuda.CUDAGraph()
        self._pool, self._stream = pool, stream

    def capture(self, fn) -> torch.Tensor:
        """Record fn() into the graph (nothing runs); returns its static
        output."""
        with torch.cuda.stream(self._stream):
            self._graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self._graph.capture_end()
                raise
            self._graph.capture_end()
        return out

    def replay(self) -> None:
        self._graph.replay()


class ReplayStandIn:
    """CudaGraph's stand-in where there is no card: capture records the
    stage and returns its output as the static output; replay re-runs the
    stage on the static input buffers and writes the result into that
    same output, as a graph replay does. What the stage counts (kernel
    launches, collectives) goes to a recording it drops: a graph replay
    runs no Python, and the cache adds the capture's record instead."""

    def __init__(self, pool, stream):
        self.fn = self.out = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        with counts.recording():
            self.out.copy_(self.fn())


@dataclasses.dataclass
class _Program:
    inputs: tuple          # the static input buffers on the device
    graph: object
    out: torch.Tensor      # the graph's static output
    launches: list         # the launches (and collectives) recorded in the capture
    statics: dict          # holds the identity statics alive


class ProgramCache:
    """Captured programs of one device, by program_key, at most
    `max_programs` live. `graph(pool, stream)` makes a program's graph:
    CudaGraph on the card; elsewhere a stand-in with the same
    capture/replay methods (ReplayStandIn re-runs the stage)."""

    def __init__(self, device, graph=CudaGraph, max_programs: int = 32):
        self.device = torch.device(device)
        self._graph = graph
        self.max_programs = max_programs
        cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._stream = torch.cuda.current_stream(self.device) if cuda else None
        self._capture_stream = torch.cuda.Stream(self.device) if cuda else None
        self._lock = threading.Lock()
        self.programs: collections.OrderedDict = collections.OrderedDict()
        # keys run once and not captured (cleared past 1024: a forgotten
        # key runs eagerly once more)
        self._seen: set = set()
        # seconds each capture took, and the bytes the card's reserved
        # memory grew by while capturing (the shared pool's growth)
        self.capture_s: list = []
        self.pool_bytes = 0

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def run(self, fn, inputs: tuple, stats: dict, /, **statics):
        """fn(*inputs on the device, **statics) for host tensors `inputs`:
        eagerly the first time its key is seen, else through the key's
        program, captured now if it is not live. Returns fetch() of its
        output (on the CPU a copy of a replay's static output). Adds
        eager_stages or graph_replays, graph_captures, capture (s) and the
        host seconds upload, stage_issue and d2h_issue to `stats`."""
        key = program_key(fn, inputs, statics)
        with self._lock, self._on_stream():
            prog = self.programs.get(key)
            if prog is None and key not in self._seen:
                if len(self._seen) >= 1024:
                    self._seen.clear()
                self._seen.add(key)
                return run_eager(fn, inputs, stats, self.device, **statics)
            if prog is None:
                prog = self._capture(key, fn, inputs, statics, stats)
            else:
                self.programs.move_to_end(key)
            t0 = time.perf_counter()
            for dst, src in zip(prog.inputs, inputs):
                dst.copy_(src.pin_memory() if self._stream is not None else src,
                          non_blocking=True)
            t1 = time.perf_counter()
            prog.graph.replay()
            counts.replay(prog.launches)
            t2 = time.perf_counter()
            host, ready = fetch(prog.out)
            if ready is None:
                host = host.clone()  # the next replay overwrites the static output
            _issue_times(stats, t0, t1, t2)
            _add(stats, "graph_replays", 1)
            return host, ready

    def _capture(self, key, fn, inputs, statics, stats) -> _Program:
        """Capture fn on static input buffers shaped like `inputs` into a
        new live program (evicting the least recently used beyond
        max_programs)."""
        t0 = time.perf_counter()
        reserved = self._reserved()
        # zeros (a batch of empty reads) until the replay's copy-in: a
        # capture runs nothing, but the CPU tests' stand-in runs the stage
        static_in = tuple(torch.zeros(a.shape, dtype=a.dtype, device=self.device)
                          for a in inputs)
        graph = self._graph(self._pool, self._capture_stream)
        with counts.recording() as recorded:
            out = graph.capture(lambda: fn(*static_in, **statics))
        self.pool_bytes += self._reserved() - reserved
        prog = self.programs[key] = _Program(static_in, graph, out, recorded, statics)
        while len(self.programs) > self.max_programs:
            self.programs.popitem(last=False)
        dt = time.perf_counter() - t0
        self.capture_s.append(dt)
        _add(stats, "graph_captures", 1)
        _add(stats, "capture", dt)
        return prog

    def _reserved(self) -> int:
        return torch.cuda.memory_reserved(self.device) if self._stream is not None else 0


def _issue_times(stats: dict, t0: float, t1: float, t2: float) -> None:
    """The host seconds of one stage: upload (t0-t1), stage_issue (the
    stage or its replay, t1-t2) and d2h_issue (starting the copy back,
    t2-now)."""
    _add(stats, "upload", t1 - t0)
    _add(stats, "stage_issue", t2 - t1)
    _add(stats, "d2h_issue", time.perf_counter() - t2)


def _add(stats: dict, key: str, v) -> None:
    stats[key] = stats.get(key, 0) + v
