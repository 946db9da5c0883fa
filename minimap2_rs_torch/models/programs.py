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

A program may be a sequence of named stages (staged(): the lite and
general map programs run "sketch", "anchors" and "chain", and on the
prefix-probe layout "sketch", "probe", "anchors" and "chain"); any other
function is one stage, named by named() ("rechain", "mesh_step") or
"stage". The cache keeps one program per key holding one graph per
stage, captured in order on the same side stream into the same pool and
replayed in order; the first stage takes the batch inputs and each later
one the tensors its predecessor returned. The program keeps its static
inputs and its last stage's output; an intermediate output is an address
in the pool that one graph writes and the next reads, freed once the
next stage is captured, so other captures may reuse it as they reuse
temporaries (below). The per-batch counts (eager_stages, graph_captures,
graph_replays) count programs, not stages.

Stamps. On the cache's stream every batch records timing stamps: before
its copy-in, after it, after each stage and after its copy-out (the
last one is the event the caller waits on). On the card they are CUDA
timing events from the cache's Clock, a free list that Stamps.read
refills; on the CPU, the host clock. The mapper's drain reads them
after the wait into device seconds per stage (Mapper.stats dev_h2d,
dev_<stage>, dev_d2h) and its call's idle split (idle_split). Events
inside a graph would not do: every replay reuses a graph's nodes, and
the submit thread runs batches ahead of the drain, so the next replay
would overwrite a batch's stamps before they are read.

At most `max_programs` programs live at once; the least recently used
one goes first (graph_evictions). A key once evicted is captured again
when it comes back (graph_recaptures: a kernel built again).

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
static output of an evicted program, or a stage's intermediate
output), which is safe because replays never overlap, a program's stages
replay back to back, and every replay's copy-out is queued right after
its last stage.

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
import functools
import inspect
import threading
import time

import torch

from ..kernels import counts
from ..utils.profiling import span

# the counters of Mapper.stats that show which path issued a stage
COUNTERS = ("device_stages", "eager_stages", "graph_captures", "graph_replays", "capture")


def staged(*stages):
    """Make a program of (name, stage function) pairs from a function that
    only declares its signature (batch inputs positional, statics
    keyword-only, with their defaults) and documents it: calling the
    program runs the stages in order (run_stages) on the bound arguments,
    as run_eager and the cache do through its `stages`. The first stage
    is called as stage(*inputs, **statics), each later one as
    stage(state, **statics) on the tensor or dict of tensors its
    predecessor returned; the last returns the program's output."""
    def make(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def program(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return run_stages(stages, bound.args, bound.kwargs)

        program.stages = stages
        return program
    return make


def named(name: str):
    """Name a one-stage program function (its stamps' and stats' name)."""
    def mark(fn):
        fn.stage_name = name
        return fn
    return mark


def program_stages(fn) -> tuple:
    """fn's (name, stage function) pairs: its staged() stages, else fn
    itself as one stage."""
    return getattr(fn, "stages", None) or ((getattr(fn, "stage_name", "stage"), fn),)


def _call_stage(i: int, stage, state, statics: dict):
    return stage(*state, **statics) if i == 0 else stage(state, **statics)


def run_stages(stages: tuple, inputs: tuple, statics: dict, after=None):
    """(name, stage function) pairs in order on the batch `inputs`,
    calling after() past each; returns the last stage's output."""
    state = inputs
    for i, (_name, stage) in enumerate(stages):
        state = _call_stage(i, stage, state, statics)
        if after is not None:
            after()
    return state


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


class Clock:
    """Marks on one device's clock: on the card a CUDA timing event
    recorded on `stream` (the current stream when None), taken from a
    free list that release() refills; on the CPU the host clock's
    seconds."""

    def __init__(self, device, stream=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = stream
        self._free: list = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        try:
            ev = self._free.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream or torch.cuda.current_stream(self.device))
        return ev

    def seconds(self, a, b) -> float:
        """Seconds from mark a to mark b (both complete on the card)."""
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def release(self, marks) -> None:
        """Give read marks back (the free list holds at most the events
        that were in flight at once)."""
        if self.cuda:
            self._free.extend(marks)


class Stamps:
    """One batch's marks on its clock, in issue order: before the
    copy-in, after it, after each stage, after the copy-out; names[i]
    names the span from mark i to mark i + 1 ("h2d", the stages, "d2h")."""

    __slots__ = ("clock", "names", "marks")

    def __init__(self, clock: Clock, names: tuple):
        self.clock, self.names, self.marks = clock, names, []

    def stamp(self) -> None:
        self.marks.append(self.clock.mark())

    @property
    def ready(self):
        """The event recorded after the copy-out (None on the CPU)."""
        return self.marks[-1] if self.clock.cuda else None

    def wait(self) -> None:
        if self.clock.cuda:
            self.marks[-1].synchronize()

    def read(self, origin=None) -> tuple[float, float, list]:
        """After wait(): (start, end, [(name, seconds)]), start and end
        the first and last marks in seconds after the mark `origin` (a
        mark of the same device; None: the first), and give the events
        back to the clock."""
        c, m = self.clock, self.marks
        start = c.seconds(origin, m[0]) if origin is not None else 0.0
        spans = [(n, c.seconds(a, b)) for n, a, b in zip(self.names, m, m[1:])]
        end = start + sum(s for _n, s in spans)
        c.release(m)
        return start, end, spans


def idle_split(span_s: float, batches) -> dict:
    """The card's idle time within one call of span_s seconds, from its
    batches' (start, end, fed) in seconds after the call's start:
    dev_idle_head, the call's start to the first batch; dev_idle_feed,
    the gaps before each later batch that the submit thread fed (fed
    true: the card waiting on it); dev_idle_tail, the other gaps and the
    last batch's end to the call's end. With the batches' busy seconds
    they add up to span_s wherever no two batches overlap, as on one
    stream."""
    head = feed = tail = 0.0
    last = None
    for start, end, fed in sorted(batches):
        if last is None:
            head = max(start, 0.0)
        elif fed:
            feed += max(start - last, 0.0)
        else:
            tail += max(start - last, 0.0)
        last = end if last is None else max(last, end)
    tail += max(span_s - (last or 0.0), 0.0)
    return {"dev_idle_head": head, "dev_idle_feed": feed, "dev_idle_tail": tail}


def _copy_out(out: torch.Tensor) -> torch.Tensor:
    """Start the copy of a stage's output on the card into a fresh pinned
    host buffer; on the CPU the output itself."""
    if not out.is_cuda:
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    return host


def _stamp_names(fn) -> tuple:
    return ("h2d", *(name for name, _s in program_stages(fn)), "d2h")


def run_eager(fn, inputs: tuple, stats: dict, clock: Clock, /, **statics):
    """fn(*inputs on the clock's device, **statics) issued eagerly, stage
    by stage, for host tensors `inputs`; returns (its output's host
    buffer, the batch's Stamps). Adds eager_stages and the host seconds
    upload, stage_issue and d2h_issue to `stats`."""
    stamps = Stamps(clock, _stamp_names(fn))
    with span(stats, "upload"):
        if clock.cuda:
            inputs = tuple(a.pin_memory() for a in inputs)
        stamps.stamp()
        if clock.cuda:
            inputs = tuple(a.to(clock.device, non_blocking=True) for a in inputs)
        stamps.stamp()
    with span(stats, "stage_issue"):
        out = run_stages(program_stages(fn), inputs, statics, stamps.stamp)
    with span(stats, "d2h_issue"):
        host = _copy_out(out)
        stamps.stamp()
    _add(stats, "eager_stages", 1)
    return host, stamps


class CudaGraph:
    """A program's graph on the card: torch.cuda.CUDAGraph, captured on
    the cache's side stream `stream` in its memory pool `pool`. Capture
    mode "thread_local": the drain thread may wait on events and read
    host buffers while the producer thread captures."""

    def __init__(self, pool, stream):
        self._graph = torch.cuda.CUDAGraph()
        self._pool, self._stream = pool, stream

    def capture(self, fn):
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


def _tensors(out) -> list:
    """A stage's output as a list of tensors (a tensor, or a dict's
    values)."""
    return list(out.values()) if isinstance(out, dict) else [out]


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
            new = self.fn()
        for dst, src in zip(_tensors(self.out), _tensors(new)):
            dst.copy_(src)


@dataclasses.dataclass
class _Program:
    inputs: tuple          # the static input buffers on the device
    graphs: list           # one graph per stage, replayed in order
    out: torch.Tensor      # the last graph's static output
    stage_launches: list   # per stage, the launches (and collectives) recorded
    names: tuple           # the stamps' names: h2d, the stages, d2h
    statics: dict          # holds the identity statics alive

    @property
    def launches(self) -> list:
        """Every stage's recorded launches, in order."""
        return [e for rec in self.stage_launches for e in rec]

    def replay(self) -> None:
        """Replay every stage's graph, in order, on the static buffers."""
        for graph in self.graphs:
            graph.replay()


class ProgramCache:
    """Captured programs of one device, by program_key, at most
    `max_programs` live. `graph(pool, stream)` makes a stage's graph:
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
        self.clock = Clock(self.device, self._stream)
        self._lock = threading.Lock()
        self.programs: collections.OrderedDict = collections.OrderedDict()
        # keys run once and not captured (cleared past 1024: a forgotten
        # key runs eagerly once more)
        self._seen: set = set()
        # keys captured so far (cleared past 1024, as _seen): a key
        # captured again after its eviction adds graph_recaptures
        self._captured: set = set()
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
        program, captured now if it is not live. Returns (its output's
        host buffer, the batch's Stamps); on the CPU the buffer is a copy
        of a replay's static output. Adds eager_stages or graph_replays,
        graph_captures, graph_evictions, graph_recaptures, capture (s) and
        the host seconds upload, stage_issue and d2h_issue to `stats`."""
        key = program_key(fn, inputs, statics)
        with self._lock, self._on_stream():
            prog = self.programs.get(key)
            if prog is None and key not in self._seen:
                if len(self._seen) >= 1024:
                    self._seen.clear()
                self._seen.add(key)
                return run_eager(fn, inputs, stats, self.clock, **statics)
            if prog is None:
                prog = self._capture(key, fn, inputs, statics, stats)
            else:
                self.programs.move_to_end(key)
            stamps = Stamps(self.clock, prog.names)
            with span(stats, "upload"):
                if self._stream is not None:
                    inputs = tuple(a.pin_memory() for a in inputs)
                stamps.stamp()
                for dst, src in zip(prog.inputs, inputs):
                    dst.copy_(src, non_blocking=True)
                stamps.stamp()
            with span(stats, "stage_issue"):
                for graph, launches in zip(prog.graphs, prog.stage_launches):
                    graph.replay()
                    counts.replay(launches)
                    stamps.stamp()
            with span(stats, "d2h_issue"):
                host = _copy_out(prog.out)
                if self._stream is None:
                    host = host.clone()  # the next replay overwrites the static output
                stamps.stamp()
            _add(stats, "graph_replays", 1)
            return host, stamps

    def _capture(self, key, fn, inputs, statics, stats) -> _Program:
        """Capture fn's stages on static input buffers shaped like
        `inputs` into a new live program (evicting the least recently
        used beyond max_programs)."""
        with span(stats, "capture") as timed:
            reserved = self._reserved()
            # zeros (a batch of empty reads) until the replay's copy-in: a
            # capture runs nothing, but the CPU tests' stand-in runs the stage
            state = tuple(torch.zeros(a.shape, dtype=a.dtype, device=self.device)
                          for a in inputs)
            static_in, graphs, launches = state, [], []
            for i, (_name, stage) in enumerate(program_stages(fn)):
                graph = self._graph(self._pool, self._capture_stream)
                with counts.recording() as recorded:
                    # the previous stage's output stays referenced until
                    # this capture ends, then goes back to the pool
                    state = graph.capture(functools.partial(_call_stage, i, stage, state,
                                                            statics))
                graphs.append(graph)
                launches.append(recorded)
            self.pool_bytes += self._reserved() - reserved
            prog = self.programs[key] = _Program(static_in, graphs, state, launches,
                                                 _stamp_names(fn), statics)
            if key in self._captured:
                _add(stats, "graph_recaptures", 1)
            elif len(self._captured) >= 1024:
                self._captured.clear()
            self._captured.add(key)
            while len(self.programs) > self.max_programs:
                self.programs.popitem(last=False)
                _add(stats, "graph_evictions", 1)
        self.capture_s.append(timed.seconds)
        _add(stats, "graph_captures", 1)
        return prog

    def _reserved(self) -> int:
        return torch.cuda.memory_reserved(self.device) if self._stream is not None else 0


def _add(stats: dict, key: str, v) -> None:
    stats[key] = stats.get(key, 0) + v
