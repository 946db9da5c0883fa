"""The process-group mesh of the multi-GPU mapper, and its collectives.

Counterpart of minimap2_rs_tpu/parallel/mesh.py (make_mesh, :23). In
torch every rank is a process. A mesh of shape (dp, ix) covers a world
of dp * ix ranks and puts rank r at (r // ix, r % ix), the place the JAX
mesh gives device r (devices.reshape(dp, ix)). Axes:

- "dp": data parallel over read batches;
- "ix": the index hash-range-sharded over ix ranks, the anchors
  exchanged by all_to_all (parallel/pipeline.py).

The device is explicit and the backend follows it: NCCL on CUDA, gloo on
the CPU. `share_device=True` is the one-card layout: every rank runs on
the same CUDA device and the ranks talk through gloo, since NCCL refuses
two ranks on one device. Gloo collectives stage CUDA tensors through
host memory, chosen by the backend; NCCL collectives take the device
tensors. Each collective's count, bytes sent by this rank, host seconds
and transport are kept in `Mesh.stats`; a collective captured into a
CUDA graph is counted on every replay (calls, bytes and replayed calls;
its seconds stay those of the collectives issued eagerly).

The groups are made with new_group rather than init_device_mesh, which
sets each rank's device from its rank and so cannot lay several ranks on
one card.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels import counts

# seconds a collective (and the group's start) may wait for the other
# ranks before it raises: ranks that issue different sequences deadlock
DEFAULT_TIMEOUT_S = 600


def backend_for(device: torch.device, share_device: bool = False) -> str:
    """NCCL for CUDA ranks on their own cards, gloo for CPU ranks and for
    ranks that share one card."""
    return "nccl" if device.type == "cuda" and not share_device else "gloo"


def rank_device(device: str | torch.device, share_device: bool = False) -> torch.device:
    """This rank's device: "cuda" without an index is cuda:LOCAL_RANK (the
    torchrun layout, one card a rank), or the current card when the ranks
    share it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and not share_device:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def init_process_group(device: torch.device, *, share_device: bool = False, store=None,
                       rank: int = 0, world_size: int = 1,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Start this process's default group unless it has one: through
    `store` (e.g. a FileStore its ranks share) at `rank` of `world_size`,
    else from the torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR),
    else as a group of one rank. Returns the backend; an existing group
    of another backend raises."""
    backend = backend_for(device, share_device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"device {device} needs {backend}")
        return backend
    if backend == "nccl":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if store is not None:
        dist.init_process_group(store=store, rank=rank, world_size=world_size, **kw)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)
    return backend


@dataclasses.dataclass
class Mesh:
    """A (dp, ix) mesh of ranks: this rank's place, its device and the
    groups of its axes ("world", "dp": the ranks of its ix column, "ix":
    the ranks of its dp row, each in rank order)."""

    dp: int
    ix: int
    rank: int
    device: torch.device
    backend: str
    groups: dict
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.ix

    @property
    def ix_rank(self) -> int:
        return self.rank % self.ix

    def size(self, axis: str) -> int:
        return {"world": self.dp * self.ix, "dp": self.dp, "ix": self.ix}[axis]

    def _run(self, name: str, axis: str, x: torch.Tensor, sent: int, fn) -> torch.Tensor:
        """fn(input) -> output on the transport the backend takes; keeps
        the collective's count, bytes sent, seconds and transport. Inside
        a recording (a capture of a device program, kernels/counts.py)
        nothing has run yet: each replay of the program counts the call,
        its bytes and one replayed call, and no seconds."""
        staged = self.backend == "gloo" and x.is_cuda
        t0 = time.perf_counter()
        out = fn(x.cpu() if staged else x.contiguous())
        if staged:
            out = out.to(x.device)
        transport = f"{self.backend}, " + ("staged through host memory" if staged else
                                           "device memory" if x.is_cuda else "host memory")
        key = f"{name}/{axis}"
        if not counts.defer(lambda: self._tally(key, transport, sent, replayed=1)):
            self._tally(key, transport, sent, seconds=time.perf_counter() - t0)
        return out

    def _tally(self, key: str, transport: str, sent: int, seconds: float = 0.0,
               replayed: int = 0) -> None:
        st = self.stats.setdefault(key, {"calls": 0, "replayed_calls": 0, "bytes_sent": 0,
                                         "seconds": 0.0, "transport": transport})
        st["calls"] += 1
        st["replayed_calls"] += replayed
        st["bytes_sent"] += sent
        st["seconds"] += seconds

    def start_communicators(self) -> None:
        """One small collective on each group, not counted in `stats`.
        torch makes a group's NCCL communicator at its first collective,
        which must never be inside a capture (it allocates and
        synchronises)."""
        for group in self.groups.values():
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The group's x concatenated along dim 0 in group-rank order."""
        n = self.size(axis)

        def fn(t):
            out = t.new_empty((n * t.shape[0], *t.shape[1:]))
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, t, group=self.groups[axis])
            return out

        return self._run("all_gather", axis, x, x.nbytes * (n - 1), fn)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Row block j of x (dim 0 split in n equal blocks) goes to group
        rank j; block i of the result came from group rank i."""
        n = self.size(axis)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")

        def fn(t):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=self.groups[axis])
            return out

        return self._run("all_to_all", axis, x, x.nbytes * (n - 1) // n, fn)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over the group."""
        n = self.size(axis)

        def fn(t):
            t = t.clone()
            dist.all_reduce(t, group=self.groups[axis])
            return t

        return self._run("all_reduce", axis, x, x.nbytes * (n - 1), fn)


def make_mesh(dp: int | None = None, ix: int = 1, *, device: str | torch.device,
              share_device: bool = False) -> Mesh:
    """The (dp, ix) mesh over this launch's ranks; dp defaults to
    world // ix. Starts the default group if there is none
    (init_process_group). A mesh must cover the world exactly: asking
    for more ranks, or fewer, than the launch has raises."""
    dev = rank_device(device, share_device)
    backend = init_process_group(dev, share_device=share_device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // ix
    if dp < 1 or ix < 1 or dp * ix != world:
        raise ValueError(f"mesh {dp}x{ix} needs {dp * ix} ranks; the launch has {world}")
    groups = {"world": dist.group.WORLD}
    # every rank makes every group, in the same order
    for i in range(ix):
        g = dist.new_group([d * ix + i for d in range(dp)])
        if rank % ix == i:
            groups["dp"] = g
    for d in range(dp):
        g = dist.new_group([d * ix + i for i in range(ix)])
        if rank // ix == d:
            groups["ix"] = g
    return Mesh(dp=dp, ix=ix, rank=rank, device=dev, backend=backend, groups=groups)
