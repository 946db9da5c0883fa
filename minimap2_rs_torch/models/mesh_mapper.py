"""The multi-GPU Mapper: the lite mapping path over a mesh of ranks.

Counterpart of minimap2_rs_tpu/models/mesh_mapper.py. Every rank runs
Mapper.map_reads_paf on the same read list, so the bucketing, the batch
shapes and the tier-2 and wide-pass decisions are the same on every
rank, and so is the order of the collectives each rank issues. Each rank
runs the device stage (parallel/pipeline.py) on its rows: rows split
over "dp" with the index replicated, or over ("dp", "ix") with the index
hash-range-sharded over "ix" and the anchors exchanged by all_to_all.
An all_gather of the wire rows then gives every rank the whole batch in
read order, and the host postprocess runs unchanged. The PAF bytes equal
the single-device Mapper's and the host oracle's.

Parameterizations off the lite path (min_cnt <= 1) run the inherited
single-device general path on every rank, as in the JAX package: they
need the host backtrack anyway.

On a CUDA device whose mesh runs NCCL, every device stage goes through
the mapper's program cache (models/programs.py), as on Mapper: a key's
first batch runs eagerly, its second is captured into one CUDA graph
with the step's collectives inside (the dp or sharded step and the
closing all_gather), and later batches replay it. The JAX package
compiles each key once in the same way (MeshMapper._device_stage_lite,
a jit of a shard_map with its collectives inside). Every NCCL
communicator is made, and the sharded index uploaded, when the mapper
is made: a capture may neither create a communicator nor copy from the
host. Every rank makes the same bucketing, tier and wide decisions, so
every rank sees the same sequence of keys, and with it the same first
runs, captures, replays, least-recently-used evictions and resets of
the cache's seen keys: each rank's collectives pair with the same
collectives on the others, captured or not. A gloo mesh
on a card (share_device=True) stages each collective through host
memory (Mesh._run's x.cpu()), a host synchronisation no capture can
hold, so it needs graphs=False; graphs=True there raises. On the CPU
every stage runs eagerly.
"""

from __future__ import annotations

import dataclasses
from math import gcd

from ..parallel.mesh import Mesh, make_mesh
from ..parallel.pipeline import (
    map_batch_dp_lite,
    map_batch_sharded_lite,
    sharded_payload_bytes,
)
from ..parallel.sharded_index import ShardedDeviceIndex
from ..ops.sketch import wire_codes
from .mapper import Mapper, _add_stats
from .programs import named


@dataclasses.dataclass
class MeshMapper(Mapper):
    """Mapper over a Mesh (parallel/mesh.py). index_sharded=True splits
    the minimizer table into mesh.ix hash ranges; False replicates it on
    every rank. The mesh programs take the 4-bit wire."""

    mesh: Mesh = None
    index_sharded: bool = False
    # the collective bytes of one sharded call, by (reads, bucket) of the
    # whole batch (parallel/pipeline.sharded_payload_bytes; the JAX
    # MeshMapper's stats["ici_payload"])
    payload_per_call: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("MeshMapper needs a mesh")
        if self.mesh.device != self.device:
            raise ValueError(f"mapper on {self.device}, mesh rank on {self.mesh.device}")
        capture = self.graphs and self.device.type == "cuda"
        if capture and self.mesh.backend != "nccl":
            raise ValueError(
                f"a {self.mesh.backend} mesh on {self.device} cannot be captured: it "
                "stages every collective through host memory, a host synchronisation "
                "no CUDA graph can hold; pass graphs=False")
        super().__post_init__()
        self.sidx = (ShardedDeviceIndex.from_host(
            self.idx.keys, self.idx.starts, self.idx.counts, self.idx.positions,
            n_shards=self.mesh.ix, key_bits=2 * self.idx.k, rank=self.mesh.ix_rank,
            device=self.device) if self.index_sharded else None)
        if capture:
            self.mesh.start_communicators()

    @property
    def _sharded(self) -> bool:
        return self.index_sharded and self.mesh.ix > 1

    def _shapes_for(self, bucket: int, mult: int):
        """The batch splits over dp, and each dp row's slice over ix (the
        all_to_all splits the row's reads)."""
        M, A, window, B = super()._shapes_for(bucket, mult)
        step = self.mesh.dp * self.mesh.ix
        return M, A, window, max(step, B // step * step)

    def _quantize_b(self, n: int, b_max: int) -> int:
        """Chunk capacities divide over dp * ix as well: the base
        capacity rounded up to the lcm of 128 and the step, or b_max
        (already a multiple of the step) when that overshoots."""
        step = self.mesh.dp * self.mesh.ix
        unit = 128 * step // gcd(128, step)
        q = -(-Mapper._quantize_b(n, b_max) // unit) * unit
        return q if q <= b_max else b_max

    def _encode(self, seqs: list[bytes], B: int, bucket: int):
        return self._encode4(seqs + [b""] * (B - len(seqs)), B, bucket), None, "4bit"

    def _row_axis(self) -> str:
        """The axis a batch's rows split over: the world when the index is
        sharded, else dp (the ix ranks of a dp row map the same rows)."""
        return "world" if self.index_sharded else "dp"

    def _rank_rows(self, arr):
        """This rank's rows of a lite batch array: the lite path uploads
        and maps only those (the general path takes the whole batch).
        Every rank gets the same shape, so no key differs by rank."""
        axis = self._row_axis()
        n = self.mesh.size(axis)
        r = self.mesh.rank if axis == "world" else self.mesh.dp_rank
        b = arr.shape[0] // n
        return arr[r * b:(r + 1) * b]

    def _device_stage_lite(self, wire_arr, lengths, nex, scalars, *, wide, M, A, window,
                           wire, max_chain_skip, stats):
        """The dp or sharded step on this rank's rows through _run_stage.
        The step's statics are the key's; the bytes its collectives must
        send are added to stats here, from the shapes, on every batch
        (a replay runs no Python)."""
        if wire != "4bit":
            raise ValueError("the mesh programs take the 4-bit wire")
        n_ix = self.mesh.ix
        if self._sharded:
            # hash64 spreads a read's occurrences evenly over the shards, so
            # each needs about A / n_ix slots; a shard whose share
            # overflows flags the read (anc_ovf) for the 4x tier
            A = max(128, -(-A // n_ix // 128) * 128)
        # the sharded steps chain over the exchanged n_ix * A slots: the
        # window and its truncation flag apply to that total
        A_total = A * (n_ix if self.index_sharded else 1)
        window = min(window, A_total)
        statics = dict(
            **self._stage_kw(), M=M, A=A, window=window,
            flag_window_ovf=window < min(self.cp.max_chain_iter, A_total),
            max_chain_skip=max_chain_skip, wide=wide,
        )
        # every rank issues this batch with the same statics and shapes
        # (_rank_rows), so the cache runs, captures, replays or evicts it
        # on every rank alike: nothing rank-dependent enters the key
        if self._sharded:
            payload = sharded_payload_bytes(statics, lengths.shape[0] * n_ix, n_ix)
            _add_stats(stats, "collective_payload_bytes",
                       payload["total_collective_bytes_per_rank"])
            shape = (lengths.shape[0] * self.mesh.size("world"), 2 * wire_arr.shape[1])
            self.payload_per_call[str(shape)] = payload
        return self._run_stage(self._mesh_stage_lite, (wire_arr, lengths, nex), stats,
                               scalars=scalars, **statics)

    @named("mesh_step")
    def _mesh_stage_lite(self, d_wire, d_len, d_nex, *, scalars, **statics):
        """The dp or sharded step on this rank's rows, then the all_gather
        of every rank's wire rows: one stage, stamped as a whole
        (dev_mesh_step)."""
        codes = wire_codes(d_wire, d_len, d_nex, "4bit")
        common = (scalars, self._scalars_wide, self.mid_occ, self._tlens_dev,
                  self.cp.rmq_rescue_size, self.cp.rmq_rescue_ratio, self._log2_tab,
                  statics)
        if self.index_sharded:
            rows = map_batch_sharded_lite(self.mesh, self.sidx, codes, d_len, *common)
        else:
            rows = map_batch_dp_lite(self.dev_idx, codes, d_len, *common)
        return self.mesh.all_gather(rows, self._row_axis())


def make_mesh_mapper(idx, cp, mp=None, *, dp: int | None = None, ix: int = 1,
                     index_sharded: bool = False, device="cuda",
                     share_device: bool = False, **kw) -> MeshMapper:
    """A MeshMapper over a (dp, ix) mesh of this launch's ranks (dp
    defaults to world // ix; parallel/mesh.make_mesh)."""
    from ..config import MapParams

    mesh = make_mesh(dp=dp, ix=ix, device=device, share_device=share_device)
    return MeshMapper.from_oracle_index(
        idx, cp, mp if mp is not None else MapParams(), device=mesh.device,
        mesh=mesh, index_sharded=index_sharded, **kw,
    )
