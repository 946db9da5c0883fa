"""The end-to-end mapper, in PyTorch.

Counterpart of minimap2_rs_tpu/models/mapper.py (Mapper.map_reads_paf,
mapper.py:565-668). Reads are bucketed by length into padded batches,
and one device program per batch runs the pipeline. Two paths:

  * lite (min_cnt >= 2, the default): the program runs through
    on-device finalize (models/stages.py), and the host formats PAF
    from the 10-word wire rows with the native runtime. After the
    in-order drain come the lazy wide-band pass (long-read shapes), the
    4x-capacity tier for overflowed reads, and the host oracle pipeline
    for what is left.
  * general (min_cnt < 2, or MM2T_NO_LITE): the program stops after the
    (f, prev) chain DP and returns one int32 buffer of anchors, DP and
    minimizers per read; the host backtracks, merges, selects chains
    (secondaries, s2) and takes the rescue decision. Reads it rescues
    re-run the chain DP at bw_long in one batched device pass; reads
    that overflow their slots go to the host oracle pipeline.

MM2T_SKIP_PRUNE=1 makes every chain DP of both paths (the rescue
re-chain, tier 2 and the lazy wide pass included) replicate the
reference's order-dependent max_chain_skip pruning, as the JAX mapper
does (mapper.py:222-230); by default the window is scored exactly.

Submission runs on a background thread feeding the drain in order; on
CUDA each batch goes up as a pinned 2-bit wire and comes back through a
pinned buffer with a non-blocking copy and an event, so the host
postprocess of batch i overlaps the device work of later batches. A
CUDA mapper issues each device stage (the lite and general programs,
the rescue re-chain) through captured programs: the first batch of a
stage and shape runs eagerly, the second captures it as a CUDA graph,
and that and every later batch replay it (models/programs.py; JAX keeps
one executable per shape, mapper.py:396-435); graphs=False runs them
all eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from ..config import ChainParams, MapParams
from ..device import resolve_device
from ..kernels.chain_dp import chain_dp_batch
from ..ops.chain_ops import ChainScalars, chain_scalars_from_params, log2_table
from ..ops.finalize_ops import FIELDS, WIRE_WORDS, as_i32, unpack_fields_wire
from ..ops.index_ops import DeviceIndex
from ..oracle import lchain as olchain
from ..oracle import pipeline as opipeline
from ..oracle.index import OracleIndex
from ..oracle.paf import write_paf_many_with_scores
from ..runtime.host import (
    native_available,
    native_backtrack,
    native_encode_pack2,
    native_encode_pack4,
    native_format_lite,
    native_postprocess,
)
from ..utils.packing import nt4_encode
from .programs import COUNTERS, ProgramCache, run_eager
from .stages import (
    chain_finalize_lite,
    chain_inputs,
    sketch_to_anchors,
    unpack_codes2,
    unpack_codes4,
)

# per-batch capacity of the 2-bit wire's ambiguous-base exception list;
# batches with more Ns take the 4-bit wire
_NEX_CAP = 2048
# band policy: shapes below this anchor capacity compute both chain bands
# in one call (the JAX package's sublane/lane kernel boundary, kept so
# both packages batch and route reads identically)
_DUAL_BAND_MAX_A = 1024
# anchor slots per device call (caps reads per call for long buckets)
_SLOT_TARGET = 2 << 20
# lite-path chain window cap (slots) at 1x capacity; reads whose
# truncated window could lose a predecessor are flagged (win_ovf) and
# re-run at the full window in the 4x tier. The general path runs the
# full window, min(max_chain_iter, A).
LITE_WINDOW_CAP = 1024


def _chain_skip_cfg(cp: ChainParams) -> int | None:
    """cp.max_chain_skip under MM2T_SKIP_PRUNE (the reference's pruned
    DP, lchain.rs:79-88), else None: the exact window, a superset that
    can only find equal or better chains (JAX mapper.py:222-230)."""
    return cp.max_chain_skip if os.environ.get("MM2T_SKIP_PRUNE") else None


def _combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _dv_from_fields(fields: np.ndarray, col: dict) -> np.ndarray:
    """dv for the whole batch in one vectorized float32 pass (bit-equal
    to the reference's scalar f32 math, paf.rs:156-199)."""
    avg_k = fields[:, col["sum_span"]].astype(np.float32) / np.maximum(
        fields[:, col["n_mini"]], 1
    ).astype(np.float32)
    kf = np.maximum(avg_k, np.float32(1.0))
    frac = fields[:, col["n_match"]].astype(np.float32) / np.maximum(
        fields[:, col["n_tot"]], 1
    ).astype(np.float32)
    return np.where(
        (frac < np.float32(1.0)) & (fields[:, col["dv_found"]] != 0),
        np.float32(1.0) - frac ** (np.float32(1.0) / kf),
        np.float32(0.0),
    )


def _codes_from_wire(codes, lengths, nex, wire: str) -> torch.Tensor:
    """The H2D wire -> (B, L) int32 nt4 codes."""
    if wire == "4bit":
        codes = unpack_codes4(codes)
    elif wire == "2bit":
        codes = unpack_codes2(codes, lengths, nex)
    if codes.shape[-1] > 1 << 22:
        raise ValueError("reads longer than 4M bases are unsupported")
    return codes


def _fused_map_stage_lite(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    nex: torch.Tensor,
    *,
    dev_idx: DeviceIndex,
    scalars: ChainScalars,
    scalars_wide: ChainScalars,
    mid_occ: int,
    tlens: torch.Tensor,
    rmq_rescue_size: int,
    rmq_rescue_ratio: float,
    log2_tab: torch.Tensor,
    w: int, k: int, q_occ_max: int, q_occ_frac: float,
    M: int, A: int, window: int,
    flag_window_ovf: bool, wire: str, wide: bool,
    max_chain_skip: int | None = None,
) -> torch.Tensor:
    """The whole per-batch device pipeline (JAX _fused_map_stage_lite,
    mapper.py:160-219) on one batch's wire, lengths and N list; returns
    the (B, 10) int32 wire rows."""
    codes = _codes_from_wire(codes, lengths, nex, wire)
    anc = sketch_to_anchors(
        dev_idx, codes, lengths, mid_occ, w=w, k=k,
        q_occ_max=q_occ_max, q_occ_frac=q_occ_frac, M=M, A=A,
    )
    return chain_finalize_lite(
        anc, lengths, scalars, scalars_wide, tlens,
        rmq_rescue_size, rmq_rescue_ratio,
        k=k, window=window, log2_tab=log2_tab,
        flag_window_ovf=flag_window_ovf, max_chain_skip=max_chain_skip, wide=wide,
    )


def _fused_map_stage(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    nex: torch.Tensor,
    *,
    dev_idx: DeviceIndex,
    scalars: ChainScalars,
    mid_occ: int,
    log2_tab: torch.Tensor,
    w: int, k: int, q_occ_max: int, q_occ_frac: float,
    M: int, A: int, window: int, wire: str,
    max_chain_skip: int | None = None,
) -> torch.Tensor:
    """The general path's per-batch device program (JAX _fused_map_stage,
    mapper.py:79-149): wire unpack, sketch to anchors, the (f, prev)
    chain DP, packed into ONE (B, 6A + M + 4) int32 buffer [x_hi | x_lo |
    y_hi | y_lo | f | prev | cps | n_mini | n_anchors | mini_ovf |
    anc_ovf] (uint32 words as their int32 bits), so each batch comes
    back in one copy."""
    codes = _codes_from_wire(codes, lengths, nex, wire)
    anc = sketch_to_anchors(
        dev_idx, codes, lengths, mid_occ, w=w, k=k,
        q_occ_max=q_occ_max, q_occ_frac=q_occ_frac, M=M, A=A,
    )
    f, prev = chain_dp_batch(
        *chain_inputs(anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"]),
        scalars, window, log2_tab, max_chain_skip,
    )
    words = [as_i32(anc[c]) for c in ("x_hi", "x_lo", "y_hi", "y_lo")]
    flags = [anc[c].to(torch.int32)[:, None]
             for c in ("n_mini", "n_anchors", "mini_ovf", "anc_ovf")]
    return torch.cat(words + [f, prev, as_i32(anc["cps"])] + flags, dim=1)


def _packed_chain_stage(x_hi, x_lo, y_hi, y_lo, *, scalars: ChainScalars,
                        window: int, log2_tab: torch.Tensor,
                        max_chain_skip: int | None = None) -> torch.Tensor:
    """The chain DP alone (the rescue re-run, lchain.rs:321-330; JAX
    mapper.py:244-266) on (B, A) int32 anchor words, packed into one
    (B, 2A) buffer [f | prev]."""
    f, prev = chain_dp_batch(*chain_inputs(x_hi, x_lo, y_hi, y_lo),
                             scalars, window, log2_tab, max_chain_skip)
    return torch.cat([f, prev], dim=1)


def _unpack_map_stage(packed: np.ndarray, M: int, A: int) -> dict:
    """Host views of _fused_map_stage's buffer (JAX mapper.py:269-295)."""
    cols = [
        ("x_hi", A, np.uint32), ("x_lo", A, np.uint32),
        ("y_hi", A, np.uint32), ("y_lo", A, np.uint32),
        ("f", A, np.int32), ("prev", A, np.int32),
        ("cps", M, np.uint32),
        ("n_mini", 1, np.int32), ("n_anchors", 1, np.int32),
        ("mini_ovf", 1, np.int32), ("anc_ovf", 1, np.int32),
    ]
    out = {}
    off = 0
    for name, width, dtype in cols:
        v = packed[:, off : off + width].view(dtype)
        out[name] = v[:, 0] if width == 1 else v
        off += width
    out["mini_ovf"] = out["mini_ovf"] != 0
    out["anc_ovf"] = out["anc_ovf"] != 0
    return out


def _add_stats(dst: dict, key: str, v) -> None:
    dst[key] = dst.get(key, 0) + v


@dataclasses.dataclass
class Mapper:
    idx: OracleIndex
    dev_idx: DeviceIndex
    cp: ChainParams
    mp: MapParams
    mid_occ: int
    device: torch.device
    # length buckets: reads are padded to the smallest bucket >= length
    buckets: tuple[int, ...] = (
        1024, 2048, 4096, 8192, 12288, 16384, 24576, 32768, 49152, 65536
    )
    batch_size: int = 1024      # max reads per device call
    mini_frac: float = 0.22     # minimizer slots per base of bucket
    anchor_frac: float = 0.18   # anchor slots per base of bucket
    # on CUDA, issue each device stage through captured programs (one
    # CUDA graph per stage and shape, models/programs.py); False runs
    # them eagerly. The CPU always runs them eagerly.
    graphs: bool = True
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # the anchor expansion packs query pos<<1|strand into 23 bits
        if max(self.buckets) > 1 << 22:
            raise ValueError("buckets must be <= 4M bases")
        self._tlens = np.array([s.length for s in self.idx.seq], dtype=np.int32)
        self._tnames = [s.name or "*" for s in self.idx.seq]
        enc = [n.encode() for n in self._tnames]
        self._tname_blob = b"".join(enc)
        self._tname_off = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(n) for n in enc], out=self._tname_off[1:])
        self._tlens_dev = torch.from_numpy(self._tlens).to(self.device)
        self._scalars = chain_scalars_from_params(self.cp)
        self._scalars_wide = chain_scalars_from_params(
            dataclasses.replace(self.cp, bw=self.cp.bw_long)
        )
        self._log2_tab = log2_table(max(self.cp.bw, self.cp.bw_long) + 1).to(self.device)
        self._tier2_queue: list = []
        self._wide_queue: list = []
        self._rescue_queue: list = []
        self.programs = (ProgramCache(self.device)
                         if self.graphs and self.device.type == "cuda" else None)

    @classmethod
    def from_oracle_index(cls, idx: OracleIndex, cp: ChainParams,
                          mp: MapParams = MapParams(), *, device, **kw) -> "Mapper":
        dev = resolve_device(device)
        dev_idx = DeviceIndex.from_host(
            idx.keys, idx.starts, idx.counts, idx.positions, key_bits=2 * idx.k,
            seq_lens=[s.length for s in idx.seq], device=dev,
        )
        mid_occ = max(idx.calc_mid_occ(mp.frac_top_repetitive), mp.mid_occ_floor)
        return cls(idx=idx, dev_idx=dev_idx, cp=cp, mp=mp, mid_occ=mid_occ,
                   device=dev, **kw)

    def _t(self, key: str, dt: float):
        _add_stats(self.stats, key, dt)

    def _lite_eligible(self) -> bool:
        """The on-device finalization is valid when the reference
        backtrack necessarily takes its greedy single-chain fallback
        (min_cnt >= 2); MM2T_NO_LITE selects the general path."""
        return not os.environ.get("MM2T_NO_LITE") and self.cp.min_cnt >= 2

    # ------------------------------------------------------------------

    def map_reads_paf(self, reads: list[tuple[str, bytes]]) -> bytes:
        """Map reads; returns the PAF output as one newline-terminated
        bytes blob in input order."""
        lite = self._lite_eligible()
        results: list = [None] * len(reads)
        order = sorted(range(len(reads)), key=lambda i: len(reads[i][1]))
        groups: dict[int, list[int]] = {}
        for i in order:
            L = len(reads[i][1])
            if L == 0:
                results[i] = []
                continue
            bucket = next((b for b in self.buckets if L <= b), None)
            if bucket is None:  # longer than the largest bucket
                results[i] = self._host_fallback(reads[i])
                continue
            groups.setdefault(bucket, []).append(i)

        # phase 1: a background thread submits every batch; the drain
        # below consumes them in submission order. The producer keeps
        # its own stats, merged after the join.
        self._tier2_queue = []
        self._wide_queue = []
        self._rescue_queue = []
        q: queue.Queue = queue.Queue()
        err: list = []
        sub_stats: dict = {}

        def _producer():
            t0 = time.perf_counter()
            try:
                self._submit_groups(reads, groups, self._scalars, lite, mult=1,
                                    sink=q.put, stats=sub_stats)
            except BaseException as e:  # re-raised by the caller after join
                err.append(e)
            finally:
                q.put(None)
                sub_stats["submit"] = time.perf_counter() - t0

        th = threading.Thread(target=_producer, daemon=True)
        th.start()
        try:
            self._drain_pending(reads, iter(q.get, None), results, lite)
        finally:
            th.join()
        for key, v in sub_stats.items():
            _add_stats(self.stats, key, v)
        if err:
            raise err[0]

        # phase 2.2: rescue-flagged long-read-shape reads re-run with the
        # bw_long scalars (single band; lite path only)
        t4 = time.perf_counter()
        self._drain_wides_lite(reads, results)
        self._t("wide", time.perf_counter() - t4)

        # phase 2.5: capacity-overflow reads re-run at 4x slots (lite
        # path only; the general path sends them to the host)
        t4 = time.perf_counter()
        self._drain_tier2(reads, results)
        self._t("tier2", time.perf_counter() - t4)

        # phase 3: one batched wide-band re-chain of the reads the
        # general path's host rescue decision queued
        t4 = time.perf_counter()
        self._drain_rescues(reads, results)
        self._t("rescue", time.perf_counter() - t4)

        parts = [line for r in results if r for line in r]
        return b"\n".join(parts) + b"\n" if parts else b""

    def map_reads(self, reads: list[tuple[str, bytes]]) -> list[str]:
        """map_reads_paf decoded into a list of PAF line strings."""
        blob = self.map_reads_paf(reads)
        return blob.decode().split("\n")[:-1] if blob else []

    def _shapes_for(self, bucket: int, mult: int):
        """Padded capacities (M, A), chain window and reads per call for
        a length bucket (mapper.py:676-688)."""
        lane = lambda v: max(128, -(-int(v) // 128) * 128)
        M = min(lane(bucket * self.mini_frac * mult), lane(bucket))
        A = lane(bucket * self.anchor_frac * mult)
        window = min(self.cp.max_chain_iter, A)
        B = min(self.batch_size, max(8, _SLOT_TARGET // A))
        B = B // 128 * 128 if B >= 128 else -(-B // 8) * 8
        return M, A, window, B

    @staticmethod
    def _quantize_b(n: int, b_max: int) -> int:
        """Padded rows for an n-read chunk: the smallest 1.5x-step
        capacity (128 x {1,2,3,4,6,8,...}) >= n, capped at b_max."""
        if n >= b_max:
            return b_max
        c = 128
        while c < n:
            c2 = c + (c >> 1) if c >= 256 else c * 2
            c = c2 // 128 * 128
        return min(c, b_max)

    @staticmethod
    def _dual_band(A: int) -> bool:
        """Short-read shapes run both chain bands in one call (rescue
        resolved on device); long-read shapes run the normal band and
        re-run rescue-flagged reads lazily (phase 2.2)."""
        return A < _DUAL_BAND_MAX_A

    def _encode(self, seqs: list[bytes], B: int, bucket: int):
        """Host batch -> (wire array, nex or None, wire name): the 2-bit
        wire, the 4-bit wire when the batch holds more than _NEX_CAP
        ambiguous bases, NumPy encoding without the native runtime."""
        seqs = seqs + [b""] * (B - len(seqs))
        out2 = native_encode_pack2(seqs, bucket // 4, _NEX_CAP)
        if out2 is not None:
            return out2[0], out2[1], "2bit"
        return self._encode4(seqs, B, bucket), None, "4bit"

    @staticmethod
    def _encode4(seqs: list[bytes], B: int, bucket: int) -> np.ndarray:
        """The 4-bit wire of B padded reads: (B, bucket // 2) uint8, two
        nt4 codes a byte (native, or NumPy without the runtime)."""
        packed4 = native_encode_pack4(seqs, bucket // 2)
        if packed4 is None:
            codes = np.full((B, bucket), 4, dtype=np.uint8)
            enc = nt4_encode(b"".join(seqs))
            off = 0
            for bi, s in enumerate(seqs):
                codes[bi, : len(s)] = enc[off : off + len(s)]
                off += len(s)
            packed4 = codes[:, 0::2] | (codes[:, 1::2] << 4)
        return packed4

    def _stage_kw(self) -> dict:
        """The index's and map parameters' statics of a device program."""
        return dict(w=self.idx.w, k=self.idx.k, q_occ_max=self.mp.q_occ_max,
                    q_occ_frac=self.mp.q_occ_frac)

    def _rank_rows(self, arr: np.ndarray) -> np.ndarray:
        """The rows of a lite batch array (the wire, the lengths) that this
        process maps: all of them (MeshMapper: its rank's)."""
        return arr

    def _run_stage(self, fn, inputs: tuple, stats: dict, /, **statics):
        """fn(*inputs on the device, **statics) for one batch's host arrays
        `inputs`: through the program cache (self.programs) on a CUDA
        mapper with graphs, else eagerly. Returns (the output's host
        buffer, the event its copy completes, None on the CPU). Adds
        device_stages, the cache's counts (or eager_stages) and the host
        seconds upload, stage_issue and d2h_issue to stats."""
        _add_stats(stats, "device_stages", 1)
        inputs = tuple(map(torch.from_numpy, inputs))
        if self.programs is not None:
            return self.programs.run(fn, inputs, stats, **statics)
        return run_eager(fn, inputs, stats, self.device, **statics)

    def _device_stage_lite(self, wire_arr, lengths, nex, scalars: ChainScalars, *,
                           wide: bool, M: int, A: int, window: int, wire: str,
                           max_chain_skip: int | None, stats: dict):
        """The lite program on one padded batch's host arrays (its
        _rank_rows): _run_stage's (host wire rows, event). stats is the
        submitting thread's stats dict."""
        return self._run_stage(
            _fused_map_stage_lite, (wire_arr, lengths, nex), stats,
            **self._lite_statics(scalars, wide=wide, M=M, A=A, window=window, wire=wire,
                                 max_chain_skip=max_chain_skip),
        )

    def _lite_statics(self, scalars: ChainScalars, *, wide: bool, M: int, A: int,
                      window: int, wire: str, max_chain_skip: int | None) -> dict:
        """Every keyword argument of _fused_map_stage_lite for one batch
        shape and band: the statics of its program (bench_torch.py times
        the same call)."""
        return dict(
            dev_idx=self.dev_idx, scalars=scalars, scalars_wide=self._scalars_wide,
            mid_occ=self.mid_occ, tlens=self._tlens_dev,
            rmq_rescue_size=self.cp.rmq_rescue_size,
            rmq_rescue_ratio=self.cp.rmq_rescue_ratio, log2_tab=self._log2_tab,
            flag_window_ovf=window < min(self.cp.max_chain_iter, A), wide=wide,
            M=M, A=A, window=window, wire=wire, max_chain_skip=max_chain_skip,
            **self._stage_kw(),
        )

    def _device_stage(self, wire_arr, lengths, nex, scalars: ChainScalars, *,
                      M: int, A: int, window: int, wire: str,
                      max_chain_skip: int | None, stats: dict):
        """The general program on one padded batch's host arrays:
        _run_stage's (host packed buffer, event)."""
        return self._run_stage(
            _fused_map_stage, (wire_arr, lengths, nex), stats,
            dev_idx=self.dev_idx, scalars=scalars, mid_occ=self.mid_occ,
            log2_tab=self._log2_tab, M=M, A=A, window=window, wire=wire,
            max_chain_skip=max_chain_skip, **self._stage_kw(),
        )

    def _submit_groups(self, reads, groups, scalars, lite=True, mult=None,
                       band="auto", sink=None, stats=None):
        """groups: {bucket: [ri...]} with uniform `mult`, or
        {(bucket, mult): [ri...]} when mult is None.
        lite: the lite program (else the general one, whose window is
        never capped).
        band: "auto" applies _dual_band per bucket; "tier2" forces the
        dual-band program and routes residual overflow to the host;
        "widepass" is phase 2.2's single-band re-run.
        sink: each submitted batch is also pushed to sink(entry)."""
        stats = self.stats if stats is None else stats
        pending = []
        for gkey, idxs in groups.items():
            bucket, gmult = gkey if mult is None else (gkey, mult)
            M, A, window, B_max = self._shapes_for(bucket, gmult)
            if band == "tier2":
                wide_prog, mode = True, "tier2"
            elif band == "auto" and self._dual_band(A):
                wide_prog, mode = True, "normal"
            elif band == "widepass":
                wide_prog, mode = False, "wide"
            else:
                wide_prog, mode = False, "lazy"
            if lite and gmult == 1:
                window = min(window, LITE_WINDOW_CAP)
            for c0 in range(0, len(idxs), B_max):
                chunk = idxs[c0 : c0 + B_max]
                B = self._quantize_b(len(chunk), B_max)
                lengths = np.zeros(B, dtype=np.int32)
                lengths[: len(chunk)] = [len(reads[ri][1]) for ri in chunk]
                t0 = time.perf_counter()
                wire_arr, nex, wire = self._encode(
                    [reads[ri][1] for ri in chunk], B, bucket
                )
                _add_stats(stats, "encode", time.perf_counter() - t0)
                if lite:
                    wire_arr, lengths = self._rank_rows(wire_arr), self._rank_rows(lengths)
                _add_stats(stats, "h2d_bytes", wire_arr.nbytes + lengths.nbytes
                           + (nex.nbytes if nex is not None else 0))
                if nex is None:
                    nex = np.zeros(1, dtype=np.int32)
                common = dict(M=M, A=A, window=window, wire=wire,
                              max_chain_skip=_chain_skip_cfg(self.cp), stats=stats)
                # the stage's host seconds go to stats as upload,
                # stage_issue (the stage or its replay, with its
                # collectives) and d2h_issue; the drain waits on `ready`
                if lite:
                    out, ready = self._device_stage_lite(wire_arr, lengths, nex, scalars,
                                                         wide=wide_prog, **common)
                else:
                    out, ready = self._device_stage(wire_arr, lengths, nex, scalars,
                                                    **common)
                entry = (chunk, out, ready, mode, (M, A, window))
                pending.append(entry)
                if sink is not None:
                    sink(entry)
        return pending

    def _drain_pending(self, reads, pending, results, lite=True):
        for chunk, out, ready, mode, (M, A, window) in pending:
            t1 = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            fields = out.numpy()
            _add_stats(self.stats, "d2h_bytes", fields.nbytes)
            if lite:
                if fields.shape[1] == WIRE_WORDS:
                    fields = unpack_fields_wire(fields)
                t2 = time.perf_counter()
                self._postprocess_lite(reads, chunk, fields, results, mode=mode)
            else:
                t2 = time.perf_counter()
                self._postprocess(reads, chunk, _unpack_map_stage(fields, M, A),
                                  results, window)
            t3 = time.perf_counter()
            self._t("d2h+wait", t2 - t1)
            self._t("post", t3 - t2)

    def _drain_wides_lite(self, reads, results):
        """Phase 2.2: long-read-shape reads whose normal-band rescue flag
        fired re-run with the wide-band scalars (single band), replacing
        their rows (lchain.rs:321-330)."""
        wq = self._wide_queue
        self._wide_queue = []
        _add_stats(self.stats, "wide_reads", len(wq))
        if not wq:
            return
        pending = self._submit_groups(reads, self._group(reads, wq),
                                      self._scalars_wide, mult=1, band="widepass")
        self._drain_pending(reads, pending, results)

    def _drain_tier2(self, reads, results):
        """Re-run reads whose minimizer/anchor population overflowed the
        default slots (or whose window was truncated) at 4x capacities;
        residual overflow goes to the host pipeline."""
        tq = self._tier2_queue
        self._tier2_queue = []
        _add_stats(self.stats, "tier2_reads", len(tq))
        if not tq:
            return
        if len(tq) < 48:
            # a handful of reads: the host pipeline is cheaper than a
            # fresh device program
            for ri in tq:
                results[ri] = self._host_fallback(reads[ri])
            return
        pending = self._submit_groups(reads, self._group(reads, tq),
                                      self._scalars, mult=4, band="tier2")
        self._drain_pending(reads, pending, results)

    def _group(self, reads, ris) -> dict[int, list[int]]:
        groups: dict[int, list[int]] = {}
        for ri in ris:
            L = len(reads[ri][1])
            groups.setdefault(next(b for b in self.buckets if L <= b), []).append(ri)
        return groups

    def _postprocess_lite(self, reads, chunk, fields, results, mode="normal"):
        """Route the device's (B, 18) field rows: clean rows become PAF
        line bytes, overflow rows requeue to the 4x tier or fall back to
        the host pipeline.

        Modes:
          "normal" — merged dual-band rows; overflow to the tier.
          "lazy"   — single-band rows (long-read shapes): rescue-flagged
                     clean rows queue for the phase-2.2 wide re-run.
          "wide"   — the phase-2.2 re-run: rows replace phase-1 results.
          "tier2"  — final: residual overflow to the host pipeline.

        The native runtime formats the lines (mm2t_format_lite); the
        Python loop below is the bit-identical fallback."""
        col = {name: i for i, name in enumerate(FIELDS)}
        requeue = mode != "tier2"
        lazy = mode == "lazy"
        n = len(chunk)
        fr = np.ascontiguousarray(fields[:n])
        ovf_m = (
            (fr[:, col["mini_ovf"]] != 0)
            | (fr[:, col["anc_ovf"]] != 0)
            | (fr[:, col["win_ovf"]] != 0)
        )
        resc = np.zeros(n, dtype=bool)
        if lazy:
            resc = (fr[:, col["rescue"]] != 0) & ~ovf_m
            if not fr.flags.writeable:
                fr = fr.copy()
            # suppress the normal-band line; the wide pass replaces it
            fr[resc, col["n_anchors"]] = 0
        elif mode != "wide":
            # dual-band rows carry the normal band's rescue flag: count
            # the device-resolved wide-band switches
            _add_stats(self.stats, "wide_reads",
                       int(((fr[:, col["rescue"]] != 0) & ~ovf_m).sum()))
        dv_n = _dv_from_fields(fr, col)
        qlens = np.fromiter((len(reads[ri][1]) for ri in chunk), dtype=np.int32, count=n)
        out = native_format_lite(
            fr, dv_n, qlens, [reads[ri][0].encode() for ri in chunk],
            self._tname_blob, self._tname_off, self._tlens, self.mp.mapq, col,
        )
        if out is not None:
            blob, off = out
            bmv = memoryview(blob)
            ovf = ovf_m.tolist()
            rescl = resc.tolist()
            offl = off.tolist()
            for bi, ri in enumerate(chunk):
                a, b = offl[bi], offl[bi + 1]
                if rescl[bi]:
                    self._wide_queue.append(ri)
                elif b > a:
                    results[ri] = [bmv[a:b]]
                elif ovf[bi]:
                    if requeue:
                        self._tier2_queue.append(ri)
                    else:
                        results[ri] = self._host_fallback(reads[ri])
                else:
                    results[ri] = []
            return
        self._format_python(reads, chunk, fr, dv_n, resc, ovf_m, results, requeue)

    def _format_python(self, reads, chunk, fr, dv_n, resc, ovf_m, results, requeue):
        """Python PAF formatting of lite rows (the native formatter's
        bit-identical fallback)."""
        col = {name: i for i, name in enumerate(FIELDS)}
        rows = fr.tolist()
        dv_list = dv_n.tolist()
        tnames, tlens, mapq = self._tnames, self._tlens.tolist(), self.mp.mapq
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            row = rows[bi]
            if resc[bi]:
                self._wide_queue.append(ri)
                continue
            if ovf_m[bi]:
                if requeue:
                    self._tier2_queue.append(ri)
                else:
                    results[ri] = self._host_fallback(reads[ri])
                continue
            if row[col["n_anchors"]] == 0:
                results[ri] = []
                continue
            qlen = len(qseq)
            qs, qe = row[col["qs"]], row[col["qe"]]
            ts, te = row[col["ts"]], row[col["te"]]
            grp = row[col["grp"]]
            rev = (grp >> 31) & 1
            rid = grp & 0x7FFFFFFF
            strand = "-" if rev else "+"
            wqs, wqe = (qlen - qe, qlen - qs) if rev else (qs, qe)
            s1 = max(row[col["score"]], 0)
            results[ri] = [(
                f"{qname}\t{qlen}\t{wqs}\t{wqe}\t{strand}\t"
                f"{tnames[rid]}\t{tlens[rid]}\t{ts}\t{te}\t"
                f"{max(qe - qs, 0)}\t{max(te - ts, 0)}\t{mapq}\t"
                f"tp:A:P\tcm:i:{row[col['cm']]}\ts1:i:{s1}\ts2:i:0\t"
                f"dv:f:{dv_list[bi]:.4f}\trl:i:0"
            ).encode()]

    # ---- general path: host side -------------------------------------

    def _postprocess(self, reads, chunk, out, results, window):
        """Host backtrack, selection, rescue decision and PAF of the
        general path's rows (JAX mapper.py:903-913): the native runtime's
        one-call postprocess, or the Python version without it."""
        if native_available():
            return self._postprocess_native(reads, chunk, out, results)
        return self._postprocess_python(reads, chunk, out, results, window)

    def _read_anchors(self, out, bi: int) -> np.ndarray:
        n = int(out["n_anchors"][bi])
        return np.stack([
            _combine64(out["x_hi"][bi, :n], out["x_lo"][bi, :n]),
            _combine64(out["y_hi"][bi, :n], out["y_lo"][bi, :n]),
        ], axis=1)

    def _postprocess_native(self, reads, chunk, out, results):
        """One native call per read: backtrack + merge + select + PAF
        fields + dv (JAX mapper.py:915-956). Overflowed rows go to the
        host pipeline; rows whose rescue flag fires queue for the
        batched wide-band re-chain."""
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            if out["mini_ovf"][bi] or out["anc_ovf"][bi]:
                results[ri] = self._host_fallback(reads[ri])
                continue
            n = int(out["n_anchors"][bi])
            if n == 0:
                results[ri] = []
                continue
            anchors = self._read_anchors(out, bi)
            nm = int(out["n_mini"][bi])
            mini_pos = (out["cps"][bi, :nm] >> 1).astype(np.int32)
            # queries are sketched non-HPC: every span is k
            mini_span = np.full(nm, self.idx.k, dtype=np.int32)
            recs, dv, s1, s2, rescue = native_postprocess(
                anchors, out["f"][bi, :n], out["f"][bi, :n],
                out["prev"][bi, :n].astype(np.int64), self.cp, len(qseq),
                self.mp.mask_level, self.mp.pri_ratio, self.mp.best_n,
                mini_pos, mini_span, self._tlens,
            )
            if rescue:
                self._rescue_queue.append((ri, anchors, mini_pos, mini_span))
                continue
            results[ri] = self._format_lines(qname, len(qseq), recs, dv, s1, s2)

    def _format_lines(self, qname, qlen, recs, dv, s1, s2) -> list[bytes]:
        """PAF lines from native postprocess records (JAX mapper.py:958-974);
        the first record is the primary."""
        lines = []
        for m in range(recs.shape[0]):
            qs, qe, ts, te, cm, rid, rev, _pri, _sc = recs[m]
            strand = "-" if rev else "+"
            wqs, wqe = (qlen - qe, qlen - qs) if rev else (qs, qe)
            tp = "P" if m == 0 else "S"
            lines.append((
                f"{qname}\t{qlen}\t{wqs}\t{wqe}\t{strand}\t"
                f"{self._tnames[rid]}\t{self._tlens[rid]}\t{ts}\t{te}\t"
                f"{max(qe - qs, 0)}\t{max(te - ts, 0)}\t{self.mp.mapq}\t"
                f"tp:A:{tp}\tcm:i:{cm}\ts1:i:{s1}\ts2:i:{s2}\t"
                f"dv:f:{dv[m]:.4f}\trl:i:0"
            ).encode())
        return lines

    def _rechain_wide(self, x_hi, x_lo, y_hi, y_lo, window: int):
        """The bw_long chain DP of (B, A) uint32 anchor words on the
        device; returns host (f, prev) int32 arrays."""
        A = x_hi.shape[1]
        words = tuple(np.ascontiguousarray(a).view(np.int32)
                      for a in (x_hi, x_lo, y_hi, y_lo))
        st: dict = {}
        out, ready = self._run_stage(
            _packed_chain_stage, words, st, scalars=self._scalars_wide,
            window=window, log2_tab=self._log2_tab,
            max_chain_skip=_chain_skip_cfg(self.cp),
        )
        # the program counters only: the rescue's host seconds are in
        # "rescue", and upload/stage_issue/d2h_issue time the map stages
        for k in COUNTERS:
            if k in st:
                _add_stats(self.stats, k, st[k])
        if ready is not None:
            ready.synchronize()
        packed = out.numpy()
        return packed[:, :A], packed[:, A:]

    def _drain_rescues(self, reads, results):
        """Batched wide-band re-chaining of every queued rescue read
        (JAX mapper.py:976-1019): one device pass per batch_size reads."""
        rq = self._rescue_queue
        self._rescue_queue = []
        _add_stats(self.stats, "rescue_reads", len(rq))
        if not rq:
            return
        p2 = dataclasses.replace(self.cp, bw=self.cp.bw_long)
        A = max(128, -(-max(a.shape[0] for _, a, _m, _s in rq) // 128) * 128)
        window = min(self.cp.max_chain_iter, A)
        B = self.batch_size
        for c0 in range(0, len(rq), B):
            group = rq[c0 : c0 + B]
            words = np.full((4, B, A), 0xFFFFFFFF, dtype=np.uint32)
            for bi, (_ri, anchors, _mp, _ms) in enumerate(group):
                n = anchors.shape[0]
                for c in (0, 1):  # x, y -> (hi, lo) words
                    words[2 * c, bi, :n] = anchors[:, c] >> np.uint64(32)
                    words[2 * c + 1, bi, :n] = anchors[:, c] & np.uint64(0xFFFFFFFF)
            f2, prev2 = self._rechain_wide(*words, window)
            for bi, (ri, anchors, mini_pos, mini_span) in enumerate(group):
                n = anchors.shape[0]
                qname, qseq = reads[ri]
                recs, dv, s1, s2, _ = native_postprocess(
                    anchors, f2[bi, :n], f2[bi, :n], prev2[bi, :n].astype(np.int64),
                    p2, len(qseq), self.mp.mask_level, self.mp.pri_ratio,
                    self.mp.best_n, mini_pos, mini_span, self._tlens,
                )
                results[ri] = self._format_lines(qname, len(qseq), recs, dv, s1, s2)

    def _postprocess_python(self, reads, chunk, out, results, window):
        """The general host side without the native runtime (JAX
        mapper.py:1021-1093): oracle backtrack, the rescue decision
        (lchain.rs:321-326) with a per-batch wide-band re-chain, merge,
        selection and the oracle PAF writer."""
        rescue_rows = []
        per_row: dict[int, tuple] = {}
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            if out["mini_ovf"][bi] or out["anc_ovf"][bi]:
                results[ri] = self._host_fallback(reads[ri])
                continue
            anchors = self._read_anchors(out, bi)
            n = anchors.shape[0]
            chains, scores = self._backtrack(
                anchors, out["f"][bi, :n].astype(np.int64),
                out["prev"][bi, :n].astype(np.int64), self.cp,
            )
            if not chains:
                results[ri] = []
                continue
            per_row[bi] = (anchors, chains, scores)
            best_cov = olchain.chain_query_coverage(anchors, chains[0])
            uncovered = max(len(qseq) - best_cov, 0)
            if uncovered > self.cp.rmq_rescue_size or np.float32(best_cov) < np.float32(
                len(qseq)
            ) * (np.float32(1.0) - np.float32(self.cp.rmq_rescue_ratio)):
                rescue_rows.append(bi)

        _add_stats(self.stats, "rescue_reads", len(rescue_rows))
        if rescue_rows:
            f2, prev2 = self._rechain_wide(out["x_hi"], out["x_lo"], out["y_hi"],
                                           out["y_lo"], window)
            p2 = dataclasses.replace(self.cp, bw=self.cp.bw_long)
            for bi in rescue_rows:
                anchors = per_row[bi][0]
                n = anchors.shape[0]
                chains, scores = self._backtrack(
                    anchors, f2[bi, :n].astype(np.int64),
                    prev2[bi, :n].astype(np.int64), p2,
                )
                per_row[bi] = (anchors, chains, scores)

        for bi, (anchors, chains, scores) in per_row.items():
            ri = chunk[bi]
            qname, qseq = reads[ri]
            merged = olchain.merge_adjacent_chains_with_gap(
                anchors, chains, self.cp.max_dist_y, self.cp.max_dist_y
            )
            sel, _sc, _pri, s1, s2 = olchain.select_and_filter_chains(
                anchors, merged, scores[: len(merged)],
                self.mp.mask_level, self.mp.pri_ratio, self.mp.best_n,
            )
            results[ri] = [
                line.encode()
                for line in write_paf_many_with_scores(
                    self.idx, anchors, sel, s1, s2, qname, qseq,
                    mv=self._mv_list(out, bi),
                )
            ]

    def _mv_list(self, out, bi) -> list[tuple[int, int]]:
        """Device minimizers (position-sorted) as (key_span, pos<<1|strand)
        pairs for the dv estimate, which reads only the span (the low 8
        bits, always k for a non-HPC query) and the position
        (paf.rs:158-159)."""
        n = int(out["n_mini"][bi])
        return [(self.idx.k, int(p)) for p in out["cps"][bi, :n]]

    @staticmethod
    def _backtrack(anchors, f, prev, cp):
        """Chains and scores from (f, prev) (JAX mapper.py:1105-1115): the
        native backtrack, or the oracle's without the native runtime."""
        out = native_backtrack(anchors, f, None, prev, cp)
        if out is not None:
            return out
        return olchain.backtrack(anchors, f, None, prev, cp)

    def _host_fallback(self, read) -> list[bytes]:
        """The reference-faithful host pipeline for one read."""
        _add_stats(self.stats, "host_reads", 1)
        qname, qseq = read
        return [
            line.encode()
            for line in opipeline.align_read(
                self.idx, qname, qseq, self.cp, self.mp, mid_occ=self.mid_occ
            )
        ]
