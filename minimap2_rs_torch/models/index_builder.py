"""Index construction for the port (counterpart of
minimap2_rs_tpu/models/index_builder.py), with no jax: the port's
threaded native C++ build (runtime/host.py), and the chunked device
build (ops/index_build.py) on an explicit device. Both give the same
flat sorted-array OracleIndex."""

from __future__ import annotations

import numpy as np
import torch

from ..config import IndexParams
from ..device import resolve_device
from ..oracle.index import OracleIndex, SeqMeta, _flatten, build_index
from ..runtime.host import native_build_index
from ..utils.packing import nt4_encode, seq4_pack


def build_index_native(
    records: list[tuple[str | None, bytes]],
    params: IndexParams = IndexParams(),
    n_threads: int | None = None,
) -> OracleIndex:
    """Threaded C++ exact-scan build (runtime.host.native_build_index);
    the host NumPy build when the native library is absent."""
    raw = b"".join(bytes(s) for _n, s in records)
    seq_off = np.zeros(len(records) + 1, dtype=np.int64)
    np.cumsum([len(s) for _n, s in records], out=seq_off[1:])
    out = native_build_index(
        raw, seq_off, params.w, params.k, params.is_hpc, is_ascii=True,
        n_threads=n_threads,
    )
    if out is None:
        return build_index(records, params)
    fkeys, starts, counts, positions, S = out
    seqs: list[SeqMeta] = []
    off = 0
    for name, s in records:
        seqs.append(SeqMeta(name=name, offset=off, length=len(s)))
        off += len(s)
    return OracleIndex(
        w=params.w, k=params.k, b=params.bucket_bits, flag=params.flag,
        n_seq=len(records), seq=seqs, S=S,
        keys=fkeys, starts=starts, counts=counts, positions=positions,
    )


def build_index_device(
    records: list[tuple[str | None, bytes]],
    params: IndexParams = IndexParams(),
    chunk: int = 1 << 18,
    batch_rows: int = 16,
    device: str | torch.device = "cuda",
) -> OracleIndex:
    """The index with the sketch and the pair sort on `device` (JAX
    build_index_device, index_builder.py:57-85). Even k takes the host
    exact-scan build, as the JAX function does."""
    if params.k % 2 == 0:
        return build_index(records, params, use_fast_sketch=False)
    from ..ops.index_build import build_sorted_pairs_device

    dev = resolve_device(device)
    recs = [(rid, nt4_encode(s)) for rid, (_n, s) in enumerate(records)]
    keys, rps = build_sorted_pairs_device(
        recs, params.w, params.k, params.is_hpc, chunk=chunk,
        batch_rows=batch_rows, device=dev,
    )
    seqs: list[SeqMeta] = []
    off = 0
    for name, s in records:
        seqs.append(SeqMeta(name=name, offset=off, length=len(s)))
        off += len(s)
    codes = np.concatenate([c for _, c in recs]) if recs else np.zeros(0, np.uint8)
    del recs
    fkeys, starts, counts, positions = _flatten(keys, rps, presorted=True)
    return OracleIndex(
        w=params.w, k=params.k, b=params.bucket_bits, flag=params.flag,
        n_seq=len(records), seq=seqs, S=seq4_pack(codes),
        keys=fkeys, starts=starts, counts=counts, positions=positions,
    )
