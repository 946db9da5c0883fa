"""Index construction for the port: the reference package's threaded
native C++ build, with no jax (counterpart of
minimap2_rs_tpu/models/index_builder.build_index_native)."""

from __future__ import annotations

import numpy as np

from minimap2_rs_tpu.config import IndexParams
from minimap2_rs_tpu.oracle.index import OracleIndex, SeqMeta, build_index


def build_index_native(
    records: list[tuple[str | None, bytes]],
    params: IndexParams = IndexParams(),
    n_threads: int | None = None,
) -> OracleIndex:
    """Threaded C++ exact-scan build (runtime.host.native_build_index);
    the host NumPy build when the native library is absent."""
    from minimap2_rs_tpu.runtime.host import native_build_index

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
