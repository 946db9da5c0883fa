"""Device-side index construction in PyTorch.

Counterpart of minimap2_rs_tpu/ops/index_build.py. Long sequences are
cut into fixed-size chunks with (w+k)-base halos on both sides; each
chunk row runs the batched sketch and keeps only the records whose
position falls in its owned range, and the halos make the owned
emissions equal the whole-sequence scan's (see the JAX module's
docstring for the argument). The sequence-end flush fires only on each
sequence's true last chunk (emit_final).

The result is the (key, rid_pos_strand) pair array sorted
lexicographically — the order of the reference's per-key position sort
(index.rs:79,98) — which oracle/index._flatten turns into the flat
index. `plan_chunks` is a copy of the JAX module's (that module imports
jax). Keys (< 2^56 once the span byte is dropped) and rid<<32 |
pos<<1 | strand words (rid < 2^31) are non-negative int64, so two stable
sorts order the pairs as the JAX package's uint32-plane sort does.
"""

from __future__ import annotations

import numpy as np
import torch

from .sketch import INV32, ks_keys, sketch_positions

SENTINEL = (1 << 63) - 1  # padding of the flat buffers; sorts last


def plan_chunks(seq_lens: list[int], chunk: int, w: int, k: int):
    """Chunking plan: list of (rid, seq_off, own_start, own_len, halo_left,
    content_len, is_last). own region = [own_start, own_start + own_len)
    in sequence coordinates."""
    halo = w + k
    plan = []
    for rid, L in enumerate(seq_lens):
        pos = 0
        while pos < L or (L > 0 and pos == 0):
            own_len = min(chunk, L - pos)
            left = min(halo, pos)
            is_last = pos + own_len >= L
            right = 0 if is_last else min(halo, L - (pos + own_len))
            content = left + own_len + right
            plan.append((rid, pos - left, pos, own_len, left, content, is_last))
            pos += own_len
            if pos >= L:
                break
    return plan


def sketch_chunk_flat(
    codes: torch.Tensor,       # (B, C) nt4 codes (chunk content incl. halos)
    content: torch.Tensor,     # (B,) content lengths
    own_start: torch.Tensor,   # (B,) local start of the owned range
    own_len: torch.Tensor,     # (B,) owned length
    seq_off: torch.Tensor,     # (B,) sequence coordinate of local position 0
    rid: torch.Tensor,         # (B,) sequence ids
    emit_final: torch.Tensor,  # (B,) bool
    w: int,
    k: int,
    is_hpc: bool,
    max_out: int,
):
    """Sketch chunk rows, keep the owned emissions, convert them to
    global coordinates, and compact the whole batch into two flat
    (max_out,) int64 buffers, stably (row-major order), padded with
    SENTINEL. Returns (keys, rid_pos_strand, n_total, overflow); keys
    have the span byte dropped (index.rs:71)."""
    B, C = codes.shape
    dev = codes.device
    ks, ps, emitted = sketch_positions(codes, content, w, k, is_hpc, emit_final)
    idx = torch.arange(C, device=dev)
    own_start = own_start.to(torch.int64)[:, None]
    owned = (idx >= own_start) & (idx < own_start + own_len.to(torch.int64)[:, None])
    em = (emitted & owned).reshape(-1)
    gpos = (ps + (seq_off.to(torch.int64)[:, None] << 1)) & INV32
    rps = (rid.to(torch.int64)[:, None] << 32) | gpos
    dest = em.to(torch.int64).cumsum(0) - 1
    dest = torch.where(em & (dest < max_out), dest, max_out)
    out = torch.full((2, max_out + 1), SENTINEL, dtype=torch.int64, device=dev)
    out[0].scatter_(0, dest, ks_keys(ks).reshape(-1))
    out[1].scatter_(0, dest, rps.reshape(-1))
    n = em.sum()
    return out[0, :max_out], out[1, :max_out], n, n > max_out


def sort_minimizer_pairs(keys: torch.Tensor, rps: torch.Tensor):
    """Sort flat (key, rid_pos_strand) pairs by key, then by value —
    two stable sorts, least significant first. SENTINEL padding lands
    at the end."""
    order = rps.sort(stable=True).indices
    keys, rps = keys[order], rps[order]
    order = keys.sort(stable=True).indices
    return keys[order], rps[order]


def build_sorted_pairs_device(
    records: list[tuple[int, np.ndarray]],  # (rid, nt4 codes)
    w: int,
    k: int,
    is_hpc: bool = False,
    chunk: int = 1 << 18,
    batch_rows: int = 16,
    *,
    device: str | torch.device,
) -> tuple[np.ndarray, np.ndarray]:
    """Sketch all sequences on `device`, chunked; returns host uint64
    arrays (keys, rid_pos_strand) sorted by (key, value). The batches
    stay on the device, one sort runs there, and one copy a word brings
    the result back. Raises when a batch overflows its flat buffer."""
    halo = w + k
    C = chunk + 2 * halo
    # minimizer density is ~2/(w+1) ~= 0.18 at w=10; 0.3 is a safe cap
    # for the batch-flat buffer (overflow is detected and raises)
    max_out = int(batch_rows * C * 0.3) // 8 * 8
    plan = plan_chunks([len(c) for _, c in records], chunk, w, k)
    keys, vals, ns, ovfs = [], [], [], []
    for b0 in range(0, len(plan), batch_rows):
        rows = plan[b0 : b0 + batch_rows]
        B = batch_rows
        codes = np.full((B, C), 4, dtype=np.uint8)
        cols = np.zeros((6, B), dtype=np.int64)  # content, own_start, own_len, seq_off, rid, final
        for bi, (rid, arr_start, _own0, olen, left, clen, is_last) in enumerate(rows):
            codes[bi, :clen] = records[rid][1][arr_start : arr_start + clen]
            cols[:, bi] = (clen, left, olen, arr_start, records[rid][0], is_last)
        d = torch.from_numpy(cols).to(device)
        kk, vv, n, ovf = sketch_chunk_flat(
            torch.from_numpy(codes).to(device), d[0], d[1], d[2], d[3], d[4],
            d[5] != 0, w, k, is_hpc, max_out,
        )
        keys.append(kk)
        vals.append(vv)
        ns.append(n)
        ovfs.append(ovf)
    if not keys:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    if bool(torch.stack(ovfs).any()):
        raise RuntimeError("minimizer overflow in index chunk; raise max_out")
    # each batch's records without its padding, and the batches freed
    # before the sort, which then holds the pairs about three times over
    # (a 3.1 Gbp genome has 0.59 G pairs in 0.94 G slots)
    ns = torch.stack(ns).tolist()
    flat_keys = torch.cat([kk[:n] for kk, n in zip(keys, ns)])
    flat_vals = torch.cat([vv[:n] for vv, n in zip(vals, ns)])
    del keys, vals
    skeys, svals = sort_minimizer_pairs(flat_keys, flat_vals)
    del flat_keys, flat_vals
    # both words are non-negative int64: the uint64 view is the value
    return skeys.cpu().numpy().view(np.uint64), svals.cpu().numpy().view(np.uint64)
