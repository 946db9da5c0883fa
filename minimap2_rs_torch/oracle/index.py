"""Reference index as flat sorted arrays.

The reference stores minimizers in 2^b buckets, each holding a
HashMap<key,(offset,count)|position> plus a positions array
(reference src/index.rs:31,74-109). Pointer-chasing hash tables do not
map to TPU/XLA, so the canonical in-memory representation here is four flat
arrays sorted by the full hashed key:

    keys[u]    : sorted distinct 2k-bit hashed minimizer keys (uint64)
    starts[u]  : offset of key u's occurrence block in `positions`
    counts[u]  : number of occurrences of key u
    positions  : rid_pos_strand values, ascending within each key block
                 (matching the reference's per-key sort, index.rs:98)

Lookup is a binary search over `keys` — O(log n) with no hashing, and the
same layout serves the device (ops/index_ops.py) via jnp.searchsorted.

The on-disk formats are preserved exactly:
- C-minimap2-compatible MMI\\x02 (index.rs:233-307, 361-424)
- the reference's native MM2RSIDX\\0 v1 (index.rs:156-230, 309-358)
and both are byte-interchangeable with the reference tool (bucket grouping
by the low b key bits is reconstructed at dump time).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import IndexParams
from ..utils.packing import nt4_encode, seq4_pack, seq4_get_subseq
from .sketch import sketch_sequence, sketch_sequence_fast


@dataclasses.dataclass
class SeqMeta:
    """Per-sequence metadata (index.rs:29)."""

    name: str | None
    offset: int
    length: int
    is_alt: bool = False


@dataclasses.dataclass
class OracleIndex:
    w: int
    k: int
    b: int
    flag: int
    n_seq: int
    seq: list[SeqMeta]
    S: np.ndarray          # uint32, 4-bit packed bases
    keys: np.ndarray       # uint64, sorted distinct hashed keys
    starts: np.ndarray     # int64
    counts: np.ndarray     # int64
    positions: np.ndarray  # uint64 rid_pos_strand

    # ---- queries -------------------------------------------------------

    def get(self, minier: int) -> np.ndarray | None:
        """Occurrences of a hashed key (index.rs:143-154); None if absent."""
        i = int(np.searchsorted(self.keys, np.uint64(minier)))
        if i >= self.keys.shape[0] or self.keys[i] != np.uint64(minier):
            return None
        s = int(self.starts[i])
        return self.positions[s : s + int(self.counts[i])]

    def get_ref_subseq(self, rid: int, st: int, en: int) -> bytes:
        """ASCII subsequence with clamping (index.rs:53-67)."""
        if rid >= len(self.seq):
            return b""
        m = self.seq[rid]
        return seq4_get_subseq(self.S, m.offset, m.length, st, en)

    def stats(self) -> tuple[int, float, float, int]:
        """(distinct keys, avg occurrences, avg spacing, total length)
        (index.rs:111-122)."""
        n_keys = int(self.keys.shape[0])
        sum_occ = int(self.counts.sum()) if n_keys else 0
        total_len = sum(s.length for s in self.seq)
        avg_occ = sum_occ / n_keys if n_keys else 0.0
        avg_spacing = total_len / sum_occ if sum_occ else 0.0
        return n_keys, avg_occ, avg_spacing, total_len

    def calc_mid_occ(self, frac: float) -> int:
        """Repetitive-seed cutoff: occurrence-count quantile + 1
        (index.rs:124-141)."""
        if self.counts.shape[0] == 0:
            return np.iinfo(np.int32).max
        srt = np.sort(self.counts)
        n = srt.shape[0]
        idx = min(int((1.0 - float(frac)) * n), n - 1)
        return int(srt[idx]) + 1

    # ---- serialization: minimap2 MMI ----------------------------------

    def save_to_mmi(self, path: str) -> None:
        """Write C-minimap2-compatible MMI\\x02 (index.rs:233-307).

        p arrays and hash entries are regrouped per bucket (low b key
        bits); within a bucket keys are written in ascending order (the
        reference's HashMap iteration order is unspecified, and both
        loaders are order-insensitive)."""
        with open(path, "wb") as f:
            f.write(b"MMI\x02")
            hdr = np.array([self.w, self.k, self.b, len(self.seq), self.flag], dtype="<u4")
            f.write(hdr.tobytes())
            sum_len = 0
            for s in self.seq:
                name = (s.name or "").encode()[:255]
                f.write(bytes([len(name)]))
                f.write(name)
                f.write(np.uint32(s.length).tobytes())
                sum_len += s.length
            for sel in self._buckets():
                p, pairs = self._bucket_records(sel)
                f.write(np.uint32(p.shape[0]).tobytes())
                f.write(p.tobytes())
                f.write(np.uint32(pairs.shape[0] // 2).tobytes())
                f.write(pairs.tobytes())
            words = (sum_len + 7) // 8
            f.write(self.S[:words].astype("<u4").tobytes())

    @staticmethod
    def load_from_mmi(path: str) -> "OracleIndex":
        """Load MMI\\x02 written by this module, the reference, or C
        minimap2 (index.rs:361-424)."""
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"MMI\x02":
            raise ValueError("invalid MMI magic")
        off = 4
        w, k, b, n_seq, flag = np.frombuffer(data, dtype="<u4", count=5, offset=off)
        off += 20
        seqs: list[SeqMeta] = []
        sum_len = 0
        for _ in range(int(n_seq)):
            nl = data[off]
            off += 1
            name = data[off : off + nl].decode(errors="replace") if nl else None
            off += nl
            ln = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
            off += 4
            seqs.append(SeqMeta(name=name, offset=sum_len, length=ln))
            sum_len += ln
        blocks = []
        for bi in range(1 << int(b)):
            n = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
            off += 4
            p = np.frombuffer(data, dtype="<u8", count=n, offset=off)
            off += 8 * n
            size = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
            off += 4
            pairs = np.frombuffer(data, dtype="<u8", count=2 * size, offset=off)
            off += 16 * size
            blocks.append(_bucket_blocks(p, pairs, int(b), bi))
        words = (sum_len + 7) // 8
        S = np.frombuffer(data, dtype="<u4", count=words, offset=off).copy()
        del data
        keys, starts, counts, positions = _flatten_blocks(blocks)
        return OracleIndex(
            w=int(w), k=int(k), b=int(b), flag=int(flag), n_seq=int(n_seq),
            seq=seqs, S=S, keys=keys, starts=starts, counts=counts,
            positions=positions,
        )

    def _buckets(self) -> list:
        """The keys of each of the 2^b buckets (low b key bits), as
        indexes in ascending key order: a stable sort by bucket keeps the
        keys ascending (on 16-bit bucket ids, numpy's radix sort)."""
        bmask = np.uint64((1 << self.b) - 1)
        buckets = (self.keys & bmask).astype(np.uint16 if self.b <= 16 else np.int64)
        order = np.argsort(buckets, kind="stable")
        bounds = np.searchsorted(buckets[order], np.arange((1 << self.b) + 1))
        return [order[bounds[bi]:bounds[bi + 1]] for bi in range(1 << self.b)]

    def _bucket_records(self, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One bucket's on-disk arrays, for the keys `sel` (ascending):
        p, the concatenated position blocks of its multi-occurrence keys
        ("<u8"), and the interleaved (hash key, value) pairs ("<u8"), a
        single-occurrence key's value its position, a multi one's
        p offset << 32 | count (index.rs:245-290)."""
        counts = self.counts[sel]
        multi = counts > 1
        p = self.positions[_block_rows(self.starts[sel[multi]], counts[multi])]
        single = ~multi
        hkeys = ((self.keys[sel] >> np.uint64(self.b)) << np.uint64(1)) | single.astype(np.uint64)
        start_p = np.zeros(sel.shape[0], dtype=np.uint64)
        cnts = counts.astype(np.uint64)
        np.cumsum(np.where(single, 0, cnts)[:-1], out=start_p[1:])
        vals = np.where(single, self.positions[self.starts[sel]],
                        (start_p << np.uint64(32)) | cnts)
        pairs = np.empty(sel.shape[0] * 2, dtype="<u8")
        pairs[0::2] = hkeys
        pairs[1::2] = vals
        return p.astype("<u8"), pairs

    # ---- serialization: native MM2RSIDX -------------------------------

    def save_to_file(self, path: str) -> None:
        """Write the reference's native format (index.rs:156-230)."""
        with open(path, "wb") as f:
            f.write(b"MM2RSIDX\0")
            f.write(np.uint32(1).tobytes())
            f.write(np.array([self.w, self.k, self.b, self.flag], dtype="<i4").tobytes())
            f.write(np.uint32(self.n_seq).tobytes())
            f.write(np.uint32(len(self.seq)).tobytes())
            for s in self.seq:
                f.write(bytes([1 if s.name is not None else 0]))
                if s.name is not None:
                    nm = s.name.encode()
                    f.write(np.uint32(len(nm)).tobytes())
                    f.write(nm)
                f.write(np.uint64(s.offset).tobytes())
                f.write(np.uint32(s.length).tobytes())
                f.write(bytes([1 if s.is_alt else 0]))
            f.write(np.uint64(self.S.shape[0]).tobytes())
            f.write(self.S.astype("<u4").tobytes())
            f.write(np.uint32(1 << self.b).tobytes())
            for sel in self._buckets():
                p, pairs = self._bucket_records(sel)
                f.write(np.uint64(p.shape[0]).tobytes())
                f.write(p.tobytes())
                f.write(bytes([1 if sel.shape[0] else 0]))
                if sel.shape[0]:
                    f.write(np.uint64(sel.shape[0]).tobytes())
                    f.write(pairs.tobytes())

    @staticmethod
    def load_from_file(path: str) -> "OracleIndex":
        """Load the native format (index.rs:309-358)."""
        with open(path, "rb") as f:
            data = f.read()
        if data[:9] != b"MM2RSIDX\0":
            raise ValueError("invalid index file magic")
        off = 9
        _ver = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
        off += 4
        w, k, b, flag = np.frombuffer(data, dtype="<i4", count=4, offset=off)
        off += 16
        n_seq_decl = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
        off += 4
        n_seq = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
        off += 4
        seqs: list[SeqMeta] = []
        for _ in range(n_seq):
            has_name = data[off] != 0
            off += 1
            name = None
            if has_name:
                nl = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
                off += 4
                name = data[off : off + nl].decode(errors="replace")
                off += nl
            so = int(np.frombuffer(data, dtype="<u8", count=1, offset=off)[0])
            off += 8
            ln = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
            off += 4
            is_alt = data[off] != 0
            off += 1
            seqs.append(SeqMeta(name=name, offset=so, length=ln, is_alt=is_alt))
        s_words = int(np.frombuffer(data, dtype="<u8", count=1, offset=off)[0])
        off += 8
        S = np.frombuffer(data, dtype="<u4", count=s_words, offset=off).copy()
        off += 4 * s_words
        nb = int(np.frombuffer(data, dtype="<u4", count=1, offset=off)[0])
        off += 4
        blocks = []
        for bi in range(nb):
            p_len = int(np.frombuffer(data, dtype="<u8", count=1, offset=off)[0])
            off += 8
            p = np.frombuffer(data, dtype="<u8", count=p_len, offset=off)
            off += 8 * p_len
            has_h = data[off] != 0
            off += 1
            if has_h:
                h_len = int(np.frombuffer(data, dtype="<u8", count=1, offset=off)[0])
                off += 8
                pairs = np.frombuffer(data, dtype="<u8", count=2 * h_len, offset=off)
                off += 16 * h_len
                blocks.append(_bucket_blocks(p, pairs, int(b), bi))
        del data
        keys, starts, counts, positions = _flatten_blocks(blocks)
        return OracleIndex(
            w=int(w), k=int(k), b=int(b), flag=int(flag), n_seq=n_seq_decl,
            seq=seqs, S=S, keys=keys, starts=starts, counts=counts,
            positions=positions,
        )


def _block_rows(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Row indexes of the blocks [starts[i], starts[i] + counts[i]) laid
    end to end (int64)."""
    counts = counts.astype(np.int64)
    off = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return np.repeat(starts.astype(np.int64) - off[:-1], counts) + np.arange(
        off[-1], dtype=np.int64)


def _bucket_blocks(p: np.ndarray, pairs: np.ndarray, b: int, bi: int):
    """One bucket of an index file read back (index.rs:376-410): its full
    keys in file order, each key's occurrence count, and the positions of
    every key laid end to end in that order (a single-occurrence key's
    is its value, a multi one's the block of p its value addresses)."""
    hkeys, vals = pairs[0::2], pairs[1::2]
    full = ((hkeys >> np.uint64(1)) << np.uint64(b)) | np.uint64(bi)
    single = (hkeys & np.uint64(1)) == 1
    cnts = np.where(single, 1, vals & np.uint64(0xFFFFFFFF)).astype(np.int64)
    src_start = np.where(single, 0, vals >> np.uint64(32)).astype(np.int64)
    # the singles' values go after p, so one gather reads every block
    src_start[single] = p.shape[0] + np.arange(int(single.sum()), dtype=np.int64)
    src = np.concatenate([p, vals[single]])
    return full, cnts, src[_block_rows(src_start, cnts)]


def _flatten_blocks(blocks: list):
    """_flatten of the pairs that index-file buckets hold, as
    [(keys, counts, positions laid end to end)]. Where the keys are
    distinct and each key's positions ascend (every file this module,
    the reference or C minimap2 writes: index.rs:98), one sort of the
    keys orders the blocks; otherwise the pairs are sorted whole. Empties
    `blocks` as it goes, so that a large index is held once."""
    bkeys = np.concatenate([k for k, _c, _p in blocks]) if blocks else np.zeros(0, np.uint64)
    bcounts = np.concatenate([c for _k, c, _p in blocks]) if blocks else np.zeros(0, np.int64)
    bpos = np.concatenate([p for _k, _c, p in blocks]) if blocks else np.zeros(0, np.uint64)
    del blocks[:]
    order = np.argsort(bkeys)
    keys, counts = bkeys[order], bcounts[order]
    if keys.shape[0] and (keys[1:] != keys[:-1]).all() and (counts > 0).all():
        src = np.zeros(bcounts.shape[0], dtype=np.int64)
        np.cumsum(bcounts[:-1], out=src[1:])
        positions = bpos[_block_rows(src[order], counts)]
        starts = np.zeros(counts.shape[0], dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        ascend = positions[1:] >= positions[:-1]
        ascend[starts[1:] - 1] = True  # across a block boundary
        if ascend.all():
            return keys, starts, counts, positions
    return _flatten(np.repeat(bkeys, bcounts), bpos)


def _flatten(mkeys: np.ndarray, mpos: np.ndarray, presorted: bool = False):
    """Sort (key, value) pairs and compress into flat index arrays. The
    value sort within a key block matches the reference's per-key
    sort_unstable (index.rs:98). presorted=True skips the lexsort (the
    device build returns globally sorted pairs)."""
    if mkeys.shape[0] == 0:
        z64 = np.zeros(0, dtype=np.uint64)
        zi = np.zeros(0, dtype=np.int64)
        return z64, zi, zi.copy(), z64.copy()
    if presorted:
        sk, sp = mkeys, mpos
    else:
        order = np.lexsort((mpos, mkeys))
        sk = mkeys[order]
        sp = mpos[order]
    boundary = np.empty(sk.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = sk[1:] != sk[:-1]
    starts = np.nonzero(boundary)[0].astype(np.int64)
    keys = sk[starts]
    counts = np.diff(np.append(starts, sk.shape[0])).astype(np.int64)
    return keys, starts, counts, sp


def build_index(
    records: list[tuple[str | None, bytes]],
    params: IndexParams = IndexParams(),
    use_fast_sketch: bool = True,
) -> OracleIndex:
    """Build an index from (name, sequence) records
    (build_index_from_fasta, index.rs:427-475). The fast vectorized sketch
    is used for odd k (set-exact); even k falls back to the exact scan."""
    w, k, b, flag = params.w, params.k, params.bucket_bits, params.flag
    is_hpc = params.is_hpc
    seqs: list[SeqMeta] = []
    key_chunks: list[np.ndarray] = []
    pos_chunks: list[np.ndarray] = []
    sum_len = 0
    packed: list[np.ndarray] = []
    for rid, (name, seq) in enumerate(records):
        if len(seq):
            if use_fast_sketch and (k % 2 == 1):
                recs = sketch_sequence_fast(seq, w, k, rid=rid, is_hpc=is_hpc)
            else:
                lst = sketch_sequence(seq, w, k, rid=rid, is_hpc=is_hpc)
                recs = np.array(lst, dtype=np.uint64).reshape(-1, 2)
            if recs.shape[0]:
                key_chunks.append(recs[:, 0] >> np.uint64(8))
                pos_chunks.append(recs[:, 1])
        seqs.append(SeqMeta(name=name, offset=sum_len, length=len(seq)))
        sum_len += len(seq)
    # pack all sequences contiguously; offsets are per-base so sequences
    # share words at boundaries (index.rs:461-465)
    codes = np.concatenate([nt4_encode(s) for _, s in records]) if records else np.zeros(0, np.uint8)
    S = seq4_pack(codes)
    del packed
    mkeys = np.concatenate(key_chunks) if key_chunks else np.zeros(0, dtype=np.uint64)
    mpos = np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, dtype=np.uint64)
    keys, starts, counts, positions = _flatten(mkeys, mpos)
    return OracleIndex(
        w=w, k=k, b=b, flag=flag, n_seq=len(records), seq=seqs, S=S,
        keys=keys, starts=starts, counts=counts, positions=positions,
    )
