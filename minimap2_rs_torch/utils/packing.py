"""Base encoding and 4-bit sequence packing (host side, vectorized NumPy).

Contracts reproduced:
- nt4 ASCII->2-bit code, A=0 C=1 G=2 T=3, anything else 4
  (reference src/nt4.rs:2-10).
- 4-bit packed reference storage S: 8 bases per u32, base at global offset
  o lives in word o>>3 at nibble shift (o&7)*4
  (reference src/index.rs:14-26).

The reference packs with a scalar per-base loop (index.rs:461-465); here the
pack/unpack are whole-array NumPy bit ops, which is the idiomatic host-side
formulation (and ~1000x faster than a Python loop).
"""

from __future__ import annotations

import numpy as np

# ASCII -> nt4 code lookup table (256 entries).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    NT4_TABLE[ord(_ch)] = _code
    NT4_TABLE[ord(_ch.lower())] = _code


def nt4_encode(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 array of nt4 codes (0..4)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return NT4_TABLE[arr]


def seq4_pack(codes: np.ndarray, total_words: int | None = None) -> np.ndarray:
    """Pack nt4 codes (0..4, one per base) into the 4-bit u32 layout of
    index.rs:14-19. `total_words` optionally rounds the output up (zeros)."""
    n = codes.shape[0]
    words = (n + 7) // 8
    if total_words is None:
        total_words = words
    padded = np.zeros(words * 8, dtype=np.uint8)
    padded[:n] = codes
    # two bases a byte, the even one in the low nibble, and four bytes a
    # little-endian word: base o lands at nibble o & 7 of word o >> 3, in
    # about a byte and a half per base of working memory
    out = np.zeros(total_words, dtype=np.uint32)
    out[:words] = (padded[0::2] | (padded[1::2] << np.uint8(4))).view("<u4")
    return out


def seq4_unpack(S: np.ndarray, start: int, end: int) -> np.ndarray:
    """Extract nt4 codes for global offsets [start, end) from the packed
    array (index.rs:21-26)."""
    if end <= start:
        return np.zeros(0, dtype=np.uint8)
    offs = np.arange(start, end, dtype=np.int64)
    words = S[offs >> 3]
    shifts = ((offs & 7) << 2).astype(np.uint32)
    return ((words >> shifts) & 0xF).astype(np.uint8)


_CODE_TO_ASCII = np.frombuffer(b"ACGT" + b"N" * 12, dtype=np.uint8)


def seq4_get_subseq(S: np.ndarray, offset: int, seq_len: int, st: int, en: int) -> bytes:
    """ASCII subsequence [st, en) of a sequence stored at `offset` with
    length `seq_len`, clamped like Index::get_ref_subseq (index.rs:53-67)."""
    st0 = max(st, 0)
    en0 = max(min(en, seq_len), 0)
    if st0 >= en0:
        return b""
    codes = seq4_unpack(S, offset + st0, offset + en0)
    return _CODE_TO_ASCII[codes].tobytes()
