"""ctypes bindings for the port's native host runtime (libmm2t_host.so).

The port's own copy of minimap2_rs_tpu/runtime/host.py, over its own
copy of the C++ source (native/mm2t_host.cpp). The library is compiled
from that source with g++ at first use into
<checkout>/build/host/libmm2t_host.so (`build()`), and rebuilt when the
source is newer. Every entry point has a pure-Python fallback in the
oracle package, used when the library cannot be built or loaded:
`native_available()` says which runs, and a caller that must run the
native path (chip_smoke.py) checks it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "mm2t_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
LIB_NAME = "libmm2t_host.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_LIB = None
_TRIED = False


class _ChainParamsC(ctypes.Structure):
    _fields_ = [
        ("max_dist_x", ctypes.c_int32),
        ("max_dist_y", ctypes.c_int32),
        ("bw", ctypes.c_int32),
        ("max_chain_iter", ctypes.c_int32),
        ("min_chain_score", ctypes.c_int32),
        ("min_cnt", ctypes.c_int32),
        ("max_chain_skip", ctypes.c_int32),
        ("max_drop", ctypes.c_int32),
        ("chn_pen_gap", ctypes.c_float),
        ("chn_pen_skip", ctypes.c_float),
        ("rmq_rescue_size", ctypes.c_int32),
        ("rmq_rescue_ratio", ctypes.c_float),
    ]


def _params_c(p) -> _ChainParamsC:
    return _ChainParamsC(
        p.max_dist_x, p.max_dist_y, p.bw, p.max_chain_iter,
        p.min_chain_score, p.min_cnt, p.max_chain_skip, p.max_drop,
        p.chn_pen_gap, p.chn_pen_skip,
        p.rmq_rescue_size, p.rmq_rescue_ratio,
    )


def _enable_heap_reuse():
    """Route large malloc/numpy allocations through brk instead of mmap
    and never trim the heap (mallopt M_MMAP_THRESHOLD / M_TRIM_THRESHOLD).

    Freed mmap chunks are unmapped immediately, so every index-build or
    mapping pass re-faults hundreds of MB of buffers — and page faults
    cost ~36 us each on the host BENCH_r03 was measured on, which made
    the 100 Mbp build's wall time swing 3x pass-to-pass. With brk reuse the pages stay mapped: steady-state
    passes allocate fault-free. Cost: the process high-water heap is
    kept (a few hundred MB at genome scale)."""
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, -1)       # M_TRIM_THRESHOLD
    except Exception:
        pass


def build() -> Path:
    """Compile native/mm2t_host.cpp into BUILD_DIR (if missing or older
    than the source); returns the library's path. Each process writes
    its own temporary file and renames it into place, so concurrent
    builds (test workers) never load a half-written library."""
    out = BUILD_DIR / LIB_NAME
    if out.exists() and out.stat().st_mtime >= SRC.stat().st_mtime:
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    _enable_heap_reuse()
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        import warnings

        warnings.warn(f"native host runtime unavailable ({e}); using the "
                      "pure-Python paths", RuntimeWarning, stacklevel=2)
        return None
    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")

    lib.mm2t_sketch.restype = ctypes.c_int64
    lib.mm2t_sketch.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_int32, u64p, ctypes.c_int64,
    ]
    lib.mm2t_chain_dp.restype = None
    lib.mm2t_chain_dp.argtypes = [
        u64p, u64p, ctypes.c_int64, ctypes.POINTER(_ChainParamsC),
        i32p, i32p, i64p,
    ]
    lib.mm2t_backtrack.restype = ctypes.c_int64
    lib.mm2t_backtrack.argtypes = [
        u64p, u64p, ctypes.c_int64, i32p, i32p, i64p,
        ctypes.POINTER(_ChainParamsC), i64p, ctypes.c_int64,
        i64p, i64p, i64p, ctypes.c_int64,
    ]
    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.mm2t_postprocess.restype = ctypes.c_int64
    lib.mm2t_postprocess.argtypes = [
        u64p, u64p, ctypes.c_int64,               # ax, ay, n
        i32p, i32p, i64p,                         # f, v, prev
        ctypes.POINTER(_ChainParamsC), ctypes.c_int32,  # params, qlen
        ctypes.c_float, ctypes.c_float, ctypes.c_int64, # mask, pri, best_n
        i32p, i32p, ctypes.c_int64,               # mini_pos, mini_span, n_mini
        i32p, ctypes.c_int64,                     # tlens, n_seq
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),  # skip_output, rescue
        i64p, f64p, ctypes.c_int64,               # out_fields, out_dv, cap
    ]
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    lib.mm2t_encode_pack4.restype = None
    lib.mm2t_encode_pack4.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64p,
        ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.mm2t_encode_pack2.restype = ctypes.c_int64
    lib.mm2t_encode_pack2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64p,
        ctypes.c_int64, ctypes.c_int64, u8p, i32p, ctypes.c_int64,
    ]
    lib.mm2t_format_lite.restype = ctypes.c_int64
    lib.mm2t_format_lite.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, f32p,
        i32p, u8p, i64p, u8p, i64p, i32p,
        ctypes.c_int32, i32p, u8p, ctypes.c_int64, i64p,
    ]
    lib.mm2t_powf.restype = None
    lib.mm2t_powf.argtypes = [f32p, f32p, f32p, ctypes.c_int64]
    lib.mm2t_mmi_selfcheck.restype = ctypes.c_int64
    lib.mm2t_mmi_selfcheck.argtypes = [u8p, ctypes.c_int64]
    lib.mm2t_build_pairs.restype = ctypes.c_int64
    lib.mm2t_build_pairs.argtypes = [
        u8p, i64p, ctypes.c_int64,                     # codes, seq_off, n_seq
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # w, k, is_hpc
        ctypes.c_int32, ctypes.c_int64,                # n_threads, chunk
        u64p, u64p, ctypes.c_int64,                    # out_keys, out_rps, cap
    ]
    lib.mm2t_get_build_stage_s.restype = None
    lib.mm2t_get_build_stage_s.argtypes = [f64p]
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    lib.mm2t_build_index.restype = ctypes.c_int64
    lib.mm2t_build_index.argtypes = [
        u8p, i64p, ctypes.c_int64,                     # seq, seq_off, n_seq
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # w, k, is_hpc
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,  # is_ascii, n_threads, chunk
        u64p, u64p, ctypes.c_int64, u32p,              # out_keys, out_rps, cap, out_S
        u64p, i64p, i64p, ctypes.POINTER(ctypes.c_int64),  # flat table outs
    ]
    _LIB = lib
    return _LIB


def last_build_stage_s() -> dict | None:
    """Seconds of each stage ({scan, pack, sort, flatten}) of this
    process's most recent native index build, rounded to 1 ms, or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(4, dtype=np.float64)
    lib.mm2t_get_build_stage_s(out)
    return {name: round(float(v), 3)
            for name, v in zip(("scan", "pack", "sort", "flatten"), out)}


def native_build_pairs(
    codes: np.ndarray, seq_off: np.ndarray, w: int, k: int,
    is_hpc: bool = False, n_threads: int | None = None,
    chunk: int = 1 << 22,
):
    """Threaded exact-scan index build (the reference's rayon region,
    index.rs:442-452) of concatenated nt4 `codes` with int64 per-sequence
    offsets `seq_off` (n_seq + 1): (keys, rid_pos_strand) uint64 arrays
    sorted by (key, rps), or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = max(1, os.cpu_count() or 1)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    n_seq = seq_off.shape[0] - 1

    def run(cap):
        keys = np.empty(cap, dtype=np.uint64)
        rps = np.empty(cap, dtype=np.uint64)
        n = lib.mm2t_build_pairs(codes, seq_off, n_seq, w, k, int(is_hpc),
                                 int(n_threads), chunk, keys, rps, cap)
        return n, keys, rps

    # minimizer density ~2/(w+1); 0.3 a base is a generous first guess
    n, keys, rps = run(max(int(codes.shape[0] * 0.3) + 1024, 1 << 12))
    if n < 0:
        raise ValueError("invalid build parameters")
    if n > keys.shape[0]:
        n, keys, rps = run(n)
    return keys[:n], rps[:n]


def native_mmi_selfcheck(path_or_bytes) -> int | None:
    """Parse an MMI\\x02 file on its own (a C++ transcription of
    index.rs:361-424, apart from the Python serializer) and check that its
    hash table equals the minimizers re-sketched from its packed
    sequences. Returns 0 on success, a negative stage code on failure
    (runtime/native/mm2t_host.cpp), or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        data = Path(path_or_bytes).read_bytes()
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(lib.mm2t_mmi_selfcheck(arr, arr.shape[0]))


def _madv_huge(arr: np.ndarray) -> np.ndarray:
    """Advise transparent huge pages for a fresh large allocation: the
    native build faults these pages in while writing its outputs, and
    4 KiB first-touch faults (~10 us each) were the dominant — and
    wildly variable — cost of the 100 Mbp build (BENCH_r03
    large_index_build_pass_times_s spread 3.2x). THP cuts the fault
    count 512x."""
    if arr.nbytes < (1 << 22):
        return arr
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        addr = arr.ctypes.data
        # round the start UP to the first 2 MiB boundary inside the
        # array: advising the boundary below would cover bytes before
        # the allocation — the whole call fails with ENOMEM if that
        # preceding page is unmapped, and touches unrelated allocations
        # when it is mapped
        base = (addr + (1 << 21) - 1) & ~((1 << 21) - 1)
        length = arr.nbytes - (base - addr)
        if length > 0:
            # MADV_HUGEPAGE == 14 on linux
            libc.madvise(ctypes.c_void_p(base), ctypes.c_size_t(length), 14)
    except Exception:
        pass
    return arr


_KEYS_POOL: list[np.ndarray] = []  # grow-only scratch (never escapes)


def native_build_index(
    seq: bytes | np.ndarray, seq_off: np.ndarray, w: int, k: int,
    is_hpc: bool = False, is_ascii: bool = True,
    n_threads: int | None = None, chunk: int | None = None,
):
    """One-call index build from RAW sequence bytes: threaded exact scan
    with direct per-key-range partitioning + in-cache range sorts +
    4-bit sequence packing + flat-table compression, all in C++ —
    nothing round-trips through NumPy. Returns
    (ukeys, starts, counts, positions, S): the flattened sorted-array
    index (oracle/index.py _flatten contract) plus the packed u32
    sequence words (index.rs:14-26,461-465), or None when the library
    lacks the entry point.

    The non-unique sorted-keys scratch (the largest buffer, ~8 bytes per
    minimizer) is pooled across calls — it never escapes, and re-faulting
    it every build dominated wall time at genome scale."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = max(1, os.cpu_count() or 1)
    arr = (np.frombuffer(seq, dtype=np.uint8)
           if isinstance(seq, (bytes, bytearray))
           else np.ascontiguousarray(seq, dtype=np.uint8))
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    n_seq = seq_off.shape[0] - 1
    total_len = int(seq_off[-1])
    if chunk is None:
        # balance the scan: a fixed 4 Mb chunk leaves a 5 Mbp genome as
        # 2 lopsided pieces for 2 threads (one thread scans 4/5 of the
        # genome — ~35 ms of the small-build gap vs the C anchor);
        # ~8 pieces per thread keeps the work-stealing queue fed while
        # the 512 kb floor bounds per-piece halo/dispatch overhead
        chunk = min(1 << 22, max(total_len // (8 * n_threads), 1 << 19))
    S = _madv_huge(np.empty((total_len + 7) // 8, dtype=np.uint32))
    # minimizer density is ~2/(w+1); size outputs tightly (the re-call
    # path below covers the rare overflow) — page-fault volume on these
    # fresh arrays is a first-order cost at genome scale
    cap = max(int(total_len * 2.3 / (w + 1)) + 65536, 1 << 12)

    def _keys_scratch(cap):
        if not _KEYS_POOL or _KEYS_POOL[0].shape[0] < cap:
            _KEYS_POOL.clear()
            _KEYS_POOL.append(_madv_huge(np.empty(cap, dtype=np.uint64)))
        return _KEYS_POOL[0]

    def _run(cap):
        keys = _keys_scratch(cap)
        rps = _madv_huge(np.empty(cap, dtype=np.uint64))
        ukeys = _madv_huge(np.empty(cap, dtype=np.uint64))
        starts = _madv_huge(np.empty(cap, dtype=np.int64))
        counts = _madv_huge(np.empty(cap, dtype=np.int64))
        nk = ctypes.c_int64(0)
        n = lib.mm2t_build_index(
            arr, seq_off, n_seq, w, k, int(is_hpc), int(is_ascii),
            int(n_threads), chunk, keys, rps, cap, S,
            ukeys, starts, counts, ctypes.byref(nk),
        )
        return n, keys, rps, ukeys, starts, counts, int(nk.value)

    n, keys, rps, ukeys, starts, counts, nk = _run(cap)
    if n < 0:
        raise ValueError("invalid build parameters")
    if n > cap:
        n, keys, rps, ukeys, starts, counts, nk = _run(n)
    return ukeys[:nk], starts[:nk], counts[:nk], rps[:n], S


def native_postprocess(
    anchors: np.ndarray, f, v, prev, cp, qlen: int,
    mask_level: float, pri_ratio: float, best_n: int,
    mini_pos: np.ndarray, mini_span: np.ndarray, tlens: np.ndarray,
    skip_output: bool = False,
):
    """Full host postprocess for one read: backtrack + merge + select +
    PAF numeric fields + dv. Returns (records, s1, s2, rescue_flag) where
    records is an (m, 9) int64 array [qs,qe,ts,te,cm,rid,rev,is_primary,
    score] with a parallel dv float array — or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = anchors.shape[0]
    rescue = ctypes.c_int32(0)
    if n == 0:
        return (np.zeros((0, 9), np.int64), np.zeros(0), 0, 0, False)
    ax = np.ascontiguousarray(anchors[:, 0], dtype=np.uint64)
    ay = np.ascontiguousarray(anchors[:, 1], dtype=np.uint64)
    cap = n + 2
    out_fields = np.zeros(9 * cap, dtype=np.int64)
    out_dv = np.zeros(cap, dtype=np.float64)
    m = lib.mm2t_postprocess(
        ax, ay, n,
        np.ascontiguousarray(f, dtype=np.int32),
        np.ascontiguousarray(v, dtype=np.int32),
        np.ascontiguousarray(prev, dtype=np.int64),
        ctypes.byref(_params_c(cp)), qlen,
        mask_level, pri_ratio, best_n,
        np.ascontiguousarray(mini_pos, dtype=np.int32),
        np.ascontiguousarray(mini_span, dtype=np.int32),
        int(mini_pos.shape[0]),
        np.ascontiguousarray(tlens, dtype=np.int32), int(tlens.shape[0]),
        int(skip_output), ctypes.byref(rescue),
        out_fields, out_dv, cap,
    )
    recs = out_fields[: 9 * m].reshape(m, 9)
    s1 = int(out_fields[9 * m]) if m < cap else 0
    s2 = int(out_fields[9 * m + 1]) if m < cap else 0
    return recs, out_dv[:m], s1, s2, bool(rescue.value)


def native_available() -> bool:
    return _load() is not None


def native_encode_pack4(seqs: list[bytes], Lpack: int) -> np.ndarray | None:
    """(B, Lpack) uint8 rows of 4-bit-packed nt4 codes (0x44 padding)
    straight from raw read bytes — the H2D wire format. None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    B = len(seqs)
    ptrs = (ctypes.c_char_p * B)(*seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=B)
    out = np.empty((B, Lpack), dtype=np.uint8)
    lib.mm2t_encode_pack4(ptrs, lens, B, Lpack, out)
    return out


def native_encode_pack2(seqs: list[bytes], Lpack2: int, nex_cap: int):
    """2-bit H2D wire: ((B, Lpack2) uint8 rows of 4 codes/byte,
    (nex_cap,) int32 flat N-exception indices padded with B*4*Lpack2).
    None when the library is unavailable OR the batch holds more than
    nex_cap ambiguous bases (caller falls back to the 4-bit wire)."""
    lib = _load()
    if lib is None:
        return None
    B = len(seqs)
    ptrs = (ctypes.c_char_p * B)(*seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=B)
    out = np.empty((B, Lpack2), dtype=np.uint8)
    nex = np.full(max(nex_cap, 1), B * 4 * Lpack2, dtype=np.int32)
    n = lib.mm2t_encode_pack2(ptrs, lens, B, Lpack2, out, nex, nex_cap)
    if n > nex_cap:
        return None
    return out, nex


_LITE_COLS = [
    "qs", "qe", "ts", "te", "grp", "score", "cm", "n_anchors",
    "mini_ovf", "anc_ovf", "win_ovf",
]


def native_format_lite(
    fields: np.ndarray,  # (B, F) int32 lite field rows
    dv: np.ndarray,      # (B,) float32
    qlens: np.ndarray,   # (B,) int32
    qnames: list[bytes],
    tname_blob: bytes, tname_off: np.ndarray, tlens: np.ndarray,
    mapq: int, col_of: dict,
):
    """Format PAF lines for every clean row in one call. Returns
    (blob: bytes, line_off: (B+1,) int64) — row i's line is
    blob[line_off[i]:line_off[i+1]] (empty = no output: overflow or no
    anchors; the caller resolves which). None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    B, F = fields.shape
    qname_blob = b"".join(qnames)
    qname_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(n) for n in qnames], out=qname_off[1:])
    col = np.array([col_of[c] for c in _LITE_COLS], dtype=np.int32)
    cap = len(qname_blob) + B * 224 + len(tname_blob) + 1024
    out = np.empty(cap, dtype=np.uint8)
    line_off = np.empty(B + 1, dtype=np.int64)
    total = lib.mm2t_format_lite(
        np.ascontiguousarray(fields, dtype=np.int32), B, F,
        np.ascontiguousarray(dv, dtype=np.float32),
        np.ascontiguousarray(qlens, dtype=np.int32),
        np.frombuffer(qname_blob, dtype=np.uint8) if qname_blob else np.zeros(1, np.uint8),
        qname_off,
        np.frombuffer(tname_blob, dtype=np.uint8) if tname_blob else np.zeros(1, np.uint8),
        np.ascontiguousarray(tname_off, dtype=np.int64),
        np.ascontiguousarray(tlens, dtype=np.int32),
        mapq, col, out, cap, line_off,
    )
    if total < 0:
        return None  # capacity miss (absurdly long names); Python path
    return out[:total].tobytes(), line_off


def powf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """x ** y elementwise in float32 as libm's powf gives it (minimap2_rs's
    f32::powf): the native runtime's loop, else NumPy's scalar float32
    power, which calls powf. NumPy's array power may not: its AVX-512
    kernel is an ulp off for about a tenth of inputs."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.float32)
    lib = _load()
    if lib is None:
        return np.array([a ** b for a, b in zip(x, y)], dtype=np.float32)
    out = np.empty_like(x)
    lib.mm2t_powf(x, y, out, x.shape[0])
    return out


def native_sketch_array(seq: bytes, w: int, k: int, rid: int = 0, is_hpc: bool = False):
    """Exact reference-order minimizer scan: an (n, 2) uint64 array of
    (key_span, rid_pos_strand) rows, or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.ascontiguousarray(seq, dtype=np.uint8)
    cap = max(16, len(arr))
    out = np.empty(2 * cap, dtype=np.uint64)
    n = lib.mm2t_sketch(arr, arr.shape[0], w, k, rid, int(is_hpc), out, cap)
    if n < 0:
        raise ValueError("invalid sketch parameters")
    if n > cap:
        out = np.empty(2 * n, dtype=np.uint64)
        n = lib.mm2t_sketch(arr, arr.shape[0], w, k, rid, int(is_hpc), out, n)
    return out[: 2 * n].reshape(-1, 2).copy()


def native_sketch(seq: bytes, w: int, k: int, rid: int = 0, is_hpc: bool = False):
    """native_sketch_array as a list of (key_span, rps) int pairs, or
    None when the native library is unavailable."""
    recs = native_sketch_array(seq, w, k, rid, is_hpc)
    return None if recs is None else [(int(a), int(b)) for a, b in recs]


def native_chain_dp(anchors: np.ndarray, p):
    """Exact reference DP (with max_chain_skip pruning). Returns
    (f, v, prev) int64 arrays or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = anchors.shape[0]
    ax = np.ascontiguousarray(anchors[:, 0], dtype=np.uint64)
    ay = np.ascontiguousarray(anchors[:, 1], dtype=np.uint64)
    f = np.zeros(n, dtype=np.int32)
    v = np.zeros(n, dtype=np.int32)
    prev = np.full(n, -1, dtype=np.int64)
    if n:
        lib.mm2t_chain_dp(ax, ay, n, ctypes.byref(_params_c(p)), f, v, prev)
    return f.astype(np.int64), v.astype(np.int64), prev


def native_backtrack(anchors: np.ndarray, f, v, prev, p):
    """Backtracking + chain assembly; returns (chains, scores) or None.
    v may be None (it is recomputed from f along the fallback path)."""
    lib = _load()
    if lib is None:
        return None
    if v is None:
        v = f  # placeholder; the native side no longer reads it
    n = anchors.shape[0]
    if n == 0:
        return [], []
    ax = np.ascontiguousarray(anchors[:, 0], dtype=np.uint64)
    ay = np.ascontiguousarray(anchors[:, 1], dtype=np.uint64)
    f32 = np.ascontiguousarray(f, dtype=np.int32)
    v32 = np.ascontiguousarray(v, dtype=np.int32)
    pr = np.ascontiguousarray(prev, dtype=np.int64)
    flat = np.empty(n, dtype=np.int64)
    cap_chains = n
    starts = np.empty(cap_chains, dtype=np.int64)
    lens = np.empty(cap_chains, dtype=np.int64)
    scores = np.empty(cap_chains, dtype=np.int64)
    m = lib.mm2t_backtrack(
        ax, ay, n, f32, v32, pr, ctypes.byref(_params_c(p)),
        flat, n, starts, lens, scores, cap_chains,
    )
    chains = [flat[starts[i] : starts[i] + lens[i]].tolist() for i in range(m)]
    return chains, scores[:m].tolist()
