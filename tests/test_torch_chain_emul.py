"""The chain-DP kernels' logic on the CPU: csrc/chain_dp.cu compiled with
g++ against csrc/emul/cuda_emul.h (one std::thread per CUDA thread,
std::barrier for the barriers, the warp intrinsics between warp
barriers), its short-read entry points and both designs of the pruned
instances and its lane (block-per-read) entry points run on seeded
inputs and held equal to the plain versions. A text pass includes the
header in place of <cuda_runtime.h> and rewrites the dynamic shared
memory declarations and the <<<...>>> launches into calls of the header.
The source is built twice: at one warp a read for the short-read kernel
(kShortThreads = 32) with the lane kernel's block of 512 threads, as
the card runs them, and at two warps a read with a lane block of 64
threads, whose ring of H + 64 slots wraps within a short read."""

import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from minimap2_rs_torch.config import ChainParams
from minimap2_rs_torch.ops.chain_ops import (
    chain_dp_aux_batch_ref,
    chain_dp_batch_ref,
    chain_scalars_from_params,
    log2_table,
    scanned_pairs,
)
from test_torch_chain_lane import TIE_KW, tie_read

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "minimap2_rs_torch" / "csrc"
THREADS = (32, 64)
# kLaneThreads of the build at each kShortThreads
LANE_THREADS = {32: 512, 64: 64}
SHORT = ("mm2t_chain_dp_aux_short", "mm2t_chain_dp_short")
TEMPLATE = ("mm2t_chain_dp_aux", "mm2t_chain_dp")


def emulated_source(src: str, **constants: int) -> str:
    """A csrc/*.cu source as g++ compiles it against cuda_emul.h, with each
    named `constexpr int` set to the value given."""
    n_launch = src.count("<<<")
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emul.h"')
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(mm2t_emul::dynamic_smem());", src)
    src, n = re.subn(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\(",
                     r"mm2t_emul::launch(\1, \2, ", src)
    assert n == n_launch > 0
    for name, value in constants.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        assert n == 1, name
    return src


def build_emulated(gxx: str, out: Path, stem: str, src: str, main: str) -> Path:
    """g++ build of an emulated source with its runner csrc/emul/<main>."""
    cpp = out / f"{stem}.cpp"
    cpp.write_text(src)
    exe = out / stem
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
           f"-I{CSRC / 'emul'}", str(cpp), str(CSRC / "emul" / main), "-o", str(exe)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """{kShortThreads: path of the emulated entry-point runner, its lane
    block LANE_THREADS[kShortThreads]}, built in parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("chain_emul")
    src = (CSRC / "chain_dp.cu").read_text()

    def build(threads):
        return build_emulated(gxx, out, f"chain_dp_t{threads}",
                              emulated_source(src, kShortThreads=threads,
                                              kLaneThreads=LANE_THREADS[threads]),
                              "chain_dp_main.cpp")

    with ThreadPoolExecutor(len(THREADS)) as ex:
        return dict(zip(THREADS, ex.map(build, THREADS)))


def chains(rng, B, A, ns, r0=0, q0=0, step=40, jitter=3):
    """(grp, rpos, qpos, span) int32 (B, A): read b holds ns[b] anchors
    sorted like the mapper's (colinear runs on two strands whose query
    positions jitter, so some step back; 5% exact duplicates) from
    positions r0 and q0, padding after."""
    cols = [np.full((B, A), -1, np.int64) for _ in range(3)] + [np.full((B, A), 255, np.int64)]
    for b, n in enumerate(ns):
        g, r, q = [], [], []
        while len(g) < n:
            m = int(rng.integers(5, 60))
            strand = int(rng.integers(0, 2)) << 31
            ra = r0 + int(rng.integers(0, 200_000))
            qa = q0 + int(rng.integers(0, 20_000))
            steps = rng.integers(1, step, size=m)
            jit = rng.integers(-jitter, jitter + 1, size=m)
            g += [strand] * m
            r += list(ra + np.cumsum(steps))
            q += list(qa + np.cumsum(steps + jit))  # dq <= 0 at times
        g, r, q = np.array(g[:n], np.int64), np.array(r[:n]), np.array(q[:n])
        dup = rng.random(n) < 0.05
        g, r, q = (np.r_[a, a[dup]][:n] for a in (g, r, q))
        o = np.lexsort((q, r, g))
        cols[0][b, :n], cols[1][b, :n], cols[2][b, :n] = g[o], r[o], q[o]
        cols[3][b, :n] = rng.integers(11, 20, size=n)
    assert max(c.max() for c in cols[1:3]) < 2**31
    return tuple(c.astype(np.uint32).view(np.int32) for c in cols)


def _case(name):
    """(cols, scalars, window) of a named case."""
    default = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    ns = [0, 20, 256, 255, 100, 31, 200, 1]  # empty, n < 32, full, ...
    if name == "A=256, full window":
        return chains(np.random.default_rng(7), 8, 256, ns), default, 256
    if name == "A=256, window 64, jitter 10":
        # winners at many distances dd, so each staged penalty is used
        return chains(np.random.default_rng(7), 8, 256, ns, jitter=10), default, 64
    if name == "tie read":
        fill = (-1, -1, -1, 255)
        cols = tuple(np.concatenate([a, np.full((1, 252), fill[c], np.int32)], axis=1)
                     for c, a in enumerate(tie_read()))
        return cols, chain_scalars_from_params(ChainParams.defaults_for_k(15, **TIE_KW)), 256
    if name == "tie within a thread":
        # anchors 0 and 1, 63 anchors of another group, anchor 2, one more
        # of the other group, then anchor 3: its tied predecessors 1 and 65
        # are 64 slots apart, so one thread scores both, and neither is the
        # newest slot
        g, r, q, sp = tie_read()
        fill = lambda a, v, k: np.full((1, k), v, np.int32)
        cols = tuple(np.concatenate([a[:, :2], fill(a, v, 63), a[:, 2:3], fill(a, v, 1),
                                     a[:, 3:], fill(a, pad, 256 - 68)], axis=1)
                     for a, v, pad in zip((g, r, q, sp), (7, 5000, 5000, 15), (-1, -1, -1, 255)))
        return cols, chain_scalars_from_params(ChainParams.defaults_for_k(15, **TIE_KW)), 256
    if name == "positions near 2^31 - 1":
        cols = chains(np.random.default_rng(11), 8, 256, ns, r0=2**31 - 1 - 260_000,
                      q0=2**31 - 1 - 30_000)
        return cols, default, 256
    if name == "pen_skip != 0":
        skip = chain_scalars_from_params(ChainParams.defaults_for_k(15, chn_pen_skip=0.2))
        return chains(np.random.default_rng(17), 8, 256, ns), skip, 256
    if name.startswith("wide band"):
        # small linear penalties, so pairs with a large dd can still win
        wide = chain_scalars_from_params(ChainParams.defaults_for_k(
            15, bw=20000, chn_pen_gap=0.0,
            chn_pen_skip=0.001 if name.endswith("pen_skip != 0") else 0.0))
        cols = chains(np.random.default_rng(13), 8, 256, ns, step=3000, jitter=2000)
        return cols, wide, 256
    raise KeyError(name)


# the kernel's instances: pen_skip == 0 or not, bw below the staged table
# (1024 entries) or not
CASES = ("A=256, full window", "A=256, window 64, jitter 10", "tie read", "tie within a thread",
         "positions near 2^31 - 1", "pen_skip != 0", "wide band, dd past the staged table",
         "wide band, dd past the staged table, pen_skip != 0")


def _run(exe, tmp_path, cols, scal, window, tab, entries, max_skip=0):
    B, A = cols[0].shape
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    hdr = np.array([B, A, min(window, A), scal.max_dist_x, scal.max_dist_y, scal.bw,
                    tab.shape[0], max_skip], np.int32)
    pens = np.array([scal.chn_pen_gap, scal.chn_pen_skip], np.float32)
    inp.write_bytes(b"".join(a.tobytes() for a in (hdr, pens, *cols, tab.numpy())))
    res = subprocess.run([str(exe), str(inp), str(out), *entries], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    words = np.fromfile(out, np.int32)
    got, pos = {}, 0
    for e in entries:
        n_out = 4 if "_aux" in e else 2
        got[e] = (int(words[pos]), words[pos + 1:pos + 1 + n_out * B * A].reshape(n_out, B, A))
        pos += 1 + n_out * B * A
    assert pos == words.size
    return got


def _winner_dd(cols, prev):
    """|dr - dq| of each row and its chosen predecessor, where it has one."""
    r, q, prev = (x.long() for x in (cols[1], cols[2], prev))
    j = prev.clamp(min=0)
    return ((r - r.gather(1, j)) - (q - q.gather(1, j))).abs()[prev >= 0]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_short_kernel_equals_plain(binaries, tmp_path, threads, case):
    """Both short-read entry points give the plain versions' outputs bit
    for bit; on the first case the template's do too, which checks the
    emulation itself."""
    cols, scal, window = _case(case)
    tab = log2_table(20001)
    entries = SHORT + (TEMPLATE if (case, threads) == (CASES[0], THREADS[0]) else ())
    got = _run(binaries[threads], tmp_path, cols, scal, window, tab, entries)
    t = tuple(torch.from_numpy(c.copy()) for c in cols)
    want_aux = chain_dp_aux_batch_ref(*t, scal, window, tab)
    want_prev = chain_dp_batch_ref(*t, scal, window, tab)
    for entry, (rc, outs) in got.items():
        assert rc == 0, (entry, rc)
        want = want_aux if "_aux" in entry else want_prev
        for name, g, w in zip(("f", "cnt/prev", "sq", "sr"), outs, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{entry}: {name}")
    # the cases reach what they are named for
    chained = (want_prev[1] >= 0).sum().item()
    assert chained > 0
    if case == "tie read":
        assert want_prev[1][0, 3].item() == 2
    if case == "tie within a thread":
        assert want_prev[1][0, 67].item() == 65
    if case == "A=256, window 64, jitter 10":
        assert set(range(16)) <= set(_winner_dd(t, want_prev[1]).tolist())
    if case.startswith("wide band"):
        assert (_winner_dd(t, want_prev[1]) >= 1024).any()


def test_emulated_launch_refuses_an_oversized_block(binaries, tmp_path):
    """A read too long for a block's shared memory is refused at launch
    (return code != 0), not run: the wrapper raises on it."""
    A = 8192  # 4 reads x 8192 slots x 32 B > 227 KB
    cols = chains(np.random.default_rng(3), 1, A, [16])
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    got = _run(binaries[THREADS[0]], tmp_path, cols, scal, A, log2_table(501),
               ("mm2t_chain_dp_aux_short",))
    assert got["mm2t_chain_dp_aux_short"][0] != 0


# ---- the lane kernel (A >= 1024, exact window) ------------------------------

LANE = ("mm2t_chain_dp_aux_lane", "mm2t_chain_dp_lane")


def _padded(arrs, A):
    """(1, n) columns padded to (1, A)."""
    fill = (-1, -1, -1, 255)
    return tuple(np.concatenate([a, np.full((1, A - a.shape[1]), fill[c], np.int32)], axis=1)
                 for c, a in enumerate(arrs))


def _lane_case(name):
    """(cols, scalars, window) of a named lane case: B <= 2, A 1024-1200,
    H 1024."""
    default = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    tie = chain_scalars_from_params(ChainParams.defaults_for_k(15, **TIE_KW))
    if name == "A = 1200, the ring wraps":
        # at 64 threads R = H + 64 = 1088 slots: rows past it take the
        # slots of rows a ring back, loaded a tile or more earlier
        return chains(np.random.default_rng(31), 1, 1200, [1200]), default, 1024
    if name == "n = 0 and n < H (A = 1024)":
        return chains(np.random.default_rng(37), 2, 1024, [0, 300]), default, 1024
    if name == "tie read (A = 1024)":
        return _padded(tie_read(), 1024), tie, 1024
    if name == "tie 512 slots apart (A = 1024)":
        # anchor 3's tied predecessors 1 and 513 are scored by one thread
        # at either block size; one anchor of another group follows 513,
        # so neither is the newest slot
        g, r, q, sp = tie_read()
        fill = lambda v, k: np.full((1, k), v, np.int32)
        arrs = tuple(np.concatenate([a[:, :2], fill(v, 511), a[:, 2:3], fill(v, 1), a[:, 3:]],
                                    axis=1)
                     for a, v in zip((g, r, q, sp), (7, 5000, 5000, 15)))
        return _padded(arrs, 1024), tie, 1024
    if name == "positions near 2^31 - 1 (A = 1024)":
        cols = chains(np.random.default_rng(41), 1, 1024, [300], r0=2**31 - 1 - 260_000,
                      q0=2**31 - 1 - 30_000)
        return cols, default, 1024
    raise KeyError(name)


LANE_CASES = ("A = 1200, the ring wraps", "n = 0 and n < H (A = 1024)",
              "tie read (A = 1024)", "tie 512 slots apart (A = 1024)",
              "positions near 2^31 - 1 (A = 1024)")
# every case at a block of 64 threads; the short ones at the card's 512
# too (an emulated block of 512 threads is slow under a loaded host)
LANE_PARAMS = [(c, 64) for c in LANE_CASES] + [(c, 32) for c in LANE_CASES[1:3]]


@pytest.mark.parametrize("case,threads", LANE_PARAMS)
def test_emulated_lane_kernel_equals_plain(binaries, tmp_path, case, threads):
    """Both lane entry points (a block of LANE_THREADS[threads] threads a
    read, the window in a shared-memory ring) give the plain versions'
    outputs bit for bit."""
    cols, scal, window = _lane_case(case)
    tab = log2_table(scal.bw + 1)
    got = _run(binaries[threads], tmp_path, cols, scal, window, tab, LANE)
    t = tuple(torch.from_numpy(c.copy()) for c in cols)
    want_aux = chain_dp_aux_batch_ref(*t, scal, window, tab)
    want_prev = chain_dp_batch_ref(*t, scal, window, tab)
    for entry, (rc, outs) in got.items():
        assert rc == 0, (entry, rc)
        want = want_aux if "_aux" in entry else want_prev
        for name, g, w in zip(("f", "cnt/prev", "sq", "sr"), outs, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{entry}: {name}")
    # the cases reach what they are named for
    prev = want_prev[1]
    assert (prev >= 0).any()
    if case.startswith("tie read"):
        assert prev[0, 3].item() == 2
    if case.startswith("tie 512"):
        assert prev[0, 515].item() == 513
    if case.startswith("A = 1200"):
        assert (prev[0, 1088:] >= 0).any()


# ---- the pruned instances (max_chain_skip) ---------------------------------

PRUNE = ("mm2t_chain_dp_aux_prune_smem", "mm2t_chain_dp_prune_smem",
         "mm2t_chain_dp_aux_prune", "mm2t_chain_dp_prune")


def decoys(rng, B, n_blocks, boosters=0, size=(28, 40), A=None):
    """Rows of [backbone, decoys, backbone, ...] blocks, as in
    tests/test_torch_chain_prune.py: clusters of `size` decoys on a far
    diagonal inside the band are admissible but never beat, and the
    backbone's marks make them count as skips; the backbone anchor's
    predecessor is the previous one, a chunk or more back. `boosters`
    on-diagonal beats a cluster, at random places (the counter's floored
    decrement). Padding to A."""
    rows = []
    for _b in range(B):
        rp, qp, r0 = [], [], 1000
        for _t in range(n_blocks):
            n_decoy = int(rng.integers(*size))
            diag = int(rng.integers(420, 480))
            rp += [r0] + [r0 + 10 + u for u in range(n_decoy)]
            qp += [r0] + [r0 + 10 + u + diag for u in range(n_decoy)]
            for u in rng.choice(n_decoy, size=boosters, replace=False):
                rp.append(r0 + 10 + int(u))
                qp.append(r0 + 10 + int(u))
            r0 += 10 + n_decoy + int(rng.integers(450, 520))
        o = np.argsort(np.array(rp), kind="stable")
        rows.append((np.array(rp)[o], np.array(qp)[o]))
    A = A or max(len(r) for r, _ in rows)
    cols = [np.full((B, A), -1, np.int32), np.zeros((B, A), np.int32),
            np.zeros((B, A), np.int32), np.full((B, A), 255, np.int32)]
    for b, (rp, qp) in enumerate(rows):
        n = min(len(rp), A)
        cols[0][b, :n], cols[1][b, :n], cols[2][b, :n], cols[3][b, :n] = 0, rp[:n], qp[:n], 15
    return tuple(cols)


def _prune_case(name):
    """(cols, scalars, window) of a named pruned case."""
    default = chain_scalars_from_params(ChainParams.defaults_for_k(15))
    if name == "decoys, marks across chunks":
        return decoys(np.random.default_rng(3), 4, 5), default, 5000
    if name == "decoys, boosters, window 64":
        return decoys(np.random.default_rng(5), 4, 5, boosters=1), default, 64
    if name == "decoys, a chunk without a beat":
        # at max_chain_skip 31 the first chunk of a backbone row counts
        # marks up to its last lane without a beat or a break
        return decoys(np.random.default_rng(1), 4, 5), default, 5000
    if name == "interleaved chains, window 8":
        # eight chains on diagonals 1000 apart (no pair across them is
        # admissible), interleaved so that each anchor's only predecessor
        # is the oldest slot of its window
        t, c = np.divmod(np.arange(256), 8)
        r = 1000 + 40 * t + c
        cols = (np.zeros((1, 256), np.int32), r[None].astype(np.int32),
                (r + 1000 * c)[None].astype(np.int32), np.full((1, 256), 15, np.int32))
        return cols, default, 8
    if name == "long decoy clusters, counter carried across chunks":
        # the break falls in a row's second chunk, after the first chunk's
        # last lane changed the counter
        return decoys(np.random.default_rng(0), 4, 5, boosters=2, size=(50, 70)), default, 5000
    if name == "colinear runs, n < 32 and n = A":
        ns = [0, 20, 160, 31, 1, 90]
        return chains(np.random.default_rng(19), 6, 160, ns), default, 160
    if name == "tie read":
        return _case("tie read")[0], _case("tie read")[1], 256
    if name == "unsorted anchors (dr < 0)":
        # read 0: a colinear chain whose every 10th anchor steps back one
        # base in r (dr = -1, dq = 10 from its predecessor, which ties
        # with the one before and wins as the larger j); the others
        # shuffled colinear runs
        rng = np.random.default_rng(23)
        cols = [c.copy() for c in chains(rng, 4, 128, [128, 100, 64, 20], step=8)]
        for b, n in enumerate((100, 64, 20), start=1):
            o = rng.permutation(n)
            for c in cols:
                c[b, :n] = c[b, o]
        steps = np.where(np.arange(128) % 10 == 9, -1, 10)
        cols[0][0], cols[3][0] = 0, 15
        cols[1][0] = 1000 + np.cumsum(steps)
        cols[2][0] = 1000 + 10 * np.arange(128)
        return tuple(cols), default, 128
    if name == "A = 1152, B = 1":
        return decoys(np.random.default_rng(29), 1, 40, boosters=1, A=1152), default, 5000
    raise KeyError(name)


PRUNE_CASES = ("decoys, marks across chunks", "decoys, boosters, window 64",
               "long decoy clusters, counter carried across chunks",
               "interleaved chains, window 8", "colinear runs, n < 32 and n = A", "tie read",
               "unsorted anchors (dr < 0)", "A = 1152, B = 1")
PRUNE_PARAMS = [(c, s) for c in PRUNE_CASES for s in (0, 1, 25)] + [
    ("decoys, a chunk without a beat", 31)]


@pytest.mark.parametrize("case,skip", PRUNE_PARAMS)
def test_emulated_pruned_kernels_equal_plain(binaries, tmp_path, case, skip):
    """Both designs of both pruned instances (the read in shared memory
    with warp scans, and the template's serial walk) give the plain
    versions' outputs at max_chain_skip bit for bit."""
    cols, scal, window = _prune_case(case)
    tab = log2_table(scal.bw + 1)
    got = _run(binaries[THREADS[0]], tmp_path, cols, scal, window, tab, PRUNE, max_skip=skip)
    t = tuple(torch.from_numpy(c.copy()) for c in cols)
    want_aux = chain_dp_aux_batch_ref(*t, scal, window, tab, max_chain_skip=skip)
    want_prev = chain_dp_batch_ref(*t, scal, window, tab, max_chain_skip=skip)
    for entry, (rc, outs) in got.items():
        assert rc == 0, (entry, rc)
        want = want_aux if "_aux" in entry else want_prev
        for name, g, w in zip(("f", "cnt/prev", "sq", "sr"), outs, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{entry}: {name}")
    # the cases reach what they are named for
    f, prev = want_prev
    assert (prev >= 0).any()
    if case == "tie read":
        assert prev[0, 3].item() == 2
        return
    if case == "interleaved chains, window 8":
        assert (prev[0, 8:] == torch.arange(248, dtype=torch.int32)).all()
        return
    if case == "unsorted anchors (dr < 0)":
        r = t[1].long()
        j = prev.long().clamp(min=0)
        assert ((r - r.gather(1, j) < 0) & (prev >= 0)).any()
        return
    walked = scanned_pairs(*t, f, prev, scal, window, tab, skip)
    assert (walked < scanned_pairs(*t, f, prev, scal, window, tab, None)).any(), \
        "the break must cut some walk"


def test_scanned_pairs_counts_the_oracle_walk():
    """scanned_pairs equals a count of the j the oracle's loop
    (oracle/lchain.py:110-129) visits, row by row, on the decoys."""
    cols, scal, window = _prune_case("decoys, boosters, window 64")
    tab = log2_table(scal.bw + 1)
    t = tuple(torch.from_numpy(c.copy()) for c in cols)
    for skip in (0, 25):
        f, prev = chain_dp_batch_ref(*t, scal, window, tab, max_chain_skip=skip)
        got = scanned_pairs(*t, f, prev, scal, window, tab, skip)
        g, r, q, sp = (c.astype(np.int64) for c in cols)
        fn, pn = f.numpy().astype(np.int64), prev.numpy().astype(np.int64)
        for b in range(g.shape[0]):
            n = int((g[b] != -1).sum())
            mark = np.full(n, -1)
            visited = 0
            for i in range(n):
                best, n_skip = sp[b, i], 0
                for j in range(i - 1, max(0, i - window) - 1, -1):
                    visited += 1
                    dq, dr = q[b, i] - q[b, j], r[b, i] - r[b, j]
                    dd = abs(dr - dq)
                    if not (g[b, j] == g[b, i] and 0 < dq <= scal.max_dist_x and dr != 0
                            and dr <= scal.max_dist_x and dd <= scal.bw):
                        continue
                    dg = min(dr, dq)
                    pen = int(np.float32(scal.chn_pen_gap) * np.float32(dd)
                              + np.float32(0.5) * tab[dd].numpy())
                    sc = fn[b, j] + min(sp[b, j], dg) - pen * (dd != 0 or dg > sp[b, j])
                    if sc > best:
                        best, n_skip = sc, max(n_skip - 1, 0)
                    elif mark[j] == i:
                        n_skip += 1
                        if n_skip > skip:
                            break
                    if pn[b, j] >= 0:
                        mark[pn[b, j]] = i
            assert got[b].item() == visited, (skip, b)
