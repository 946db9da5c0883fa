"""The odd-k sketch kernel's logic on the CPU, and the sketch stage's
routing.

csrc/sketch.cu is compiled with g++ against csrc/emul/cuda_emul.h (the
text pass and build of tests/test_torch_chain_emul.py) and its entry
point mm2t_sketch_minimizers run on one batch on each wire (2-bit rows
with the N list, 4-bit rows, int32 nt4 codes): every output held bit for
bit to the plain chain it replaces, unpack_codes2 / unpack_codes4 ->
sketch_positions -> compact_minimizers. The source is built at the
card's tile (kSketchTile = 1024 positions, 256 threads) and at 128
positions on one warp, where halos and windows cross many tiles. The
batch holds seqsim reads with N runs, reads that start or end in Ns, an
empty read, reads shorter than k and of exactly w + k - 1, lengths that
are no multiple of a tile, Ns on tile edges, two-letter reads and
periodic ones (a tie in every window, after each reset too), at a
capacity M that holds every read and at one that some overflow."""

import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from minimap2_rs_torch.kernels import sketch as ksketch
from minimap2_rs_torch.models import stages
from minimap2_rs_torch.ops import index_build, sketch_scan
from minimap2_rs_torch.ops.seeds_ops import query_occ_filter, sort_minimizers_by_key
from minimap2_rs_torch.ops.sketch import (
    compact_minimizers,
    sketch_positions,
    unpack_codes2,
    unpack_codes4,
)
from minimap2_rs_torch.utils.packing import nt4_encode
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads
from test_torch_chain_emul import CSRC, build_emulated, emulated_source

torch.set_num_threads(2)

# (kSketchTile, kSketchThreads): the card's build and a small one
TILES = ((1024, 256), (128, 32))
WIRES = ("2bit", "4bit", "nt4")  # the kernel's wire codes 0, 1, 2
L = 1100  # a multiple of 4, of no tile


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """{kSketchTile: path of the emulated entry-point runner}, built in
    parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("sketch_emul")
    src = (CSRC / "sketch.cu").read_text()

    def build(tile_threads):
        tile, threads = tile_threads
        return build_emulated(gxx, out, f"sketch_t{tile}",
                              emulated_source(src, kSketchTile=tile, kSketchThreads=threads),
                              "sketch_main.cpp")

    with ThreadPoolExecutor(len(TILES)) as ex:
        return dict(zip((t for t, _ in TILES), ex.map(build, TILES)))


def _seqs(w: int, k: int) -> list[bytes]:
    g = random_genome(60_000, seed=w * 100 + k, n_frac=0.01)
    seqs = [s for _n, s, *_ in simulate_reads(g, 6, read_len=(600, L), seed=k)]
    rng = np.random.default_rng(w + k)
    rand = lambda n: bytes(rng.choice(list(b"ACGT"), size=n).tolist())  # noqa: E731
    seqs += [
        b"",
        rand(k - 2),                                  # shorter than k
        rand(w + k - 1),                              # one full window
        b"N" * 40 + rand(700),                        # starts in Ns
        rand(1030) + b"N" * 70,                       # ends in Ns, crosses 1024
        rand(127) + b"N" + rand(896) + b"N" + rand(75),  # Ns on tile edges (128, 1024)
        rand(300) + b"N" * 3 + rand(w + k) + b"N" + rand(500),  # N runs, a short run
        bytes(rng.choice(list(b"AC"), size=L).tolist()),  # two letters
        b"ACGT" * 100 + b"N" + b"ACGT" * 50,          # a tie in every window
        b"A" * 150 + b"NN" + b"AAC" * 100,            # homopolymer, period 3
        rand(L),                                      # the whole row
        b"N" * 200,
    ]
    return seqs


def _wires(seqs):
    """(lengths, nex, {wire: rows}) of a batch: the 2-bit rows and the
    ascending N list padded with B*L (as the host encoder writes them),
    the 4-bit rows and the int32 nt4 codes, all padded with 4."""
    B = len(seqs)
    codes = np.full((B, L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = nt4_encode(s)
    lengths = np.array([len(s) for s in seqs], np.int32)
    inside = np.arange(L)[None, :] < lengths[:, None]
    base = np.where(inside & (codes < 4), codes, 0).astype(np.uint8)
    rows2 = np.zeros((B, L // 4), np.uint8)
    for s in range(4):
        rows2 |= base[:, s::4] << (2 * s)
    nex = np.flatnonzero(inside & (codes >= 4)).astype(np.int32)
    nex = np.concatenate([nex, np.full(17, B * L, np.int32)])
    rows4 = codes[:, 0::2] | codes[:, 1::2] << 4
    return lengths, nex, {"2bit": rows2, "4bit": rows4, "nt4": codes.astype(np.int32)}


def _run(exe, tmp_path, lengths, nex, rows, w, k, M, wires=WIRES):
    B = lengths.shape[0]
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    hdr = np.array([B, L, w, k, M, nex.shape[0]], np.int32)
    inp.write_bytes(b"".join(a.tobytes() for a in (
        hdr, lengths, nex, rows["2bit"], rows["4bit"], rows["nt4"])))
    res = subprocess.run([str(exe), str(inp), str(out), *(str(WIRES.index(x)) for x in wires)],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    raw = np.fromfile(out, np.uint8)
    got, pos = {}, 0

    def take(dtype, n):
        nonlocal pos
        a = raw[pos:pos + n * np.dtype(dtype).itemsize].view(dtype)
        pos += n * np.dtype(dtype).itemsize
        return a

    for wire in wires:
        rc = int(take(np.int32, 1)[0])
        cks = torch.from_numpy(take(np.int64, B * M).reshape(B, M).copy())
        cps = torch.from_numpy(take(np.int64, B * M).reshape(B, M).copy())
        n_mini = torch.from_numpy(take(np.int32, B).copy())
        ovf = torch.from_numpy(take(np.uint8, B).copy())
        got[wire] = rc, (cks, cps, n_mini, ovf)
    assert pos == raw.size
    return got


def _plain(lengths, nex, rows, wire, w, k, M):
    """The chain the kernel replaces, on the CPU."""
    lengths = torch.from_numpy(lengths)
    r = torch.from_numpy(rows[wire])
    codes = {"2bit": lambda: unpack_codes2(r, lengths, torch.from_numpy(nex)),
             "4bit": lambda: unpack_codes4(r), "nt4": lambda: r}[wire]()
    return compact_minimizers(*sketch_positions(codes, lengths, w, k), M)


@pytest.mark.parametrize("tile", [t for t, _ in TILES])
@pytest.mark.parametrize("k", (15, 19, 27))
@pytest.mark.parametrize("w", (10, 1, 25))
def test_emulated_sketch_equals_plain_chain(binaries, tmp_path, tile, w, k):
    """M is the minimizer count of a read in the middle: the reads with
    more overflow it (the first M kept), that one fills it exactly, the
    others fit and are padded. The card's tile runs the main path's
    2-bit wire (its 256-thread blocks are the emulation's cost), the
    small tile every wire."""
    lengths, nex, rows = _wires(_seqs(w, k))
    counts = _plain(lengths, nex, rows, "nt4", w, k, L)[2]
    M = int(counts[counts > 0].sort().values[int((counts > 0).sum()) * 3 // 5])
    wires = WIRES[:1] if tile == TILES[0][0] else WIRES
    got = _run(binaries[tile], tmp_path, lengths, nex, rows, w, k, M, wires)
    for wire in wires:
        want = _plain(lengths, nex, rows, wire, w, k, M)
        rc, (cks, cps, n_mini, ovf) = got[wire]
        assert rc == 0, (wire, rc)
        for name, g, x in (("cks", cks, want[0]), ("cps", cps, want[1]),
                           ("n_mini", n_mini, want[2]), ("mini_ovf", ovf.bool(), want[3])):
            bad = (g != x).nonzero()[:5].tolist()
            assert torch.equal(g, x), f"{wire} (tile {tile}) {name} != plain at {bad}"
    # some reads overflow, at least 5 fit with minimizers to spare, and
    # only the empty read, the all-N one and the one shorter than k emit none
    assert int(want[3].sum()) >= 3 and bool((counts == M).any())
    assert int(((want[2] > 0) & (want[2] < M)).sum()) >= 5
    assert int((want[2] == 0).sum()) <= 3


def test_emulated_sketch_refuses_what_it_does_not_take(binaries, tmp_path):
    """Even k, w past its halo and k past 27 are refused by the entry (the
    wrapper never passes them) and leave every output unwritten."""
    lengths, nex, rows = _wires(_seqs(10, 15)[:3])
    for w, k in ((10, 14), (256, 15), (10, 29)):
        got = _run(binaries[TILES[0][0]], tmp_path, lengths, nex, rows, w, k, 16)
        for wire in WIRES:
            rc, (_cks, _cps, n_mini, _ovf) = got[wire]
            assert rc != 0, (w, k, wire)
            assert (n_mini.numpy().view(np.uint32) == 0xA5A5A5A5).all()


def _stage_inputs(wire, w=10, k=15):
    lengths, nex, rows = _wires(_seqs(w, k))
    return (torch.from_numpy(rows[wire]), torch.from_numpy(lengths),
            torch.from_numpy(nex) if wire == "2bit" else None)


STAGE_KW = dict(q_occ_max=10, q_occ_frac=0.01)


@pytest.mark.parametrize("wire", WIRES)
def test_sketch_compact_filter_on_the_cpu_is_the_plain_chain(wire):
    """At odd k on CPU tensors the stage returns the plain chain's output,
    and the kernel wrapper counts no launch."""
    ksketch.reset_launches()
    rows, lengths, nex = _stage_inputs(wire)
    got = stages.sketch_compact_filter(rows, lengths, w=10, k=15, M=256, wire=wire, nex=nex,
                                       **STAGE_KW)
    codes = stages.wire_codes(rows, lengths, nex, wire)
    cks, cps, n_mini, mini_ovf = compact_minimizers(*sketch_positions(codes, lengths, 10, 15),
                                                    256)
    sks, sps = sort_minimizers_by_key(cks, cps)
    keep = query_occ_filter(sks, n_mini, STAGE_KW["q_occ_max"], STAGE_KW["q_occ_frac"])
    want = dict(sks=sks, sps=sps, keep=keep, cps=cps, n_mini=n_mini, mini_ovf=mini_ovf)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert int(n_mini.sum()) > 500
    assert ksketch.total_launches() == 0


def _no_kernel(*a, **kw):
    raise AssertionError("the sketch kernel's wrapper was called")


def test_even_k_and_the_index_build_take_the_positions_path(monkeypatch):
    """Even k goes through sketch_positions and sketch_positions_exact,
    the device index build through sketch_positions; neither calls the
    kernel's wrapper nor counts a launch."""
    calls = {"positions": 0, "exact": 0}
    exact, positions = sketch_scan.sketch_positions_exact, index_build.sketch_positions

    def spy_exact(*a, **kw):
        calls["exact"] += 1
        return exact(*a, **kw)

    def spy_positions(*a, **kw):
        calls["positions"] += 1
        return positions(*a, **kw)

    monkeypatch.setattr(sketch_scan, "sketch_positions_exact", spy_exact)
    monkeypatch.setattr(stages, "sketch_minimizers", _no_kernel)
    monkeypatch.setattr(index_build, "sketch_positions", spy_positions)
    ksketch.reset_launches()
    rows, lengths, nex = _stage_inputs("2bit", k=14)
    mini = stages.sketch_compact_filter(rows, lengths, w=10, k=14, M=256, wire="2bit",
                                        nex=nex, **STAGE_KW)
    assert calls["exact"] == 1 and int(mini["n_mini"].sum()) > 500

    from minimap2_rs_torch.models.index_builder import build_index_device

    records = [("a", random_genome(3_000, seed=5)), ("b", random_genome(2_000, seed=6))]
    for flag in (0, 1):  # HPC too
        from minimap2_rs_torch.config import IndexParams

        idx = build_index_device(records, IndexParams(w=10, k=15, flag=flag), device="cpu")
        assert idx.keys.shape[0] > 100
    assert calls["positions"] >= 2
    assert ksketch.total_launches() == 0


def test_kernel_wrapper_checks_its_inputs():
    """What the wrapper refuses before any launch: an unknown wire on any
    device; on the CPU it runs the plain chain whatever the dtype."""
    rows, lengths, nex = _stage_inputs("nt4")
    with pytest.raises(ValueError, match="unknown wire"):
        ksketch.sketch_minimizers(rows, lengths, nex, "3bit", 10, 15, 64)
    plain = ksketch.sketch_minimizers(rows.to(torch.int64), lengths, None, "nt4", 10, 15, 64)
    want = ksketch.sketch_minimizers(rows, lengths, None, "nt4", 10, 15, 64)
    assert all(torch.equal(a, b) for a, b in zip(plain, want))
    with pytest.raises(TypeError):
        ksketch._validate(rows.to(torch.int64), lengths, None, "nt4", 10, 15, 64)
    with pytest.raises(ValueError, match="odd k"):
        ksketch._validate(rows, lengths, None, "nt4", 10, 14, 64)
    with pytest.raises(ValueError, match="N list"):
        ksketch._validate(rows[:, :L // 4].to(torch.uint8).contiguous(), lengths, None,
                          "2bit", 10, 15, 64)
