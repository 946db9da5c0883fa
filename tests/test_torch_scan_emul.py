"""The window-scan kernels' logic on the CPU: csrc/window_scan.cu compiled
with g++ against csrc/emul/cuda_emul.h (the text pass and build of
tests/test_torch_chain_emul.py), both entry points (the position-parallel
mm2t_window_scan_tile and the sequential mm2t_window_scan) run on the
corpora of tests/test_torch_sketch_scan.py and held bit-equal to the plain
version, ops/sketch_scan._window_scan_ref. The tiled kernel is built at its
own tile (kScanTile = 256) and at 64, where the inputs span many tiles and
a window of w = 255 reaches back over several."""

import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from minimap2_rs_torch.ops.sketch_scan import _kmer_info_even, _window_scan_ref
from minimap2_rs_torch.utils.packing import nt4_encode
from minimap2_rs_torch.utils.seqsim import random_genome
from test_torch_chain_emul import CSRC, build_emulated, emulated_source

torch.set_num_threads(2)

TILES = (256, 64)
ENTRIES = ("mm2t_window_scan_tile", "mm2t_window_scan")


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """{kScanTile: path of the emulated entry-point runner}, built in
    parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("scan_emul")
    src = (CSRC / "window_scan.cu").read_text()

    def build(tile):
        return build_emulated(gxx, out, f"window_scan_t{tile}",
                              emulated_source(src, kScanTile=tile), "window_scan_main.cpp")

    with ThreadPoolExecutor(len(TILES)) as ex:
        return dict(zip(TILES, ex.map(build, TILES)))


def _corpus(L: int = 905):
    """tests/test_torch_sketch_scan.py's corpora (random, two-letter,
    strand-symmetric repeats, a stale-register N reset), an empty read and
    an N run, at lengths that are no multiple of a tile, in rows of L."""
    seqs = [random_genome(900, seed=s) for s in range(3)]
    for alpha in (b"AC", b"AT"):
        r = np.random.default_rng(len(alpha))
        seqs.append(bytes(r.choice(list(alpha), size=600).tolist()))
    seqs += [b"ACGT" * 150, b"ATATATAT" * 60, b"A" * 200 + b"N" + b"CGCG" * 60, b"",
             b"ACGTTGCA" * 20 + b"N" * 7 + random_genome(333, seed=9)]
    codes = np.full((len(seqs), L), 4, np.int32)
    lengths = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = nt4_encode(s)
    return torch.from_numpy(codes), torch.from_numpy(lengths)


def _run(exe, tmp_path, ks, ps, l_eff, lengths, w, k, emit_final):
    B, L = ks.shape
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    hdr = np.array([B, L, w, k], np.int32)
    inp.write_bytes(b"".join(a.tobytes() for a in (
        hdr, ks.numpy(), ps.numpy(), l_eff.numpy(), lengths.numpy(),
        emit_final.numpy().astype(np.uint8))))
    res = subprocess.run([str(exe), str(inp), str(out), *ENTRIES], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    raw = np.fromfile(out, np.uint8)
    got, pos = {}, 0
    for e in ENTRIES:
        rc = int(raw[pos:pos + 4].view(np.int32)[0])
        got[e] = (rc, torch.from_numpy(raw[pos + 4:pos + 4 + B * L].reshape(B, L).astype(bool)))
        pos += 4 + B * L
    assert pos == raw.size
    return got


# (w, k, hpc): the presets' w = 10 at even and odd k, k = 28 (the word
# passes 2^63), k = 2, w = 1 (every position a window) and w = 255 (the
# largest, its windows over several 64-position tiles), and HPC
CASES = [(10, 14, False), (10, 16, False), (10, 28, False), (3, 2, False), (1, 14, False),
         (255, 14, False), (10, 14, True), (5, 15, True)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("w,k,hpc", CASES)
def test_emulated_window_scans_equal_plain(binaries, tmp_path, tile, w, k, hpc):
    """Rows of odd and even length: the tiled kernel stages 8-byte words
    in the first, 16-byte pairs in the second."""
    for L in (905, 906):
        codes, lengths = _corpus(L)
        ks, ps, l_eff = _kmer_info_even(codes, lengths, k, hpc)
        l_eff = l_eff.to(torch.int32)
        rng = np.random.default_rng(w * 100 + k)
        emit_final = torch.from_numpy(rng.random(len(lengths)) < 0.7)
        want = _window_scan_ref(ks, ps, l_eff, lengths, w, k, emit_final)
        got = _run(binaries[tile], tmp_path, ks, ps, l_eff, lengths, w, k, emit_final)
        for entry, (rc, mask) in got.items():
            assert rc == 0, (entry, rc)
            bad = (mask != want).nonzero()[:5].tolist()
            assert torch.equal(mask, want), f"{entry} (tile {tile}, L {L}) != plain at {bad}"
        # every read emits but the empty one, ATATATAT at even k (its
        # k-mers are all strand-symmetric) and, at w = 255, the read whose
        # N run leaves no full window after it
        assert int(want.any(dim=1).sum()) >= len(lengths) - 3


def _random_words(rng, B, L, k):
    """Inputs no sequence gives so densely: key words from four values (a
    tie in most windows), 10% invalid positions, and an l counter that
    climbs, pauses and resets at random, so l == w+k-1 recurs and a tie
    of the old minimum is often followed by a reset or the read's end.
    Past a read's length every position is invalid with l = 0, as
    _kmer_info_even makes it (the plain version walks those positions
    too; they emit nothing)."""
    lengths = rng.integers(0, L + 1, size=B)
    ks = torch.from_numpy(rng.integers(0, 4, size=(B, L)).astype(np.int64) << 8 | k)
    valid = (rng.random((B, L)) < 0.9) & (np.arange(L) < lengths[:, None])
    ps = torch.from_numpy(np.where(valid, (np.arange(L) << 1) | rng.integers(0, 2, (B, L)),
                                   0xFFFFFFFF).astype(np.int64))
    step = rng.choice([0, 1, 1, 1, 1, 1, -1], size=(B, L))  # -1: reset
    l_eff = np.zeros((B, L), np.int32)
    for b in range(B):
        l = 0
        for i in range(L):
            l = 0 if step[b, i] < 0 else l + step[b, i]
            l_eff[b, i] = l if i < lengths[b] else 0
    return ks, ps, torch.from_numpy(l_eff), torch.from_numpy(lengths.astype(np.int32))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("w", (1, 3, 10, 255))
def test_emulated_window_scans_on_random_words(binaries, tmp_path, tile, w):
    rng = np.random.default_rng(w)
    for L in (301, 302):
        ks, ps, l_eff, lengths = _random_words(rng, 12, L, 2)
        emit_final = torch.from_numpy(rng.random(12) < 0.5)
        want = _window_scan_ref(ks, ps, l_eff, lengths, w, 2, emit_final)
        for entry, (rc, mask) in _run(binaries[tile], tmp_path, ks, ps, l_eff, lengths, w, 2,
                                      emit_final).items():
            assert rc == 0, (entry, rc)
            bad = (mask != want).nonzero()[:5].tolist()
            assert torch.equal(mask, want), f"{entry} (tile {tile}, L {L}) != plain at {bad}"
        assert want.any()


def test_emulated_tile_kernel_refuses_w_past_its_halo(binaries, tmp_path):
    """w = 256 would pass the staged halo: the entry refuses it (the
    wrapper never passes it)."""
    codes, lengths = _corpus()
    ks, ps, l_eff = _kmer_info_even(codes[:2], lengths[:2], 14, False)
    ef = torch.ones(2, dtype=torch.bool)
    got = _run(binaries[TILES[0]], tmp_path, ks, ps, l_eff.to(torch.int32), lengths[:2],
               256, 14, ef)
    assert got["mm2t_window_scan_tile"][0] != 0
