"""The prefix-probe kernel's logic on the CPU, and the lookup's routing.

csrc/probe.cu is compiled with g++ against csrc/emul/cuda_emul.h (the
text pass and build of tests/test_torch_chain_emul.py), and its entry
point mm2t_probe_prefix is held to the plain prefix branch (ops/index_ops.prefix_probe): start and count equal
for every slot, padding and filtered slots included. Two layouts of the
planner with the direct table off: a k 19 index of a 190 kb genome under
a 12-bit prefix cap, 8.4 keys a bucket and 128 slots, as T2T-CHM13 at
k 19 under 2^26 buckets; and a k 15 index at 16 slots. The queries are
the minimizers of simulated reads through the sketch stage (present
keys, slots the occurrence filter drops, padding), and crafted rows:
every key of the fullest bucket and its absent neighbours, the last
bucket before the sentinel rows, one-key buckets, key 0, absent keys
and keys past the index's key bits (the clamped bucket).

Besides: the wrapper refuses bad inputs, CPU tensors take the plain
version, stages.probe takes the kernel's wrapper on the prefix-probe
layout and the plain lookup on a direct table, the mapper counts the kernel's launches as probe_kernel_batches
on the probe layout only, and kv's keys ascend within every bucket of
the planner's and the sharded index's layouts, which the kernel's
early stop relies on."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams
from minimap2_rs_torch.kernels import counts
from minimap2_rs_torch.kernels import probe as kprobe
from minimap2_rs_torch.models import stages
from minimap2_rs_torch.models.index_builder import build_index_native
from minimap2_rs_torch.models.mapper import Mapper
from minimap2_rs_torch.ops import index_ops as tidx
from minimap2_rs_torch.ops.seeds_ops import lookup_keys
from minimap2_rs_torch.ops.sketch import KS_INVALID, ks_keys
from minimap2_rs_torch.parallel.sharded_index import ShardedDeviceIndex
from minimap2_rs_torch.utils.packing import nt4_encode
from minimap2_rs_torch.utils.seqsim import random_genome, simulate_reads
from test_torch_chain_emul import CSRC, build_emulated, emulated_source

torch.set_num_threads(2)

# (genome bp, k, prefix-bits cap, bucket_slots the planner gives)
LAYOUTS = {"k19_s128": (190_000, 19, 12, 128), "k15_s16": (100_000, 15, 26, 16)}


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """Path of the emulated entry-point runner."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("probe_emul")
    return build_emulated(gxx, out, "probe", emulated_source((CSRC / "probe.cu").read_text()),
                          "probe_main.cpp")


def _genome(n: int, k: int) -> bytes:
    return random_genome(n, seed=k)


def _probe_index(genome: bytes, k: int, cap: int):
    """(host index, its DeviceIndex on the prefix probe: the direct table
    off, the prefix table capped at 2^cap buckets)."""
    idx = build_index_native([("a", genome[:110_000]), ("b", genome[110_000:])],
                             IndexParams(w=10, k=k))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tidx, "_DM_BYTE_CAP", 1)
        mp.setattr(tidx.plan_direct_layout, "__defaults__", (1,))
        mp.setattr(tidx, "_MAX_PREFIX_BITS", cap)
        di = tidx.DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                        key_bits=2 * k, device="cpu")
    return idx, di


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout(request):
    n, k, cap, S = LAYOUTS[request.param]
    genome = _genome(n, k)
    idx, di = _probe_index(genome, k, cap)
    assert (di.dm_slots, di.bucket_slots) == (0, S)
    return request.param, genome, k, idx, di


def _read_slots(genome: bytes, k: int):
    """(sks, keep) of 12 simulated reads through the sketch stage, the
    occurrence filter set tight enough to drop some slots."""
    seqs = [s for _n, s, *_ in simulate_reads(genome, 12, read_len=(300, 900), seed=k)]
    L = 900
    codes = torch.full((len(seqs), L), 4, dtype=torch.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = torch.from_numpy(nt4_encode(s).astype(np.int32))
    lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    mini = stages.sketch_compact_filter(codes, lengths, w=10, k=k, q_occ_max=2,
                                        q_occ_frac=0.0, M=200, wire="nt4")
    return mini["sks"], mini["keep"]


def _crafted_slots(di, k: int, rng):
    """(sks, keep) rows of chosen keys: the fullest bucket's keys and their
    absent neighbours, the last bucket's, one-key buckets', key 0, random
    absent keys, keys past the key bits; a few present keys with keep
    False."""
    kv = di.kv.numpy().view(np.uint32)
    U = di.n_keys
    keys = kv[:U, 0].astype(np.uint64) << np.uint64(32) | kv[:U, 1].astype(np.uint64)
    prefix = di.prefix.numpy().astype(np.int64)
    sizes = np.diff(prefix)
    full = int(sizes.argmax())
    last = int(np.flatnonzero(sizes)[-1])
    ones = np.flatnonzero(sizes == 1)[:16]
    fk = keys[prefix[full]:prefix[full + 1]]
    key_set = set(keys.tolist())
    near = [int(x) + d for x in fk for d in (-1, 1) if int(x) + d not in key_set | {-1}]
    rand = [int(x) for x in rng.integers(0, 1 << (2 * k), 64, dtype=np.uint64)]
    past = [(1 << (2 * k)) + 5, (1 << 56) - 1, 1 << 50]
    want = (fk.tolist() + near + keys[prefix[last]:prefix[last + 1]].tolist()
            + keys[prefix[ones]].tolist() + [0] + rand + past + keys[::97].tolist())
    q = np.array(want, dtype=np.uint64)
    assert len(fk) > 64 or k == 15 and len(fk) > 8
    M = 64
    n_rows = -(-len(q) // M)
    qs = np.zeros(n_rows * M, dtype=np.uint64)
    qs[: len(q)] = q
    sks = (qs << np.uint64(8) | np.uint64(k)).view(np.int64).reshape(n_rows, M)
    sks = torch.from_numpy(sks.copy())
    keep = torch.ones(sks.shape, dtype=torch.bool)
    keep.view(-1)[len(q):] = False
    sks.view(-1)[len(q):] = KS_INVALID
    keep.view(-1)[3:len(q):11] = False  # filtered slots, their keys probe 0
    return sks, keep


def _emulate(exe, tmp_path, di, sks, keep):
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    n = sks.numel()
    hdr = np.array([n, di.prefix.shape[0], di.kv.shape[0], di.prefix_shift], np.int64)
    inp.write_bytes(b"".join(a.tobytes() for a in (
        hdr, sks.numpy(), keep.numpy().astype(np.uint8), di.prefix.numpy(), di.kv.numpy())))
    res = subprocess.run([str(exe), str(inp), str(out)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    raw = np.fromfile(out, np.uint8)
    assert raw.size == 4 + 16 * n
    rc = int(raw[:4].view(np.int32)[0])
    start = torch.from_numpy(raw[4:4 + 8 * n].view(np.int64).reshape(sks.shape).copy())
    count = torch.from_numpy(raw[4 + 8 * n:].view(np.int64).reshape(sks.shape).copy())
    return rc, start, count


def _plain(di, sks, keep):
    return tidx.prefix_probe(di, torch.where(keep, ks_keys(sks), 0))


@pytest.mark.parametrize("what", ("reads", "crafted"))
def test_emulated_probe_equals_plain_branch(binary, tmp_path, layout, what):
    name, genome, k, _idx, di = layout
    if what == "reads":
        sks, keep = _read_slots(genome, k)
    else:
        sks, keep = _crafted_slots(di, k, np.random.default_rng(k))
    rc, start, count = _emulate(binary, tmp_path, di, sks, keep)
    assert rc == 0
    want_s, want_c = _plain(di, sks, keep)
    for label, g, x in (("start", start, want_s), ("count", count, want_c)):
        bad = (g != x).nonzero()[:5].tolist()
        assert torch.equal(g, x), f"{name} {what}: {label} != plain at {bad}"
    present = keep & (want_c > 0)
    # hits and misses both, among kept and dropped slots
    assert int(present.sum()) > 100 and int((keep & (want_c == 0)).sum()) > 10
    assert int((~keep).sum()) > 10


@pytest.mark.parametrize("bad", ("one_prefix_entry", "shift_64", "shift_negative"))
def test_emulated_probe_refuses_what_it_does_not_take(binary, tmp_path, layout, bad):
    """A prefix table of fewer than two entries, or a shift outside [0,
    63], is refused by the entry and leaves every output unwritten."""
    _name, genome, k, _idx, di = layout
    sks, keep = _read_slots(genome, k)
    change = {"one_prefix_entry": dict(prefix=di.prefix[:1]), "shift_64": dict(prefix_shift=64),
              "shift_negative": dict(prefix_shift=-1)}[bad]
    rc, start, _count = _emulate(binary, tmp_path, tidx.DeviceIndex(
        **{**{f: getattr(di, f) for f in di.__dataclass_fields__}, **change}), sks, keep)
    assert rc != 0
    assert (start.numpy().view(np.uint64) == 0xA5A5A5A5A5A5A5A5).all()


def test_cpu_tensors_take_the_plain_branch(layout):
    """On the CPU the wrapper, and lookup_keys on a probe layout, give the
    plain branch's tensors and count no launch."""
    _name, genome, k, _idx, di = layout
    sks, keep = _read_slots(genome, k)
    kprobe.reset_launches()
    want = _plain(di, sks, keep)
    for got in (kprobe.probe_prefix(di, sks, keep), lookup_keys(di, sks, keep)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] > 0).sum()) > 100
    assert kprobe.total_launches() == 0


@pytest.mark.parametrize("table", ("prefix_probe", "direct"))
def test_stage_probe_routes_by_layout(monkeypatch, layout, table):
    """stages.probe takes the kernel's wrapper on an index with no direct
    table and lookup_keys on a direct table; both give the occurrence
    blocks of the same host index, slot for slot."""
    _name, genome, k, idx, di = layout
    if table == "direct":
        di_used = tidx.DeviceIndex.from_host(idx.keys, idx.starts, idx.counts,
                                             idx.positions, key_bits=2 * k, device="cpu")
        assert di_used.dm_slots
    else:
        di_used = di
    sks, keep = _read_slots(genome, k)
    called = []
    for fn in ("probe_prefix", "lookup_keys"):
        real = getattr(stages, fn)
        monkeypatch.setattr(stages, fn,
                            lambda *a, fn=fn, real=real: called.append(fn) or real(*a))
    out = stages.probe(di_used, dict(sks=sks, keep=keep))
    assert called == ["lookup_keys" if table == "direct" else "probe_prefix"]
    want_s, want_c = _plain(di, sks, keep)
    assert torch.equal(out["start"], want_s) and torch.equal(out["count"], want_c)
    assert out["sks"] is sks and int((want_c > 0).sum()) > 100


def test_kv_keys_ascend_within_every_bucket(layout):
    """Every key row lies in the bucket of its key's prefix, each bucket
    fits bucket_slots rows and ascends strictly; the sharded index's
    shards, when they probe by prefix, the same."""
    _name, _genome_, k, idx, di = layout

    def check(kv_t, prefix_t, shift, S, U):
        kv = kv_t.numpy().view(np.uint32)
        keys = kv[:U, 0].astype(np.uint64) << np.uint64(32) | kv[:U, 1].astype(np.uint64)
        prefix = prefix_t.numpy().astype(np.int64)
        bucket = np.repeat(np.arange(len(prefix) - 1), np.diff(prefix))
        assert prefix[-1] == U and len(bucket) == U
        assert np.array_equal((keys >> np.uint64(shift)).astype(np.int64), bucket)
        assert np.diff(prefix).max() <= S
        inner = bucket[1:] == bucket[:-1]
        assert (keys[1:][inner] > keys[:-1][inner]).all()
        assert (kv[U:, :2] == 0xFFFFFFFF).all() and kv.shape[0] >= U + S

    check(di.kv, di.prefix, di.prefix_shift, di.bucket_slots, di.n_keys)
    for rank in range(3):
        sh = ShardedDeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions,
                                          3, key_bits=2 * k, rank=rank, device="cpu")
        lo = round(rank * idx.keys.shape[0] / 3)
        hi = round((rank + 1) * idx.keys.shape[0] / 3)
        check(torch.from_numpy(sh.kv.view(np.int32)), torch.from_numpy(sh.prefix),
              sh.prefix_shift, sh.bucket_slots, hi - lo)


def test_wrapper_checks_its_inputs(layout):
    """What _validate refuses before a launch (checked on CPU tensors,
    which the wrapper itself sends to the plain version): wrong dtypes,
    shapes, strides, a direct-table index, a misaligned key table."""
    _name, genome, k, _idx, di = layout
    sks, keep = _read_slots(genome, k)
    kprobe._validate(di, sks, keep)
    with pytest.raises(TypeError):
        kprobe._validate(di, sks.to(torch.int32), keep)
    with pytest.raises(TypeError):
        kprobe._validate(di, sks, keep.to(torch.uint8))
    with pytest.raises(ValueError, match="shape"):
        kprobe._validate(di, sks, keep[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        kprobe._validate(di, sks.t(), keep.t())
    fields = {f: getattr(di, f) for f in di.__dataclass_fields__}
    with pytest.raises(ValueError, match="direct table"):
        kprobe.probe_prefix(tidx.DeviceIndex(**{**fields, "dm_slots": 16}), sks, keep)
    with pytest.raises(TypeError):
        kprobe._validate(tidx.DeviceIndex(**{**fields, "kv": di.kv.to(torch.int64)}), sks,
                         keep)
    flat = torch.zeros(di.kv.numel() + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        kprobe._validate(tidx.DeviceIndex(**{**fields, "kv": flat[1:].view(-1, 4)}), sks,
                         keep)
    with pytest.raises(ValueError, match="prefix"):
        kprobe._validate(tidx.DeviceIndex(**{**fields, "prefix": di.prefix[:1]}), sks, keep)
    with pytest.raises(ValueError, match="device"):
        kprobe.probe_prefix(di, sks.to("meta"), keep.to("meta"))


def _spy_kernel(idx, sks, keep):
    """A stand-in for a launch on the CPU: counted as the wrapper counts
    one, the plain branch's outputs."""
    counts.count(kprobe.launches, kprobe.KEY)
    return _plain(idx, sks, keep)


@pytest.mark.parametrize("layout_name", ("probe", "direct"))
def test_mapper_counts_probe_kernel_batches(monkeypatch, layout_name):
    """probe_kernel_batches is the kernel's launches in the map programs:
    one a batch on the prefix-probe layout, none on a direct table (the
    wrapper is never called there), and none on the CPU's plain version."""
    genome = _genome(60_000, 15)
    idx = build_index_native([("a", genome)], IndexParams(w=10, k=15))
    reads = [(n, s) for n, s, *_ in simulate_reads(genome, 24, read_len=(500, 2000), seed=3)]

    def mapper():
        with pytest.MonkeyPatch.context() as mp:
            if layout_name == "probe":
                mp.setattr(tidx, "_DM_BYTE_CAP", 1)
                mp.setattr(tidx.plan_direct_layout, "__defaults__", (1,))
            return Mapper.from_oracle_index(idx, ChainParams.defaults_for_k(15), MapParams(),
                                            device="cpu", batch_size=8)

    plain = mapper()
    assert bool(plain.dev_idx.dm_slots) == (layout_name == "direct")
    blob = plain.map_reads_paf(reads)
    assert plain.stats["probe_kernel_batches"] == 0
    calls = []
    monkeypatch.setattr(stages, "probe_prefix",
                        lambda *a: calls.append(1) or _spy_kernel(*a))
    spied = mapper()
    assert spied.map_reads_paf(reads) == blob
    st = spied.stats
    if layout_name == "probe":
        assert st["probe_kernel_batches"] == st["device_stages"] == len(calls) > 0
    else:
        assert st["probe_kernel_batches"] == 0 and not calls
    assert st["sketch_kernel_batches"] == 0
