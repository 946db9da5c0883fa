"""The port on an assembly of many contigs, against the JAX package on
the CPU (JAX as tests/test_torch_mapper.py runs it), exactly.

A 600 kb random genome is cut into 64, 65 and 100 contigs of lognormal
lengths (k=11, w=5). At 64 contigs the position table is the packed
single plane (the JAX package's condition: <= 64 sequences, total
length < 2^31); from 65 on it is the (2, P) plane pair read with two
gathers, and anchors carry reference ids past 64. Each genome is also
held with the direct-mapped table forced off, so lookups take the
prefix probe, as they do once the table would pass its 2 GB cap (an
assembly of a few hundred Mbp). Held equal to the JAX package:
  * the index builds (native, device on the CPU, the JAX oracle's);
  * DeviceIndex.from_host: flags, layout scalars and every table;
  * the anchors (lookup_keys and expand_anchors through sketch_to_anchors) of
    reads from both ends of contigs on both strands, the last included;
  * Mapper.map_reads_paf: PAF bytes equal to the JAX Mapper's and the
    oracle's on the lite path, the general path (MM2T_NO_LITE) and long
    reads of 2-5 kb whose bucket has A >= 1024 anchor slots.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_tpu.models import stages as jstages  # noqa: E402
from minimap2_rs_tpu.models.mapper import Mapper as JaxMapper  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.oracle.index import build_index  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_tpu.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import random_genome, revcomp, simulate_reads  # noqa: E402
from minimap2_rs_torch.models import mapper as tmapper  # noqa: E402
from minimap2_rs_torch.models import stages as tstages  # noqa: E402
from minimap2_rs_torch.models.index_builder import (  # noqa: E402
    build_index_device,
    build_index_native,
)
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402

torch.set_num_threads(2)

W, K = 5, 11
GENOME_LEN = 600_000
N_CONTIGS = (64, 65, 100)
LAYOUTS = ("direct", "prefix")
MP = MapParams()
CP = ChainParams.defaults_for_k(K)
SHORT_KW = dict(buckets=(256, 512), batch_size=8, mini_frac=0.6, anchor_frac=1.0)
LONG_KW = dict(buckets=(1024, 8192), batch_size=8)


def contig_lengths(total: int, n: int, rng, sigma: float = 1.5, min_len: int = 1000):
    """n lengths summing to total: min_len each plus a lognormal share of
    the rest (a scaffold-level assembly's few long and many short
    sequences)."""
    w = rng.lognormal(0.0, sigma, n)
    lens = np.floor(w / w.sum() * (total - n * min_len)).astype(np.int64) + min_len
    lens[np.argmax(lens)] += total - lens.sum()
    return lens


def cut_assembly(genome: bytes, n: int) -> list:
    """The genome cut into n contigs ctg000, ctg001, ... (cut points from
    seed 12)."""
    lens = contig_lengths(len(genome), n, np.random.default_rng(12))
    off = np.concatenate([[0], np.cumsum(lens)])
    return [(f"ctg{c:03d}", genome[off[c]:off[c + 1]]) for c in range(n)]


def reads_by_contig(records, n_reads: int, read_len, tag: int) -> list:
    """n_reads reads, simulated contig by contig in proportion to its
    length (largest remainders; seed (13, tag, contig)), so that none
    spans two contigs; named contig.readN."""
    lens = np.array([len(s) for _n, s in records], np.float64)
    share = n_reads * lens / lens.sum()
    per = np.floor(share).astype(int)
    per[np.argsort(per - share, kind="stable")[:n_reads - per.sum()]] += 1
    out = []
    for c, ((name, seq), n) in enumerate(zip(records, per)):
        out += [(f"{name}.{rn}", s) for rn, s, *_ in simulate_reads(
            seq, int(n), read_len=read_len, seed=(13, tag, c))]
    return out


def contig_ends(records, contigs, length: int = 400) -> list:
    """Both ends of each named contig, on both strands."""
    out = []
    for c in contigs:
        name, s = records[c]
        out += [(f"{name}.head", s[:length]), (f"{name}.head_rc", revcomp(s[:length])),
                (f"{name}.tail", s[-length:]), (f"{name}.tail_rc", revcomp(s[-length:]))]
    return out


def end_contigs(n: int) -> tuple:
    """The first, the 64th and 65th where they exist, and the last."""
    return tuple(sorted({0, min(63, n - 1), min(64, n - 1), n - 1}))


def force_prefix_probe(monkeypatch):
    """No direct-mapped table in either package: every layout is over the
    byte cap. _DM_BYTE_CAP is bound as plan_direct_layout's default when
    each module loads, so the default is set with it."""
    for mod in (tidx, jidx):
        monkeypatch.setattr(mod, "_DM_BYTE_CAP", 1)
        monkeypatch.setattr(mod.plan_direct_layout, "__defaults__", (1,))


@pytest.fixture(scope="module")
def genome():
    return random_genome(GENOME_LEN, seed=61)


@pytest.fixture(scope="module", params=N_CONTIGS)
def assembly(request, genome):
    records = cut_assembly(genome, request.param)
    return request.param, records, build_index_native(records, IndexParams(w=W, k=K))


@pytest.fixture(scope="module")
def assembly100(genome):
    records = cut_assembly(genome, 100)
    return records, build_index_native(records, IndexParams(w=W, k=K))


def _device_indexes(idx):
    args = (idx.keys, idx.starts, idx.counts, idx.positions)
    kw = dict(key_bits=2 * idx.k, seq_lens=[s.length for s in idx.seq])
    return tidx.DeviceIndex.from_host(*args, **kw, device="cpu"), jidx.DeviceIndex.from_host(
        *args, **kw)


def test_cut_and_reads_by_contig(genome):
    """The contigs tile the genome, a few long and many short; reads go
    to contigs in proportion to length, under unique names."""
    records = cut_assembly(genome, 100)
    assert b"".join(s for _n, s in records) == genome
    assert min(len(s) for _n, s in records) >= 1000
    lens = sorted(len(s) for _n, s in records)
    assert lens[-1] > 5 * lens[len(lens) // 2]
    reads = reads_by_contig(records, 200, (150, 450), 0)
    assert len({n for n, _s in reads}) == len(reads) == 200
    per = {}
    for n, _s in reads:
        per[n.split(".")[0]] = per.get(n.split(".")[0], 0) + 1
    longest = max(records, key=lambda r: len(r[1]))[0]
    assert per[longest] == max(per.values())


def test_index_builds_equal_at_100_contigs(assembly100):
    """The native build, the device build (on the CPU) and the JAX
    oracle's build give the same four arrays and sequence table."""
    records, idx = assembly100
    params = IndexParams(w=W, k=K)
    dev = build_index_device(records, params, device="cpu")
    ref = build_index(records, params)
    for other in (dev, ref):
        for name in ("keys", "starts", "counts", "positions"):
            np.testing.assert_array_equal(getattr(idx, name), getattr(other, name),
                                          err_msg=name)
        assert [(s.name, s.offset, s.length) for s in other.seq] == \
            [(s.name, s.offset, s.length) for s in idx.seq]
    assert int((idx.positions >> np.uint64(32)).max()) == 99


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_index_equals_jax(assembly, layout, monkeypatch):
    """Flags, layout scalars and tables equal the JAX DeviceIndex: the
    packed plane at 64 contigs, the (rid, pos) planes from 65; the
    direct table or, forced, the prefix probe's kv and prefix tables."""
    n, _records, idx = assembly
    if layout == "prefix":
        force_prefix_probe(monkeypatch)
    t, j = _device_indexes(idx)
    assert t.pos_packed == j.pos_packed == (n <= 64)
    assert t.n_seq == j.n_seq == (n if n <= 64 else 0)
    assert (t.dm_slots == 0) == (layout == "prefix")
    for name in ("prefix_shift", "bucket_slots", "n_keys", "dm_bits", "dm_slots",
                 "dm_entry", "dm_fp_bits"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("kv", "pos", "dm"):
        np.testing.assert_array_equal(getattr(t, name).numpy().view(np.uint32),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.prefix.numpy(), np.asarray(j.prefix))
    assert t.pos.shape[0] == (1 if n <= 64 else 2)
    if n <= 64:
        np.testing.assert_array_equal(t.seq_cum.numpy(), np.asarray(j.seq_cum).astype(np.int64))
    else:
        assert t.seq_cum is None and j.seq_cum is None
        # the rid plane holds every contig's id, the last included
        assert np.array_equal(np.unique(t.pos[0].numpy()), np.arange(n))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_anchors_equal_jax(assembly, layout, monkeypatch):
    """The anchors of simulated reads and of both ends of the first, the
    64th, the 65th and the last contig, on both strands: every column
    equal to the JAX stage's, with reference ids up to the last contig's
    on both strands."""
    n, records, idx = assembly
    if layout == "prefix":
        force_prefix_probe(monkeypatch)
    t, j = _device_indexes(idx)
    reads = contig_ends(records, end_contigs(n)) + reads_by_contig(records, 40, (150, 450), 1)
    L, M, A = 512, 256, 256
    codes = np.full((len(reads), L), 4, np.int32)
    for i, (_n, s) in enumerate(reads):
        codes[i, :len(s)] = nt4_encode(s)
    lengths = np.array([len(s) for _n, s in reads], np.int32)
    mid_occ = max(idx.calc_mid_occ(MP.frac_top_repetitive), MP.mid_occ_floor)
    kw = dict(w=W, k=K, q_occ_max=MP.q_occ_max, q_occ_frac=MP.q_occ_frac, M=M, A=A)
    ta = tstages.sketch_to_anchors(t, torch.from_numpy(codes), torch.from_numpy(lengths),
                                   mid_occ, **kw)
    ja = jstages.sketch_to_anchors(j, jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.int32(mid_occ), hpc=False, **kw)
    for name in ("x_hi", "x_lo", "y_hi", "y_lo", "cps"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]).astype(np.int64),
                                      err_msg=name)
    for name in ("n_anchors", "anc_ovf", "n_mini", "mini_ovf"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]), err_msg=name)
    x_hi = ta["x_hi"].numpy()
    real = x_hi != 0xFFFFFFFF
    rid, rev = x_hi[real] & 0x7FFFFFFF, x_hi[real] >> 31
    assert rid.max() == n - 1
    assert {0, 1} <= set(rev[rid == n - 1].tolist())
    assert not ta["anc_ovf"].any()


def _map_all(idx, reads, cp, kw):
    """(port PAF, JAX Mapper PAF, oracle lines, port Mapper)."""
    port = tmapper.Mapper.from_oracle_index(idx, cp, MP, device="cpu", **kw)
    blob = port.map_reads_paf(reads)
    want = JaxMapper.from_oracle_index(idx, cp, MP, **kw).map_reads_paf(reads)
    return blob, want, oracle_map(idx, reads, cp, MP), port


def _targets(blob: bytes) -> set:
    return {int(l.split(b"\t")[5][3:]) for l in blob.split(b"\n")[:-1]}


READ_SETS = ("lite", "general", "long")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("read_set", READ_SETS)
def test_map_paf_equals_jax_and_oracle(assembly100, read_set, layout, monkeypatch):
    """Mapper.map_reads_paf on the 100-contig genome: the lite path, the
    general path (MM2T_NO_LITE) and long reads (2-5 kb, the 8192 bucket
    at A >= 1024) give the JAX Mapper's bytes and the oracle's lines,
    with target names past the 64th contig."""
    records, idx = assembly100
    if layout == "prefix":
        force_prefix_probe(monkeypatch)
    if read_set == "long":
        reads = reads_by_contig(records, 12, (2000, 5000), 2)
        reads += contig_ends(records, (64, 99), length=4500)
        kw = LONG_KW
    else:
        reads = contig_ends(records, end_contigs(100)) + reads_by_contig(
            records, 60, (150, 450), 3)
        kw = SHORT_KW
    if read_set == "general":
        monkeypatch.setenv("MM2T_NO_LITE", "1")
    blob, want, oracle, port = _map_all(idx, reads, CP, kw)
    assert port._lite_eligible() == (read_set != "general")
    assert (port.dev_idx.dm_slots == 0) == (layout == "prefix")
    assert not port.dev_idx.pos_packed
    assert blob == want
    assert blob.decode().split("\n")[:-1] == oracle
    got = _targets(blob)
    assert 99 in got and max(got - {99}) > 64
    mapped = {l.split(b"\t")[0] for l in blob.split(b"\n")[:-1]}
    assert {b"ctg099.tail_rc", b"ctg064.head"} <= mapped or read_set == "long"
    if read_set == "long":
        assert port._shapes_for(8192, 1)[1] >= 1024
        assert sum(len(s) > 4096 for _n, s in reads) >= 3
        assert {b"ctg099.tail_rc", b"ctg064.head_rc"} <= mapped


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", (64, 65))
def test_lite_map_on_both_sides_of_64(genome, n, layout, monkeypatch):
    """The lite path at 64 contigs (packed plane) and 65 (two planes):
    the JAX Mapper's bytes and the oracle's lines, the last contig's ends
    mapped on both strands."""
    records = cut_assembly(genome, n)
    idx = build_index_native(records, IndexParams(w=W, k=K))
    if layout == "prefix":
        force_prefix_probe(monkeypatch)
    reads = contig_ends(records, end_contigs(n)) + reads_by_contig(records, 30, (150, 450), 4)
    blob, want, oracle, port = _map_all(idx, reads, CP, SHORT_KW)
    assert port.dev_idx.pos_packed == (n <= 64)
    assert blob == want
    assert blob.decode().split("\n")[:-1] == oracle
    last = f"ctg{n - 1:03d}".encode()
    mapped = {l.split(b"\t")[0] for l in blob.split(b"\n")[:-1]}
    assert {last + b".head", last + b".tail_rc"} <= mapped
