"""The port on a reference in the shape of a human one, against the JAX
package on the CPU (JAX as tests/test_torch_contigs.py runs it), exactly.

chip_smoke.py's chm13 phase maps 3,117,292,070 bases in T2T-CHM13v2.0's
25 sequences on the card. Two of the layout decisions it reaches are
held here at a small size:
  * the length half of the packed position plane's condition (total
    length < 2^31 and <= 64 sequences): 300 kb of real bases in 25
    sequences named as CHM13's, whose declared lengths (the SeqMeta
    lengths both packages receive, and so `seq_lens` of
    DeviceIndex.from_host) are CHM13's and sum past 2^31. Both packages
    refuse the packed plane by length alone; the PAF's target lengths
    are the declared ones;
  * bucket_slots past 16: _MAX_PREFIX_BITS set down in both packages'
    index_ops (with the direct table off, as above its byte cap), so the
    prefix planner stops at 15 and 13 bits and widens the slots to 32
    and 64 rows a key.
Held equal to the JAX package: every table and layout scalar, the
anchors, and Mapper.map_reads_paf's bytes on the lite and the general
path (and to the oracle). Besides: the phase's lengths and cut, and the
port's index files (.mmi and the native format) against the JAX
package's, bytes written and arrays read back.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.models import stages as jstages  # noqa: E402
from minimap2_rs_tpu.models.mapper import Mapper as JaxMapper  # noqa: E402
from minimap2_rs_tpu.ops import index_ops as jidx  # noqa: E402
from minimap2_rs_tpu.oracle.index import OracleIndex as JOracleIndex  # noqa: E402
from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map  # noqa: E402
from minimap2_rs_torch.config import ChainParams, IndexParams, MapParams  # noqa: E402
from minimap2_rs_torch.models import mapper as tmapper  # noqa: E402
from minimap2_rs_torch.models import stages as tstages  # noqa: E402
from minimap2_rs_torch.models.index_builder import build_index_native  # noqa: E402
from minimap2_rs_torch.ops import index_ops as tidx  # noqa: E402
from minimap2_rs_torch.oracle.index import OracleIndex, SeqMeta  # noqa: E402
from minimap2_rs_torch.utils.packing import nt4_encode  # noqa: E402
from minimap2_rs_torch.utils.seqsim import random_genome, revcomp  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
W, K = 10, 15  # the phase's
SEQ_BP = 12_000  # real bases a sequence
MP = MapParams()
CP = ChainParams.defaults_for_k(K)
KW = dict(buckets=(1024,), batch_size=8)
# layout -> (_MAX_PREFIX_BITS, bucket_slots); None: the planner's own
LAYOUTS = {"direct": (None, None), "S32": (15, 32), "S64": (13, 64)}


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (it runs nothing when imported)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chm13(smoke):
    """(records, index with CHM13's declared lengths, index with the real
    ones, reads): SEQ_BP real bases in each of the 25 sequences."""
    names = [n for n, _l in smoke.chm13_lengths()]
    genome = random_genome(SEQ_BP * len(names), seed=71)
    records = smoke.cut_records(genome, [(n, SEQ_BP) for n in names])
    real = build_index_native(records, IndexParams(w=W, k=K))
    declared, off = [], 0
    for name, length in smoke.chm13_lengths():
        declared.append(SeqMeta(name=name, offset=off, length=length))
        off += length
    idx = dataclasses.replace(real, seq=declared)
    reads = smoke._assembly_reads(records, 50, (500, 1000), 0)
    for name, s in (records[0], records[-1]):
        reads += [(f"{name}.head", s[:900]), (f"{name}.tail_rc", revcomp(s[-900:]))]
    return records, idx, real, reads


def set_layout(monkeypatch, layout: str):
    """The layout in both packages: the planner's own, or the prefix
    probe (every direct layout over the byte cap; the cap is bound as
    plan_direct_layout's default when each module loads, so the default
    is set with it) capped at _MAX_PREFIX_BITS bits."""
    bits, _S = LAYOUTS[layout]
    if bits is None:
        return
    for mod in (tidx, jidx):
        monkeypatch.setattr(mod, "_DM_BYTE_CAP", 1)
        monkeypatch.setattr(mod.plan_direct_layout, "__defaults__", (1,))
        monkeypatch.setattr(mod, "_MAX_PREFIX_BITS", bits)


def _device_indexes(idx):
    args = (idx.keys, idx.starts, idx.counts, idx.positions)
    kw = dict(key_bits=2 * idx.k, seq_lens=[s.length for s in idx.seq])
    return (tidx.DeviceIndex.from_host(*args, **kw, device="cpu"),
            jidx.DeviceIndex.from_host(*args, **kw))


def test_chm13_lengths_and_cut(smoke):
    """The phase's 25 sequences: T2T-CHM13v2.0's names and lengths in
    order, summing to 3,117,292,070 (past 2^31), computed without the
    genome; the cut tiles a genome in order and refuses one it does not
    cover."""
    lengths = smoke.chm13_lengths()
    assert [n for n, _l in lengths] == [f"chr{c}" for c in range(1, 23)] + [
        "chrX", "chrY", "chrM"]
    assert sum(l for _n, l in lengths) == smoke.CHM13_BP == 3_117_292_070 > 1 << 31
    assert dict(lengths)["chr1"] == max(l for _n, l in lengths) == 248_387_328
    assert dict(lengths)["chrM"] == 16_569 and dict(lengths)["chrX"] == 154_259_566
    assert len(lengths) == 25 <= 64
    genome = random_genome(25 * 200, seed=3)
    small = [(n, 200) for n, _l in lengths]
    records = smoke.cut_records(genome, small)
    assert [n for n, _s in records] == [n for n, _l in lengths]
    assert b"".join(s for _n, s in records) == genome
    with pytest.raises(ValueError):
        smoke.cut_records(genome + b"A", small)


def test_declared_lengths_refuse_the_packed_plane(chm13):
    """25 sequences pass the count half of the condition; CHM13's declared
    total refuses the packed plane in both packages, where the real
    lengths (300 kb) take it."""
    _records, idx, real, _reads = chm13
    t, j = _device_indexes(idx)
    assert t.pos_packed is False and not j.pos_packed
    assert t.n_seq == j.n_seq == 0 and t.seq_cum is None and j.seq_cum is None
    assert t.pos.shape[0] == 2
    t_real, j_real = _device_indexes(real)
    assert t_real.pos_packed is True and j_real.pos_packed
    assert t_real.n_seq == j_real.n_seq == 25


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_index_equals_jax(chm13, layout, monkeypatch):
    """Flags, layout scalars and every table equal the JAX DeviceIndex:
    the planner's direct table, and the prefix probe at 32 and 64 slots a
    key."""
    _records, idx, _real, _reads = chm13
    set_layout(monkeypatch, layout)
    t, j = _device_indexes(idx)
    _bits, S = LAYOUTS[layout]
    assert (t.dm_slots == 0) == (S is not None)
    if S is not None:
        assert t.bucket_slots == S and t.prefix.shape[0] == (1 << _bits) + 1
    for name in ("prefix_shift", "bucket_slots", "n_keys", "dm_bits", "dm_slots",
                 "dm_entry", "dm_fp_bits", "pos_packed", "n_seq"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("kv", "pos", "dm"):
        np.testing.assert_array_equal(getattr(t, name).numpy().view(np.uint32),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.prefix.numpy(), np.asarray(j.prefix))
    assert np.array_equal(np.unique(t.pos[0].numpy()), np.arange(25))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_anchors_equal_jax(chm13, layout, monkeypatch):
    """The anchors of the reads (both ends of chr1 and chrM among them):
    every column equal to the JAX stage's, reference ids up to 24 on both
    strands."""
    _records, idx, _real, reads = chm13
    set_layout(monkeypatch, layout)
    t, j = _device_indexes(idx)
    L, M, A = 1024, 256, 512
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
    assert rid.max() == 24 and {0, 1} <= set(rev[rid == 24].tolist())
    assert not ta["anc_ovf"].any()


@pytest.mark.parametrize("path,layout", [("lite", "direct"), ("general", "direct"),
                                         ("lite", "S32"), ("lite", "S64")])
def test_map_paf_equals_jax_and_oracle(chm13, path, layout, monkeypatch):
    """Mapper.map_reads_paf gives the JAX Mapper's bytes and the oracle's
    lines on the lite and the general path (MM2T_NO_LITE), with every
    target length CHM13's declared one; the lite path again through the
    prefix probe at 32 and 64 slots a key."""
    _records, idx, _real, reads = chm13
    set_layout(monkeypatch, layout)
    if path == "general":
        monkeypatch.setenv("MM2T_NO_LITE", "1")
    port = tmapper.Mapper.from_oracle_index(idx, CP, MP, device="cpu", **KW)
    blob = port.map_reads_paf(reads)
    assert port._lite_eligible() == (path == "lite")
    assert not port.dev_idx.pos_packed
    if LAYOUTS[layout][1]:
        assert port.dev_idx.bucket_slots == LAYOUTS[layout][1] and not port.dev_idx.dm_slots
    assert blob == JaxMapper.from_oracle_index(idx, CP, MP, **KW).map_reads_paf(reads)
    lines = blob.decode().split("\n")[:-1]
    assert lines == oracle_map(idx, reads, CP, MP)
    declared = {s.name: s.length for s in idx.seq}
    targets = {l.split("\t")[5]: int(l.split("\t")[6]) for l in lines}
    assert {"chr1", "chrM", "chrY"} <= set(targets) and len(targets) >= 20
    assert all(declared[n] == ln for n, ln in targets.items())
    assert targets["chr1"] == 248_387_328
    mapped = {l.split("\t", 1)[0] for l in lines}
    assert {"chr1.head", "chrM.tail_rc"} <= mapped


@pytest.mark.parametrize("fmt", ["mmi", "native"])
def test_index_files_equal_jax(chm13, fmt, tmp_path):
    """The port's index files: the JAX package's bytes written, and its
    arrays read back; also a file whose key blocks are out of position
    order, which the reader sorts as the JAX one does."""
    _records, _idx, real, _reads = chm13
    save, load = (("save_to_mmi", "load_from_mmi") if fmt == "mmi"
                  else ("save_to_file", "load_from_file"))
    jreal = JOracleIndex(**{f.name: getattr(real, f.name)
                            for f in dataclasses.fields(JOracleIndex)})
    # a key block whose positions descend
    u = int(np.argmax(real.counts))
    pos = real.positions.copy()
    s, c = int(real.starts[u]), int(real.counts[u])
    pos[s:s + c] = pos[s:s + c][::-1]
    shuffled = dataclasses.replace(real, positions=pos)
    for name, ix in (("sorted", real), ("descending block", shuffled)):
        mine, theirs = tmp_path / f"{name}.port", tmp_path / f"{name}.jax"
        getattr(ix, save)(str(mine))
        getattr(dataclasses.replace(jreal, positions=ix.positions), save)(str(theirs))
        assert mine.read_bytes() == theirs.read_bytes(), name
        got = getattr(OracleIndex, load)(str(mine))
        want = getattr(JOracleIndex, load)(str(mine))
        for f in ("keys", "starts", "counts", "positions", "S"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        assert [(q.name, q.offset, q.length) for q in got.seq] == [
            (q.name, q.offset, q.length) for q in want.seq]
        np.testing.assert_array_equal(got.positions, real.positions)
    golden = ROOT / "tests" / "golden" / "golden_w10k15.mmi"
    if fmt == "mmi":
        got, want = OracleIndex.load_from_mmi(str(golden)), JOracleIndex.load_from_mmi(
            str(golden))
        for f in ("keys", "starts", "counts", "positions", "S"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
