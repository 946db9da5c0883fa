"""The chain-DP wrapper's choice between its four designs (the
short-read kernel, the block-per-read lane kernel, the pruned kernel with
the read in shared memory and the warp-per-read template), made in Python
by shape before any launch; the entry points
it can form, against the library's bindings and the source; and the tie
rule every kernel's reduction must keep: the plain versions, like the
JAX scan DP, take the largest j among equal scores."""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from minimap2_rs_tpu.config import ChainParams as JChainParams  # noqa: E402
from minimap2_rs_tpu.ops import chain_ops as jchain  # noqa: E402
from minimap2_rs_torch.config import ChainParams  # noqa: E402
from minimap2_rs_torch.kernels import build as kbuild  # noqa: E402
from minimap2_rs_torch.kernels import chain_dp as kchain  # noqa: E402
from minimap2_rs_torch.ops.chain_ops import (  # noqa: E402
    chain_dp_aux_batch_ref,
    chain_dp_batch_ref,
    chain_scalars_from_params,
    log2_table,
)

torch.set_num_threads(2)

CHAIN_CU = kbuild.CSRC / "chain_dp.cu"

# (A, window, aux, max_chain_skip) -> the design
DISPATCH = {
    "lite long reads (aux, A=4480, H=1024)": (4480, 1024, True, None, "lane"),
    "general long reads (A=4480, H=4480)": (4480, 5000, False, None, "lane"),
    "largest general shape (A=11904, H=5000)": (11904, 5000, False, None, "lane"),
    "aux at A=11904, H=5000": (11904, 5000, True, None, "lane"),
    "lane, window below A": (1024, 128, True, None, "lane"),
    "aux ring at the limit (H=6720)": (8192, 6720, True, None, "lane"),
    "static (A=256)": (256, 256, True, None, "short"),
    "static, window past A": (256, 5000, False, None, "short"),
    "dynamic (A=256, H=64)": (256, 64, False, None, "short"),
    "dynamic aux (A=256, H=128)": (256, 128, True, None, "short"),
    "dynamic (A=384, H=200)": (384, 200, False, None, "short"),
    "static aux (A=384)": (384, 384, True, None, "short"),
    "static (A=384)": (384, 5000, False, None, "short"),
    "static aux (A=768, the 4x tier)": (768, 768, True, None, "short"),
    "static (A=768)": (768, 5000, False, None, "short"),
    "dynamic aux (A=384, H=128)": (384, 128, True, None, "short"),
    "dynamic (A=768, H=256)": (768, 256, False, None, "short"),
    "dynamic aux (A=768, H=1)": (768, 1, True, None, "short"),
    "largest short shape (aux, A=1023)": (1023, 1023, True, None, "short"),
    "pruned static aux (A=256)": (256, 256, True, 25, "smem"),
    "pruned static (A=768)": (768, 5000, False, 25, "smem"),
    "pruned dynamic aux (A=384, H=128)": (384, 128, True, 0, "smem"),
    "pruned lane": (4480, 5000, False, 25, "smem"),
    "pruned lane aux": (4480, 1024, True, 25, "smem"),
    "pruned CLI lane (A=1152)": (1152, 5000, False, 25, "smem"),
    "pruned aux at the limit (A=5811)": (5811, 5000, True, 25, "smem"),
    "pruned aux over 227 KB (A=5812)": (5812, 5000, True, 25, "template"),
    "pruned (f, prev) over 227 KB (A=8320)": (8320, 5000, False, 25, "template"),
    "aux ring over 227 KB (H=6721)": (8192, 6721, True, None, "template"),
    "(f, prev) ring over 227 KB (H=12000)": (12288, 12000, False, None, "template"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_lane_design_by_shape(case):
    A, window, aux, skip, want = DISPATCH[case]
    assert kchain.design(A, window, aux, skip) == want
    if skip is None and A >= 1024:
        ring = kchain.lane_ring_bytes(min(window, A), aux)
        assert (ring <= kchain.LANE_SMEM_MAX) is (want == "lane")
    if skip is None and A < 1024:
        assert kchain.short_block_bytes(A, aux) <= kchain.SHORT_SMEM_MAX
    if skip is not None:
        fits = kchain.prune_block_bytes(A, aux) <= kchain.PRUNE_SMEM_MAX
        assert fits is (want == "smem")


def _launched_entries(monkeypatch, A, window, aux, skip):
    """The entries the wrapper launches for one (1, A) call on a CUDA
    device, and the launch counts; the launch itself is replaced, as this
    machine has no card."""
    entries = []

    def fake_launch(entry, n_out, grp, *_a, **_k):
        entries.append(entry)
        return tuple(torch.zeros_like(grp) for _ in range(n_out))

    monkeypatch.setattr(kchain, "_validate", lambda *a, **k: torch.device("cuda"))
    monkeypatch.setattr(kchain, "_launch", fake_launch)
    monkeypatch.setattr(kchain, "captured", None)
    monkeypatch.setattr(kchain, "launches", dict.fromkeys(kchain.launches, 0))
    cols = [torch.zeros((1, A), dtype=torch.int32) for _ in range(4)]
    wrapper = kchain.chain_dp_aux_batch if aux else kchain.chain_dp_batch
    outs = wrapper(*cols, chain_scalars_from_params(ChainParams()), window,
                   log2_table(501), skip)
    assert len(outs) == (4 if aux else 2)
    return entries, {k: v for k, v in kchain.launches.items() if v}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_wrapper_launches_the_chosen_entry(case, monkeypatch):
    """On a CUDA device the wrapper launches the chosen design's entry
    point (the template's, or its pruned instance, with no suffix) and
    counts the launch under the Pallas shape class whatever the design."""
    A, window, aux, skip, want = DISPATCH[case]
    entries, counts = _launched_entries(monkeypatch, A, window, aux, skip)
    variant = ("chain_dp_aux" if aux else "chain_dp") + ("_prune" if skip is not None else "")
    assert entries == [f"mm2t_{variant}" + ("" if want == "template" else f"_{want}")]
    assert counts == {f"{variant}/{kchain.shape_class(A, window)}": 1}


def test_short_blocks_over_the_limit_take_the_template(monkeypatch):
    """A short shape whose block would not fit shared memory takes the
    template; at a limit of one byte less than the aux block at A = 768,
    the smaller (f, prev) block still takes the short-read kernel."""
    monkeypatch.setattr(kchain, "SHORT_SMEM_MAX", kchain.short_block_bytes(768, True) - 1)
    assert kchain.design(768, 768, True, None) == "template"
    assert kchain.design(768, 768, False, None) == "short"
    assert kchain.design(256, 64, True, None) == "short"
    entries, counts = _launched_entries(monkeypatch, 768, 768, True, None)
    assert entries == ["mm2t_chain_dp_aux"]
    assert counts == {"chain_dp_aux/static": 1}


def _formable_entries():
    """Every entry point the wrapper can form: each variant in each
    design its shapes reach."""
    names = set()
    for A, window, aux, skip, _want in DISPATCH.values():
        variant = ("chain_dp_aux" if aux else "chain_dp") + ("_prune" if skip is not None else "")
        names.add(kchain.entry_point(variant, kchain.design(A, window, aux, skip)))
    return names


def test_every_formable_entry_is_bound_and_defined():
    """Each entry point the wrapper can form is bound by kernels/build.py
    and has an extern "C" definition in csrc/chain_dp.cu."""
    formed = _formable_entries()
    assert len(formed) == 10  # 2 variants x 3 designs + 2 pruned instances x 2
    bound = {name for name, _n, _p in kbuild.CHAIN_ENTRIES}
    defined = set(re.findall(r'extern "C" int (\w+)\(', CHAIN_CU.read_text()))
    assert formed <= bound <= defined, (formed - bound, bound - defined)


@pytest.mark.parametrize("py_name,c_name", [
    ("LANE_THREADS", "kLaneThreads"), ("SHORT_READS", "kShortReads"),
    ("SHORT_TAB", "kShortTab"),
])
def test_wrapper_constants_match_the_source(py_name, c_name):
    """The wrapper sizes each design's shared memory with the source's
    constants."""
    found = re.findall(rf"constexpr int {c_name} = (\d+);", CHAIN_CU.read_text())
    assert found == [str(getattr(kchain, py_name))]


def tie_read():
    """Four anchors on one strand where anchor 3 scores 43 from both
    anchor 1 (f = 30, a chain of 2 from anchor 0; 15 - 2 from its span)
    and anchor 2 (f = 30 on its own, as its diagonal is out of anchor 0's
    band; 15 - 2 from the gap dg = 15), at bw = 60 with no linear
    penalties. The largest j, 2, must win: prev 2, cnt 2 and the chain
    start of anchor 2, where j = 1 would give cnt 3 and (0, 0)."""
    grp = np.zeros((1, 4), np.int32)
    rpos = np.array([[0, 100, 250, 265]], np.int32)
    qpos = np.array([[0, 100, 150, 215]], np.int32)
    span = np.array([[15, 15, 30, 15]], np.int32)
    return grp, rpos, qpos, span


TIE_KW = dict(bw=60, chn_pen_gap=0.0, chn_pen_skip=0.0)


@pytest.mark.parametrize("pad", [0, 1021])
def test_plain_versions_break_ties_to_the_largest_j(pad):
    """The tie on its own and at a lane shape (A = 1025, padding after)."""
    arrs = tie_read()
    if pad:
        fill = dict(zip(range(4), (-1, -1, -1, 255)))
        arrs = tuple(np.concatenate([a, np.full((1, pad), fill[c], np.int32)], axis=1)
                     for c, a in enumerate(arrs))
    cols = tuple(torch.from_numpy(a) for a in arrs)
    scal = chain_scalars_from_params(ChainParams.defaults_for_k(15, **TIE_KW))
    tab = log2_table(61)
    A = arrs[0].shape[1]
    f, prev = chain_dp_batch_ref(*cols, scal, A, tab)
    f2, cnt, sq, sr = chain_dp_aux_batch_ref(*cols, scal, A, tab)
    assert f[0, :4].tolist() == f2[0, :4].tolist() == [15, 30, 30, 43]
    assert prev[0, :4].tolist() == [-1, 0, -1, 2]
    assert cnt[0, :4].tolist() == [1, 2, 1, 2]
    assert (sq[0, 3].item(), sr[0, 3].item()) == (150, 250)
    # the JAX package's scan DP, the contract, agrees
    jscal = jchain.chain_scalars_from_params(JChainParams.defaults_for_k(15, **TIE_KW))
    jargs = (jnp.asarray(arrs[0].view(np.uint32)),) + tuple(jnp.asarray(a) for a in arrs[1:])
    jf, jprev = jchain.chain_dp_batch(*jargs, jscal, A)
    np.testing.assert_array_equal(np.asarray(jprev), prev.numpy())
    np.testing.assert_array_equal(np.asarray(jf), f.numpy())
    jaux = jchain.chain_dp_aux_batch(*jargs, jscal, A)
    for g, w in zip((f2, cnt, sq, sr), jaux):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("aux", [False, True], ids=["f_prev", "aux"])
@pytest.mark.parametrize("skip", [None, 25])
def test_template_batch_launches_the_template(monkeypatch, aux, skip):
    """template_batch, which times the previous design, forms the
    template's entry (its pruned instance with max_chain_skip) and counts
    nothing; on CPU tensors it raises."""
    entries = []

    def fake_launch(entry, n_out, grp, *_a, **_k):
        entries.append(entry)
        return tuple(torch.zeros_like(grp) for _ in range(n_out))

    cols = [torch.zeros((1, 256), dtype=torch.int32) for _ in range(4)]
    scal = chain_scalars_from_params(ChainParams())
    with pytest.raises(ValueError):
        kchain.template_batch(aux, *cols, scal, 256, log2_table(501), skip)
    monkeypatch.setattr(kchain, "_validate", lambda *a, **k: torch.device("cuda"))
    monkeypatch.setattr(kchain, "_launch", fake_launch)
    monkeypatch.setattr(kchain, "launches", dict.fromkeys(kchain.launches, 0))
    outs = kchain.template_batch(aux, *cols, scal, 256, log2_table(501), skip)
    assert len(outs) == (4 if aux else 2)
    variant = ("chain_dp_aux" if aux else "chain_dp") + ("" if skip is None else "_prune")
    assert entries == [f"mm2t_{variant}"]
    assert not any(kchain.launches.values())
