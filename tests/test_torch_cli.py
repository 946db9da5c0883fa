"""The port's CLI (`python -m minimap2_rs_torch.cli align`) against the
JAX CLI's device engine (JAX on the CPU): the same PAF bytes on
utils.seqsim.write_test_fasta fixtures for the default flags, the
general path (-n 1 -m 10) and the k=19 preset (-x map-hifi). A cuda
request without CUDA, and flags the port does not have, exit non-zero."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")

from minimap2_rs_tpu import cli as jcli  # noqa: E402
from minimap2_rs_tpu.utils.seqsim import write_test_fasta  # noqa: E402
from minimap2_rs_torch import cli as tcli  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ref, reads = d / "ref.fa", d / "reads.fa"
    write_test_fasta(str(ref), str(reads))
    return d, str(ref), str(reads)


@pytest.mark.parametrize("flags", [[], ["-n", "1", "-m", "10"], ["-x", "map-hifi"]],
                         ids=["default", "n1m10", "map-hifi"])
def test_align_equals_jax_cli(fixtures, flags):
    d, ref, reads = fixtures
    out_t, out_j = d / "torch.paf", d / "jax.paf"
    assert tcli.main(["align", ref, reads, "--device", "cpu", "-o", str(out_t), *flags]) == 0
    assert jcli.main(["align", ref, reads, "--engine", "device", "-o", str(out_j), *flags]) == 0
    got = out_t.read_bytes()
    assert got == out_j.read_bytes()
    assert got.count(b"\n") >= 15
    if flags[:1] == ["-n"]:
        assert b"\ttp:A:S\t" in got


@pytest.mark.parametrize("suffix", [".mmi", ".idx"])
def test_align_from_a_saved_index_equals_fasta(fixtures, suffix):
    """A .mmi or native index file maps to the same bytes as the FASTA
    it was built from."""
    d, ref, reads = fixtures
    idx = tcli.load_index(ref, 10, 15)
    path = str(d / f"ref{suffix}")
    (idx.save_to_mmi if suffix == ".mmi" else idx.save_to_file)(path)
    out = []
    for r in (ref, path):
        assert tcli.main(["align", r, reads, "--device", "cpu", "-o", str(d / "i.paf")]) == 0
        out.append((d / "i.paf").read_bytes())
    assert out[0] == out[1] and out[0].count(b"\n") >= 15


def test_align_without_cuda_exits_nonzero(fixtures):
    """The default device is cuda: without CUDA the CLI refuses to map
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the refusal needs a machine without it")
    _d, ref, reads = fixtures
    res = subprocess.run(
        [sys.executable, "-m", "minimap2_rs_torch.cli", "align", ref, reads],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert res.stdout == ""
    assert "--device cpu" in res.stderr


@pytest.mark.parametrize("flag", [["-H"], ["--mesh", "2"], ["--index-shards", "2"],
                                  ["--trace-dir", "t"], ["--engine", "device"]])
def test_unsupported_flags_are_rejected(fixtures, flag):
    _d, ref, reads = fixtures
    with pytest.raises(SystemExit) as e:
        tcli.main(["align", ref, reads, "--device", "cpu", *flag])
    assert e.value.code != 0
