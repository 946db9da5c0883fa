"""The port's CLI (`python -m minimap2_rs_torch.cli`) against the JAX
CLI (JAX on the CPU), on utils.seqsim.write_test_fasta fixtures: `align`
gives the same PAF bytes for the default flags, the general path
(-n 1 -m 10), the k=19 preset (-x map-hifi), -H, --engine host and
--trace-dir; `index` the same stdout and dumped .mmi bytes for each
engine; `anchors` and `chain` the same stdout for each engine at odd and
even k; `align --mesh 1` the JAX CLI's `--mesh 1` bytes, and 2 ranks
under torchrun the single-device bytes. A cuda request
without CUDA, and a mesh of more ranks than the launch has, exit
non-zero. The port's parser takes every option of the JAX one (`-a`
included, ignored as there)."""

import argparse
import os
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
                                  ["--trace-dir", "t"], ["--engine", "device"],
                                  ["--mesh", "1"], ["--engine", "host", "--mesh", "1"]])
def test_unsupported_flags_are_rejected(fixtures, flag):
    """--mesh 2 and --index-shards 2 need more ranks than a launch
    without torchrun has, and --mesh with --engine host has no device to
    map on: they exit non-zero, leaving no process group. -H,
    --trace-dir, --engine device and --mesh 1 give the JAX CLI's bytes."""
    d, ref, reads = fixtures
    argv = ["align", ref, reads, "-o", str(d / "f.paf")]
    if flag[:2] in (["--mesh", "2"], ["--index-shards", "2"], ["--engine", "host"]):
        with pytest.raises(SystemExit) as e:
            tcli.main([*argv, "--device", "cpu", *flag])
        assert e.value.code != 0
        assert not torch.distributed.is_initialized()
        return
    port_flag = [flag[0], str(d / "trace")] if flag[0] == "--trace-dir" else flag
    assert tcli.main([*argv, "--device", "cpu", *port_flag]) == 0
    got = (d / "f.paf").read_bytes()
    jflag = [] if flag[0] == "--trace-dir" else flag
    assert jcli.main([*argv, "--engine", "device", *jflag]) == 0
    assert got == (d / "f.paf").read_bytes() and got.count(b"\n") >= 15
    if flag[0] == "--trace-dir":
        assert (d / "trace" / "trace.json").stat().st_size > 0


def test_align_mesh_under_torchrun(fixtures):
    """align --mesh 1 --index-shards 2 under torchrun (2 gloo ranks on the
    CPU, the group from its environment): rank 0 writes the single-device
    bytes and, with --stats, its collectives."""
    d, ref, reads = fixtures
    out = d / "torchrun.paf"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "minimap2_rs_torch.cli", "align", ref, reads,
         "--mesh", "1", "--index-shards", "2", "--device", "cpu", "--stats",
         "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stderr.count("[mm2t] collectives of rank 0:") == 1
    assert tcli.main(["align", ref, reads, "--device", "cpu", "-o", str(d / "one.paf")]) == 0
    assert out.read_bytes() == (d / "one.paf").read_bytes()
    assert out.read_bytes().count(b"\n") >= 15


def test_align_host_engine_equals_jax(fixtures):
    d, ref, reads = fixtures
    out = []
    for main in (tcli.main, jcli.main):
        assert main(["align", ref, reads, "--engine", "host", "-o", str(d / "h.paf")]) == 0
        out.append((d / "h.paf").read_bytes())
    assert out[0] == out[1] and out[0].count(b"\n") >= 15


@pytest.mark.parametrize("engine", ["auto", "native", "device", "host"])
def test_index_equals_jax_cli(fixtures, engine, capsys):
    """Same stdout and the same dumped .mmi bytes, engine by engine; the
    port's device engine runs on --device."""
    d, ref, _reads = fixtures
    out = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        mmi = d / f"{engine}.{len(out)}.mmi"
        assert main(["index", ref, "-d", str(mmi), "--engine", engine, *extra]) == 0
        out.append((capsys.readouterr().out, mmi.read_bytes()))
    assert out[0] == out[1]
    assert out[0][0].startswith("kmer size: 15; skip: 10; is_hpc: 0") and len(out[0][1]) > 1000


@pytest.mark.parametrize("command", ["anchors", "chain"])
@pytest.mark.parametrize("k", [15, 14])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_anchors_and_chain_equal_jax_cli(fixtures, command, k, engine, capsys):
    _d, ref, reads = fixtures
    argv = [command, ref, reads, "-k", str(k), "--engine", engine]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    n = int(got.split("\n")[0].split(": ")[1])
    assert n > 10, got


def test_anchor_overflow_goes_to_the_host_oracle(fixtures, capsys, monkeypatch):
    """A query that overflows the device capacities takes the host
    oracle's anchors (the JAX CLI's contract), said on stderr."""
    _d, ref, reads = fixtures
    argv = ["anchors", ref, reads, "--device", "cpu"]
    assert tcli.main([*argv, "--engine", "host"]) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(tcli, "_device_anchors", lambda *a: None)
    assert tcli.main([*argv, "--engine", "device"]) == 0
    got = capsys.readouterr()
    assert got.out == want and "overflow" in got.err


def _subcommand_options(parser) -> dict:
    """{subcommand: its option strings} of an argparse parser."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: set(p._option_string_actions) for name, p in sub.choices.items()}


def test_port_parser_accepts_every_jax_option():
    """Every subcommand of the JAX CLI, and every option string it takes,
    exists on the port's (whose extras, such as --device, are its own)."""
    jax_opts, port_opts = (_subcommand_options(m.build_parser()) for m in (jcli, tcli))
    assert set(jax_opts) <= set(port_opts)
    missing = {c: sorted(o - port_opts[c]) for c, o in jax_opts.items() if o - port_opts[c]}
    assert not missing, missing
    assert "-a" in port_opts["align"]


def test_align_a_maps_as_without_it(fixtures):
    """`align -a` (SAM output, which the JAX CLI accepts and ignores) gives
    the bytes of `align`."""
    d, ref, reads = fixtures
    out = []
    for extra in ([], ["-a"]):
        assert tcli.main(["align", *extra, ref, reads, "--device", "cpu", "-o",
                          str(d / "a.paf")]) == 0
        out.append((d / "a.paf").read_bytes())
    assert out[0] == out[1] and out[0].count(b"\n") >= 15
