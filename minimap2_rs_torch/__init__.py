"""minimap2_rs_torch — the PyTorch/CUDA port of minimap2_rs_tpu.

The JAX package `minimap2_rs_tpu` stays the reference: every module here
keeps the name of its JAX counterpart, and the tests hold each one
against it bit for bit. The port covers both mapping paths of
`models.mapper.Mapper.map_reads_paf`, the default "lite" path and the
general path (min_cnt < 2: secondaries, s2, the host rescue decision),
for every k <= 28 and HPC indexes; the device index build; the CLI's
`index`, `anchors`, `chain` and `align`; and the multi-GPU mapper
(`parallel/`, `models.mesh_mapper`: a mesh of torch.distributed ranks,
the index hash-range-sharded). The chaining DP and the even-k window
scan are CUDA kernels written for Hopper (`csrc/`).

The port imports torch and numpy, never jax, and nothing of
`minimap2_rs_tpu`: it keeps its own copies of the host modules
(`config`, `oracle`, `utils`, `io`, and `runtime.host` with the C++
source of the native formatter, encoder and postprocess, which it
compiles at first use into build/host/).

Devices are explicit: every entry point takes `device`, and nothing
falls back to the CPU because CUDA is missing.
"""

__version__ = "0.1.0"
