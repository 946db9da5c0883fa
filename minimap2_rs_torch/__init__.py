"""minimap2_rs_torch — the PyTorch/CUDA port of minimap2_rs_tpu.

The JAX package `minimap2_rs_tpu` stays the reference: every module here
keeps the name of its JAX counterpart, and the tests hold each one
against it bit for bit. The port covers both mapping paths of
`models.mapper.Mapper.map_reads_paf`, the default "lite" path and the
general path (min_cnt < 2: secondaries, s2, the host rescue decision),
for odd k <= 27 and non-HPC queries, and the `align` command
(`python -m minimap2_rs_torch.cli align`). The chaining DP is a CUDA
kernel written for Hopper (`csrc/chain_dp.cu`) in two variants.

The port imports torch and numpy, never jax, and nothing of
`minimap2_rs_tpu`: it keeps its own copies of the host modules
(`config`, `oracle`, `utils`, `io`, and `runtime.host` with the C++
source of the native formatter, encoder and postprocess, which it
compiles at first use into build/host/).

Devices are explicit: every entry point takes `device`, and nothing
falls back to the CPU because CUDA is missing.
"""

__version__ = "0.1.0"
