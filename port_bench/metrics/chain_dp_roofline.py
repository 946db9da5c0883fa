"""The chain-DP kernels' share, in %, of their bound in the traced window:
the candidate pairs the exact window scores over the valid anchors of
every read the window chained (Mapper.stats["chain_pairs"]), at 29
operations a pair over the H100's 67 TFLOP/s of float32 (the constants of
minimap2_rs_torch/utils/measure.py, written here so the yardstick does not
move with the program), over the device seconds of every kernel whose name
holds "chain_dp" (csrc/chain_dp.cu's designs)."""

OPS_PER_PAIR = 29
PEAK_F32_OPS = 67e12


def read(rec):
    tr, st = rec["trace"], rec["stats"]
    if not tr or not st.get("chain_pairs"):
        return None
    s = sum(v for name, v in tr["op_s"].items() if "chain_dp" in name)
    return 100.0 * st["chain_pairs"] * OPS_PER_PAIR / PEAK_F32_OPS / s if s > 0 else None
