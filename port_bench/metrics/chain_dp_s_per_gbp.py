"""Device seconds of the chain-DP kernels (every kernel whose name holds
"chain_dp": csrc/chain_dp.cu's designs) in the traced window, per Gbp of
the window's read bases."""


def read(rec):
    tr = rec["trace"]
    if not tr or not rec["bases"]:
        return None
    s = sum(v for name, v in tr["op_s"].items() if "chain_dp" in name)
    return s / (rec["bases"] / 1e9) if s > 0 else None
