"""Device seconds of the map programs' stage "chain" (the lite path's
models/stages.py chain_finalize_lite: the chain DP and ops/finalize_ops.py;
the general path's chain DP and pack), as the mapper stamps them on its
stream (Mapper.stats["dev_chain"]), per Gbp of the window's read bases."""


def read(rec):
    st = rec["stats"]
    if "dev_chain" not in st or not rec["bases"]:
        return None
    return st["dev_chain"] / (rec["bases"] / 1e9)
