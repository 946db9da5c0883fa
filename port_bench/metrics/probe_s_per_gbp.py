"""Device seconds of the map programs' stage "probe" (models/stages.py
probe: ops/index_ops.py index_lookup on the prefix-probe layout, the
stage the programs run where the index has no direct table), as the
mapper stamps them on its stream (Mapper.stats["dev_probe"]), per Gbp
of the window's read bases. Nothing on a direct-table index, whose
lookup stays inside the stage "anchors"."""


def read(rec):
    st = rec["stats"]
    if "dev_probe" not in st or not rec["bases"]:
        return None
    return st["dev_probe"] / (rec["bases"] / 1e9)
