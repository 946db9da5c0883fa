"""Device seconds of the map programs' stage "anchors" (models/stages.py
lookup_expand: the index lookup, anchor expansion and sort of
ops/seeds_ops.py), as the mapper stamps them on its stream
(Mapper.stats["dev_anchors"]), per Gbp of the window's read bases."""


def read(rec):
    st = rec["stats"]
    if "dev_anchors" not in st or not rec["bases"]:
        return None
    return st["dev_anchors"] / (rec["bases"] / 1e9)
