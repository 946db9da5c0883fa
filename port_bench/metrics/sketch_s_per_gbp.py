"""Device seconds of the map programs' stage "sketch" (wire unpack
through models/stages.py sketch_compact_filter: ops/sketch.py, the
minimizer sort and filter), as the mapper stamps them on its stream
(Mapper.stats["dev_sketch"]), per Gbp of the window's read bases."""


def read(rec):
    st = rec["stats"]
    if "dev_sketch" not in st or not rec["bases"]:
        return None
    return st["dev_sketch"] / (rec["bases"] / 1e9)
