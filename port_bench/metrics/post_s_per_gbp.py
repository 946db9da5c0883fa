"""Host seconds of the mapper's drain post-processing (Mapper.stats["post"]:
the native runtime's PAF formatting and routing of each batch's rows) per
Gbp of the window's read bases."""


def read(rec):
    st = rec["stats"]
    return st["post"] / (rec["bases"] / 1e9) if "post" in st and rec["bases"] else None
