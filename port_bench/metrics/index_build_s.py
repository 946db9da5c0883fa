"""Host seconds of build_index_native in set-up (models/index_builder.py,
the native build of runtime/host.py), as `align` builds from a FASTA."""


def read(rec):
    return rec["setup"].get("index_build_s")
