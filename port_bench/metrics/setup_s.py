"""Process start to the window's start (host clock): imports, the kernel
libraries' load or build, the genome and read pool, the index build, the
mapper's upload and the warm-up calls."""


def read(rec):
    return rec["setup_s"]
