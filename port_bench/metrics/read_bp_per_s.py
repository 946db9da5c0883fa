"""Bases of every read of every call in the window over the window's
wall time, the first call's start to the last call's end (host clock)."""


def read(rec):
    return rec["bases"] / rec["window_s"] if rec["window_s"] > 0 else None
