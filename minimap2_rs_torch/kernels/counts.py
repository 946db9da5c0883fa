"""Kernel launch accounting that holds under CUDA graph capture.

Each kernel wrapper counts its launches in a plain dict (`launches` of
kernels/chain_dp.py and kernels/window_scan.py) through `count`. Outside
a capture the count goes up at once. While a device program is being
captured (models/programs.py), the wrapper's launch is recorded into the
graph and does not run, so `count` appends the key to the recording that
`recording()` opened on this thread instead; the program adds the
recorded keys again on every replay (`replay`), which runs no Python.
The kernel inputs a wrapper keeps for a later comparison with its plain
version are taken only where `count` returns True: never inside a
capture, where a clone would be recorded into the graph.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


def count(launches: dict, key: str) -> bool:
    """One launch of `key` in `launches`: counted now (True), or, inside
    a recording, recorded for the program's replays (False). A capture on
    this thread's stream with no recording open raises: its launches
    would never be counted."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.append((launches, key))
        return False
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{key} launched into a capture with no recording open")
    launches[key] += 1
    return True


@contextlib.contextmanager
def recording():
    """While the block runs, this thread's counted launches are recorded
    instead; yields the list of (launches dict, key) they go to."""
    if getattr(_local, "rec", None) is not None:
        raise RuntimeError("a recording is already open on this thread")
    rec: list = []
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = None


def replay(recorded: list) -> None:
    """Count every launch of a recording once more: one replay of the
    program it was captured into."""
    for launches, key in recorded:
        launches[key] += 1
