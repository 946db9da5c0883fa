"""Launch and collective accounting that holds under CUDA graph capture.

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

A collective (parallel/mesh.py) keeps richer statistics than a count:
inside a recording it hands `defer` the function that accounts for one
call, and every replay calls it again.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


def _recorded(entry) -> bool:
    """Append `entry` to this thread's open recording (True), or return
    False when none is open. A capture on this thread's stream with no
    recording open raises: what it captures would never be counted."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.append(entry)
        return True
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{entry} issued into a capture with no recording open")
    return False


def count(launches: dict, key: str) -> bool:
    """One launch of `key` in `launches`: counted now (True), or, inside
    a recording, recorded for the program's replays (False)."""
    if _recorded((launches, key)):
        return False
    launches[key] += 1
    return True


def defer(fn) -> bool:
    """Inside a recording, keep fn (no arguments) to be called on each
    replay of the program and return True; outside one, return False:
    the caller accounts for the work now."""
    return _recorded(fn)


@contextlib.contextmanager
def recording():
    """While the block runs, this thread's counted launches are recorded
    instead; yields the list they go to: (launches dict, key) pairs, and
    the functions handed to `defer`."""
    if getattr(_local, "rec", None) is not None:
        raise RuntimeError("a recording is already open on this thread")
    rec: list = []
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = None


def replay(recorded: list) -> None:
    """Count every launch of a recording once more, and call every
    deferred function: one replay of the program it was captured into."""
    for entry in recorded:
        if callable(entry):
            entry()
        else:
            launches, key = entry
            launches[key] += 1
