"""The traced run's reduction: torch.profiler's events -> the device's
busy time, time by device operation, and the idle gaps.

The harness wraps the measured window in a span named WINDOW and each
call in a span named CALL + its index. Device operations (kernels,
copies, sets) are clipped to the window; busy time is the length of
their union. A gap is a stretch of the window in which no device
operation runs; it is labelled by what the host was doing at its
middle: the innermost host event there, or, where no torch event covers
it, the host code outside torch (the mapper's native runtime and Python)
of that call.
"""

from __future__ import annotations

import bisect

WINDOW = "port_bench.window"
CALL = "port_bench.call."


def _is_device(ev) -> bool:
    """A device operation: not a host event, and not the device-side
    copy of a record_function range (kineto's gpu_user_annotation,
    which spans the kernels of the range and is no work of its own)."""
    if str(ev.device_type()).rsplit(".", 1)[-1] == "CPU":
        return False
    annotation = getattr(ev, "is_user_annotation", None)
    return not ((annotation is not None and annotation()) or ev.name().startswith("port_bench."))


def summarize(events) -> dict | None:
    """{window_s, busy_s, op_s: {name: seconds}, gaps: [(label, seconds)]
    longest first}, from profiler events (kineto_results.events());
    None when the window span is missing."""
    win = [ev for ev in events
           if ev.name() == WINDOW and str(ev.device_type()).endswith("CPU")]
    if not win:
        return None
    ws, we = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if _is_device(ev):
            s, e = max(s, ws), min(e, we)
            if e > s:
                dev.append((s, e, ev.name()))
        elif str(ev.device_type()).endswith("CPU") and ev.name() != WINDOW and e > ws and s < we:
            host.append((s, e, ev.name()))
    op_s: dict[str, float] = {}
    for s, e, name in dev:
        op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e9
    merged: list[list[int]] = []
    for s, e, _n in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [ws] + [x for iv in merged for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    labelled = []
    for gs, ge in gaps[:10]:
        mid = (gs + ge) // 2
        cover = [h for h in host[: bisect.bisect_right(starts, mid)] if h[1] > mid]
        calls = [h[2] for h in cover if h[2].startswith(CALL)]
        inner = [h for h in cover if not h[2].startswith(CALL)]
        where = calls[0][len("port_bench."):] if calls else "between calls"
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host code outside torch"
        labelled.append((f"{where}: {what}", (ge - gs) / 1e9))
    return {"window_s": (we - ws) / 1e9, "busy_s": busy / 1e9, "op_s": op_s, "gaps": labelled}
