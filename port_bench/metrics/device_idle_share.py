"""The share, in %, of the traced window in which no device operation
(kernel, copy or set) ran: 1 - (their union / the window), from the
torch.profiler trace (port_bench/trace.py)."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
