"""The share of the traced window in which no operation ran on the card:
1 - (union of the kernel, copy and set intervals) / window, in %. Silent
where the trace holds no device operation."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
