"""The median over the window's passes of the ``pipeline: drain`` span
(the calling thread's wait, after a pass's last predict, for the last
samples' detect, segment and writes), in ms. Silent where the trace holds
no such span (a program without it)."""

import statistics

SPAN = "pipeline: drain"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    lo, hi = trace.window
    values = [e - s for name, _, s, e in trace.spans if name == SPAN and lo <= s < hi]
    return statistics.median(values) / 1e6 if values else None
