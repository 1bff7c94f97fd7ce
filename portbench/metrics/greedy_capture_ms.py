"""The median over the window's ``greedy: capture`` spans (a stage
worker's warm-up iteration, its wait for the capture lock and the capture
of greedy clustering's CUDA graph; one a volume at one bandwidth), in ms a
call. Silent where the trace holds no such span (a program without it, or
clustering that captures nothing)."""

import statistics

SPAN = "greedy: capture"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    lo, hi = trace.window
    values = [e - s for name, _, s, e in trace.spans if name == SPAN and lo <= s < hi]
    return statistics.median(values) / 1e6 if values else None
