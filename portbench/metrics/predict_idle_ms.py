"""The card's idle time inside predict's host parts (the window thread's
``predict: *`` spans: read, tiles, upload, forward, wait, emit), over the
``predict sample N`` spans of the window, in ms an image. Silent where the
trace holds neither (a program without these spans)."""

import re

CHILD = "predict: "
PARENT = re.compile(r"^predict sample \d+$")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """The length two sorted lists of disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    lo, hi = trace.window
    own = [(name, s, e) for name, tid, s, e in trace.spans if tid == trace.window_tid]
    images = sum(1 for name, s, _ in own if PARENT.match(name) and lo <= s < hi)
    parts = _merged([(max(s, lo), min(e, hi)) for name, s, e in own
                     if name.startswith(CHILD) and min(e, hi) > max(s, lo)])
    if not images or not parts:
        return None
    idle = sum(e - s for s, e in parts) - _overlap(parts, trace.busy_intervals())
    return idle / 1e6 / images
