"""The median of the window's per-image predict times (the calling
thread's ``infer_pipelined`` interval: tile reads, uploads, the TTA
forwards, fetches), in ms."""

import statistics


def read(ctx):
    values = ctx["details"].get("predict_s")
    return 1e3 * statistics.median(values) if values else None
