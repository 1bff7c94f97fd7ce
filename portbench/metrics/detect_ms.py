"""The median of the window's per-image detect times (a stage worker's
interval: threshold, mask, clustering), in ms."""

import statistics


def read(ctx):
    values = ctx["details"].get("detect_s")
    return 1e3 * statistics.median(values) if values else None
