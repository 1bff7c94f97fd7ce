"""The median of the window's per-image (per-volume) segment times (a stage
worker's interval: halo removal, connected components, size filter), in ms."""

import statistics


def read(ctx):
    values = ctx["details"].get("segment_s")
    return 1e3 * statistics.median(values) if values else None
