"""The traced run: ``torch.profiler`` over the measured window, reduced to
device intervals, host spans and the numbers the per-layer readers take.

Device time is the union of the card's kernel, copy and set intervals
inside the window (the span ``portbench: window``, which the harness opens
around its window). An idle gap is a stretch of the window in which no
operation ran on the card; it is put down to the innermost host span open
at its middle on the thread that opened the window (spans by
``record_function``: the harness's own and the program's), digits dropped
from the span's name.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench: window"


@dataclass
class Trace:
    window: Tuple[int, int]  # ns, the profiler's clock
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # (name, start, end)
    spans: List[Tuple[str, int, int, int]] = field(default_factory=list)  # (name, tid, start, end)
    window_tid: Optional[int] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self):
        lo, hi = self.window
        for name, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.clipped(), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.clipped() if rx.search(name)) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for name, s, e in self.clipped():
            key = short_name(name)
            totals[key] = totals.get(key, 0) + (e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        lo, hi = self.window
        gaps = []
        prev = lo
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        spans = sorted((sp for sp in self.spans if sp[1] == self.window_tid),
                       key=lambda sp: (sp[2], -sp[3]))
        totals: Dict[str, int] = {}
        stack: List[tuple] = []
        i = 0
        # one sweep: a thread's spans nest, so the innermost open span is
        # the top of a stack of the spans begun and not yet ended
        for gs, ge in gaps:
            mid = (gs + ge) // 2
            while i < len(spans) and spans[i][2] <= mid:
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][3] <= mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no span)"
            key = re.sub(r"\d+", "#", name)
            totals[key] = totals.get(key, 0) + (ge - gs)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip()
    if short.endswith(")"):
        depth = 0
        for i in range(len(short) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(short[i], 0)
            if depth == 0:
                short = short[:i].strip()
                break
    short = re.sub(r"^void\s+", "", short)
    return short[:120] or name[:120]


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the block (CPU ops of every thread, the card's kernels);
    leave the :class:`Trace` under ``result["trace"]``."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # every thread's spans: the pipeline's stage workers too
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    result["trace"] = _reduce(prof)


def _reduce(prof) -> Trace:
    """Device intervals and host spans from the Chrome trace the profiler
    writes (kernel, copy and set events; user annotations), read from a
    temporary file (torch's event objects differ between versions)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, spans = [], []
    window = window_tid = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        kind, name, tid = str(ev.get("cat", "")).lower(), str(ev.get("name", "")), ev.get("tid")
        start = int(round(float(ev["ts"]) * 1000))
        end = start + int(round(float(ev.get("dur", 0)) * 1000))
        if kind in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((name, start, end))
        elif kind == "user_annotation":
            spans.append((name, tid, start, end))
            if name == WINDOW_SPAN:
                window, window_tid = (start, end), tid
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN!r} span")
    return Trace(window=window, device=device, spans=spans, window_tid=window_tid)
