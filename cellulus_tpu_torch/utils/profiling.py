"""Per-stage timers, device timers, profiler spans and counters, traces.

Port of ``cellulus_tpu/utils/profiling.py``:

- ``stage_timer("predict", items=n, unit="samples")`` prints
  ``[perf] predict: 12.34s, 2 samples, 0.16 samples/s`` on exit and
  accumulates into a process-wide report (:func:`perf_report`);
- ``time_device(name, fn, *args)`` accumulates ``fn``'s dispatch-to-completion
  time under ``name`` when ``CELLULUS_TPU_DEVICE_TIMERS=1``, and is a plain
  call otherwise;
- ``maybe_trace()`` captures a ``torch.profiler`` trace of its region when
  ``CELLULUS_TPU_PROFILE=<dir>`` is set (CPU ops, and the card's kernels
  and copies when CUDA is available), written as a Chrome-trace JSON
  (viewable in Perfetto or ``chrome://tracing``);
- ``span(name)`` and ``count(name, value)`` mark the inference path's
  layers for a profiler: while a ``torch.profiler`` records this process
  (``maybe_trace``, or any caller's profiler, on every thread it records),
  ``span`` opens ``record_function(name)``, a span on the profiler's own
  clock beside the card's kernels, and ``count`` adds ``value`` into the
  process's counters (:func:`counters`). Otherwise each is one check of a
  flag: no span, no allocation, no synchronisation.

The report and the counters are shared by every thread (the pipelined path
times and counts its worker threads' work too), so updates take a lock.
"""

from __future__ import annotations

import contextlib
import operator
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from .env import env_flag

_STAGES: Dict[str, Dict[str, float]] = {}
_COUNTERS: Dict[str, float] = {}
_LOCK = threading.Lock()
# what span() returns while no profiler records: shared, stateless
_NO_SPAN = contextlib.nullcontext()


def _accumulate(name: str, seconds: float, items: float) -> None:
    with _LOCK:
        entry = _STAGES.setdefault(name, {"seconds": 0.0, "items": 0.0})
        entry["seconds"] += seconds
        entry["items"] += items


@contextlib.contextmanager
def stage_timer(name: str, items: Optional[int] = None, unit: str = "items"):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _accumulate(name, dt, items or 0)
        msg = f"[perf] {name}: {dt:.2f}s"
        if items:
            msg += f", {items} {unit}, {items / max(dt, 1e-9):.2f} {unit}/s"
        print(msg)


def perf_report() -> Dict[str, Dict[str, float]]:
    """Accumulated per-stage timings for this process."""
    with _LOCK:
        return {k: dict(v) for k, v in _STAGES.items()}


def reset_perf() -> None:
    """Clear the stage report and the counters."""
    with _LOCK:
        _STAGES.clear()
        _COUNTERS.clear()


def recording() -> bool:
    """Does a ``torch.profiler`` record this process? torch sets this flag
    for the whole process while a profiler runs, so it reads true on every
    thread (``profile_all_threads`` records the worker threads' spans)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, value: float,
          combine: Callable[[float, float], float] = operator.add) -> None:
    """While a profiler records, fold ``value`` into counter ``name`` with
    ``combine`` (a sum by default; ``max`` keeps the largest)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = combine(_COUNTERS[name], value) if name in _COUNTERS else value


def counters() -> Dict[str, float]:
    """The counters of this process: what was counted while a profiler
    recorded."""
    with _LOCK:
        return dict(_COUNTERS)


def device_timers_enabled() -> bool:
    """CELLULUS_TPU_DEVICE_TIMERS=1 turns :func:`time_device` on."""
    return env_flag("CELLULUS_TPU_DEVICE_TIMERS")


def _cuda_devices(out, found=None):
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists and
    dicts of tensors)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _cuda_devices(item, found)
    elif isinstance(out, dict):
        for item in out.values():
            _cuda_devices(item, found)
    return found


def time_device(name: str, fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)`` and, when CELLULUS_TPU_DEVICE_TIMERS is
    set, accumulate its dispatch-to-completion time under stage ``name``.

    Measures from dispatch until the calling thread's current stream on
    each CUDA device of the result has finished: device compute plus any
    host-to-device upload of host-resident arguments, but NOT the bulk
    device-to-host fetch of the result (the caller's ``.cpu()`` does that)
    and not the caller's host prep. On the CPU there is nothing to wait
    for. The per-stage sums give a transfer-independent device-time floor
    for the pipeline.

    Off (the default), this is a plain call: no added synchronization, so
    pipelined callers keep their overlap.
    """
    if not device_timers_enabled():
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for device in _cuda_devices(out):
        torch.cuda.current_stream(device).synchronize()
    _accumulate(name, time.perf_counter() - t0, 1)
    return out


@contextlib.contextmanager
def maybe_trace():
    """Capture a torch.profiler trace when CELLULUS_TPU_PROFILE is set: one
    Chrome-trace JSON file per region in that directory."""
    trace_dir = os.environ.get("CELLULUS_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # the CPU ops of every thread: the pipelined path's stage workers too
    # (by default only the thread that starts the profiler is recorded)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    counted = counters()
    print(f"[perf] profiler trace written to {trace_dir}"
          + ("; counters " + ", ".join(f"{k} {v}" for k, v in sorted(counted.items()))
             if counted else ""))
