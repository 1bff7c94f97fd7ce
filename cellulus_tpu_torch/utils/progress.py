"""Lightweight per-item progress reporting for long stages.

A copy of ``cellulus_tpu/utils/progress.py``. The reference shows tqdm bars
on its hot loops (reference ``train.py:104``, ``detect.py:82``,
``segment.py:42``). This is a dependency-free equivalent: wrap any iterable
and a rate-limited ``label: k/N (r.r items/s)`` line goes to stderr.
Disable with ``CELLULUS_TPU_NO_PROGRESS=1`` (tests/benches).
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Iterator, Optional, TypeVar

from .env import env_flag

T = TypeVar("T")


def progress(
    iterable: Iterable[T],
    label: str,
    total: Optional[int] = None,
    min_interval: float = 1.0,
) -> Iterator[T]:
    """Yield from ``iterable``, printing rate-limited progress to stderr."""
    if env_flag("CELLULUS_TPU_NO_PROGRESS"):
        yield from iterable
        return
    if total is None:
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
    start = time.perf_counter()
    last = 0.0
    count = 0
    for item in iterable:
        yield item
        count += 1
        now = time.perf_counter()
        if now - last >= min_interval or count == total:
            rate = count / max(now - start, 1e-9)
            of = f"/{total}" if total is not None else ""
            print(
                f"[{label}] {count}{of} ({rate:.2f}/s)",
                file=sys.stderr,
                flush=True,
            )
            last = now
