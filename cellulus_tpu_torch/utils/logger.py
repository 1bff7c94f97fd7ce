"""Training metric logger: CSV + PNG plot (reference parity:
``cellulus/utils/logger.py:7-35``). A copy of ``cellulus_tpu/utils/logger.py``;
the plot is written only where matplotlib imports.

Unlike the reference (which rewrites the CSV and re-renders the plot every
iteration, ``train.py:114-117``), writing is rate-limited by ``plot_every``
to keep the host out of the device's way; the full history is always flushed
on ``close()`` and checkpoint saves.
"""

from __future__ import annotations

import csv
from typing import Dict, List


class Logger:
    def __init__(self, keys: List[str], title: str, plot_every: int = 100):
        self.keys = list(keys)
        self.title = title
        self.data: Dict[str, List[float]] = {k: [] for k in keys}
        self.plot_every = max(1, plot_every)
        self._since_flush = 0

    def add(self, key: str, value: float) -> None:
        if key not in self.data:
            raise KeyError(f"unknown logger key {key!r}")
        self.data[key].append(float(value))

    def step(self) -> None:
        """Call once per iteration; flushes CSV/plot periodically."""
        self._since_flush += 1
        if self._since_flush >= self.plot_every:
            self.write()
            self.plot()
            self._since_flush = 0

    def write(self) -> None:
        n = max((len(v) for v in self.data.values()), default=0)
        with open(self.title + ".csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + self.keys)
            for i in range(n):
                w.writerow(
                    [i]
                    + [
                        self.data[k][i] if i < len(self.data[k]) else ""
                        for k in self.keys
                    ]
                )

    def plot(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        fig, ax = plt.subplots()
        for key, values in self.data.items():
            ax.plot(range(len(values)), values, marker=".", label=key)
        ax.set_xlabel("Iteration")
        ax.set_ylabel(self.title)
        ax.legend()
        fig.savefig(self.title + ".png")
        plt.close(fig)

    def close(self) -> None:
        self.write()
        self.plot()


def get_logger(keys: List[str], title: str, plot_every: int = 100) -> Logger:
    return Logger(keys, title, plot_every)
