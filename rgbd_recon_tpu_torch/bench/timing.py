"""Stage-timing harness — the TimerDatabase equivalent.

Replicates the reference's instrumentation (SURVEY.md §5):
  - named per-stage timers with running mean/min/max
    (framework/rendering/timer_database.cpp),
  - CSV export of mean/min/max on exit (timer_database.cpp:59-121),
  - the reference's stage taxonomy (morph, bilateral, boundary, normal,
    quality, 1preprocess, 2integrate, 3recon, draw, holefill, brickdraw)
    is reused as the benchmark schema (BASELINE.md).

GPU timestamp queries become wall-clock spans around
`torch.cuda.synchronize` boundaries; `torch.profiler` traces remain
available for kernel-level work.
"""

from __future__ import annotations

import contextlib
import csv
import io
import time
from typing import Dict, List


class StageTimer:
    """Running statistics for one named stage (TimerGPU + Timer roles)."""

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def add(self, seconds: float) -> None:
        self.samples.append(seconds)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def min(self) -> float:
        return min(self.samples) if self.samples else 0.0

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0


class TimerDatabase:
    """Singleton-style registry of stage timers (timer_database.cpp)."""

    def __init__(self):
        self._timers: Dict[str, StageTimer] = {}

    def timer(self, name: str) -> StageTimer:
        if name not in self._timers:
            self._timers[name] = StageTimer(name)
        return self._timers[name]

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        """Context manager timing a stage; `sync` is called before stopping
        the clock (pass torch.cuda.synchronize for device work)."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.timer(name).add(time.perf_counter() - t0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {
            n: {"mean": t.mean, "min": t.min, "max": t.max, "count": len(t.samples)}
            for n, t in self._timers.items()
        }

    def write_csv(self, path: str = None) -> str:
        """mean/min/max CSV like the reference's exit dump
        (kinect_client.cpp:835-851). Returns the CSV text."""
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["stage", "mean_ms", "min_ms", "max_ms", "count"])
        for name in sorted(self._timers):
            t = self._timers[name]
            w.writerow(
                [name, f"{t.mean*1e3:.4f}", f"{t.min*1e3:.4f}",
                 f"{t.max*1e3:.4f}", len(t.samples)]
            )
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text
