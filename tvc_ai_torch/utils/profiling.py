"""Profiling and tracing helpers.

Counterpart of ``tvc_ai_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``torch.profiler`` around a block (CPU and, when
  present, CUDA activity), written as a Chrome trace to
  ``<log_dir>/trace.json``;
- ``annotate(name)``: a named ``torch.profiler.record_function`` scope that
  shows up inside the trace;
- ``StageTimer``: wall-clock seconds per named stage of the trainer's host
  loop (iteration / eval / checkpoint), reported at the end of a run.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; the trace goes to ``<log_dir>/trace.json``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """Named scope that appears on the trace's timeline."""
    return record_function(name)


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for every iteration."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_sec": self.totals[name],
                "count": self.counts[name],
                "mean_sec": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def summary_line(self) -> str:
        parts = [
            f"{name}={self.totals[name]:.1f}s/{self.counts[name]}x"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return " ".join(parts)
