"""Profiling and tracing helpers.

- ``span(name)``: a named scope on the profiler's host timeline while a
  ``torch.profiler`` run is active, and one shared no-op otherwise, so the
  hot path pays a flag check when nobody traces. The profiler aligns the
  host timeline with the device operations, so a trace reader can charge
  each device op to the spans around its launch. The names are the
  constants below, under ``tvc.``.
- ``count(name, value)`` / ``counters()``: device-side counters, added to
  only while a profiler is active and read once, after the traced work.
- ``StageTimer``: wall-clock seconds per named stage of the trainer's host
  loop (iteration / eval / checkpoint), reported at the end of a run.

Tracing is on exactly while a profiler runs; there is no other switch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast

# the rollout loop's act layer (``training.loop.collect``) and its parts
ACT = "tvc.act"
ACT_ACTOR = "tvc.act.actor"          # the actor's forward pass
ACT_ACTOR_ENCODER = "tvc.act.actor.encoder"  # the transformer's embedding and encoder layers
ACT_ACTOR_HEAD = "tvc.act.actor.head"        # the transformer's pooling, SE and heads
ACT_SAMPLE = "tvc.act.sample"        # the tanh-Gaussian sample or the mean action
ACT_SAFETY = "tvc.act.safety"        # the safety projection
# the observation-history window's update (``training.loop.next_window``)
HISTORY = "tvc.history"
# the batched env step (``env.rocket_env``) and its parts, which tile it
ENV = "tvc.env"
ENV_PRE = "tvc.env.pre"              # the step's draws, action conditioning, fuel gate
ENV_INTEGRATE = "tvc.env.integrate"  # the rigid-body integrate (K1 or the plain one)
ENV_STATUS = "tvc.env.status"        # derived quantities, mission FSM, termination
ENV_OBSERVE = "tvc.env.observe"      # the observation and its appended channels
ENV_REWARD = "tvc.env.reward"        # shaping, the reward terms, the survival payout
ENV_AUTORESET = "tvc.env.autoreset"  # the autoreset: K2 on the card, the plain body else
# counters: rows whose reset the autoreset kept, and rows it built
AUTORESET_KEPT = "tvc.env.autoreset.kept"
AUTORESET_BUILT = "tvc.env.autoreset.built"

_OFF = contextlib.nullcontext()
_counters: dict[str, torch.Tensor | float] = {}


def tracing() -> bool:
    """True while a profiler runs."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A host-side scope ``name`` while tracing, else a shared no-op.

    The scope is recorded as an operator (``_RecordFunctionFast``), not as a
    ``record_function`` user annotation: the profiler mirrors each user
    annotation onto the device timeline as an event of its own, which a trace
    reader would count as device work."""
    return _RecordFunctionFast(name) if tracing() else _OFF


def count(name: str, value: torch.Tensor | float) -> None:
    """Add the sum of ``value`` (a device tensor, or a number) to counter
    ``name`` while tracing; nothing is read back. Untraced, the sum is not
    even launched."""
    if tracing():
        if isinstance(value, torch.Tensor):
            value = value.sum()
        _counters[name] = _counters.get(name, 0) + value


def counters() -> dict[str, float]:
    """Every counter as a float, with one synchronise; then clears them."""
    tensors = {n: v for n, v in _counters.items() if isinstance(v, torch.Tensor)}
    out = {n: float(v) for n, v in _counters.items() if n not in tensors}
    if tensors:
        device = next(iter(tensors.values())).device
        read = torch.stack([v.to(device, torch.float64) for v in tensors.values()]).tolist()
        out.update(zip(tensors, read))
    _counters.clear()
    return out


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
