"""Spans around the program's layers and the reading of the device trace.

The benchmark records its spans itself (``record_function``), around its own
calls into the program and, for a traced run, around the program functions
that the traffic file names for each layer (``layer_spans``). ``read``
turns one ``torch.profiler`` run into a ``Trace``: each device operation with
the spans its launch came from (the launch is matched to the operation by the
CUDA runtime's correlation id, and the span by the launch's host time), the
device's busy time, its idle gaps labelled by what the host was doing, and
the host time the program's spans took beside the time the host spent
waiting in the runtime for room in the launch queue.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib
from collections import defaultdict

import numpy as np
from torch.profiler import DeviceType, ProfilerActivity, profile, record_function

PREFIX = "portbench."
WINDOW, PROGRAM, DRAWS = (PREFIX + s for s in ("window", "program", "draws"))
# a runtime call that takes longer than this waited for the launch queue
WAIT_US = 50.0


def span(name: str):
    return record_function(name)


@contextlib.contextmanager
def layer_spans(targets: dict[str, list[str]]):
    """Wrap each program function ``"module:attr"`` of ``targets[span]`` in
    ``span`` for the duration of the block."""
    saved = []
    try:
        for name, fns in targets.items():
            for target in fns:
                module_name, attr = target.split(":")
                module = importlib.import_module(module_name)
                fn = getattr(module, attr, None)
                if fn is None:  # the program no longer has it: the span stays silent
                    continue
                saved.append((module, attr, fn))
                setattr(module, attr, _wrapped(fn, name))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def _wrapped(fn, name: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclasses.dataclass
class Trace:
    """One traced window. Times in seconds."""

    window_s: float
    busy_s: float
    steps: int
    ops: list[tuple[str, float, tuple]]        # (device op, seconds, spans around its launch)
    idle_by_span: dict[str, float]             # idle device seconds by the host's span
    program_host_s: float                      # host seconds inside the program spans
    program_wait_s: float                      # of it, waiting in the runtime
    unmatched: int                             # device ops whose launch was not found

    def layer(self, span_name: str) -> list[float]:
        """The seconds of each device op launched inside ``span_name``."""
        return [s for _, s, spans in self.ops if span_name in spans]


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read(prof, steps: int) -> Trace:
    """The ``Trace`` of a profiler run whose window is the ``WINDOW`` span."""
    spans, runtime, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.append((start, end, name))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = (start, end)
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            device.append((start, end, name, e.correlation_id()))
    windows = [s for s in spans if s[2] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, want 1")
    w0, w1 = windows[0][:2]
    inner = sorted((s for s in spans if s[2] != WINDOW), key=lambda s: s[0] - s[1])

    def enclosing(times: np.ndarray) -> list[list[str]]:
        """The spans holding each host time, outermost first."""
        order = np.argsort(times, kind="stable")
        sorted_t = times[order]
        stacks: list[list[str]] = [[] for _ in times]
        for a, b, name in inner:  # longest first
            lo, hi = np.searchsorted(sorted_t, a), np.searchsorted(sorted_t, b, side="right")
            for i in order[lo:hi]:
                stacks[i].append(name)
        return stacks

    launch = np.array([runtime.get(c, (-1, -1))[0] for *_, c in device], dtype=np.int64)
    unmatched = int((launch < 0).sum())
    stacks = enclosing(launch.astype(np.float64)) if device else []
    ops = [(name, (b - a) / 1e9, tuple(st) if t >= 0 else ("unmatched",))
           for (a, b, name, _), st, t in zip(device, stacks, launch)]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in device if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    idle: dict[str, float] = defaultdict(float)
    if gaps:
        for (a, b), st in zip(gaps, enclosing(np.array([g[0] for g in gaps], float))):
            idle[st[-1] if st else "harness"] += (b - a) / 1e9
    program = sorted((a, b) for a, b, name in spans if name == PROGRAM)
    starts = [a for a, _ in program]
    wait_ns = 0.0
    for a, b in runtime.values():
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < program[i][1]:
            wait_ns += max(0.0, (b - a) - WAIT_US * 1e3)
    return Trace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, steps=steps, ops=ops,
        idle_by_span=dict(idle), program_host_s=sum(b - a for a, b in program) / 1e9,
        program_wait_s=wait_ns / 1e9, unmatched=unmatched,
    )


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle time by
    the host's span."""
    by_name: dict[str, float] = defaultdict(float)
    for name, s, _ in trace.ops:
        by_name[name[:96]] += s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
