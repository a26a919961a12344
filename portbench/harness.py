"""One run of one cell: set-up, the measured (or traced) window, the check.

Everything particular to a cell comes from files found by name:
``BENCHMARK.json`` names the cell's configuration (``configs/<config>.json``)
and traffic (``traffic/<traffic>.json``, the mix's parameters as data); the
traffic names the program's entry that it drives
(``entries/<entry>.py``: its draws, its chunk, its reference and its check);
the cell's limits are in ``limits/<cell>.json``, and each metric is read by
``metrics/<metric>.py``. This module holds only what every cell shares: the
set-up, the window, the trace, the metric readers and the verdict.

The window enqueues the entry's whole chunks until ``seconds`` have passed
and then waits for the device; nothing in it reads device data on the host.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import time
from pathlib import Path

import torch

from portbench import tracing

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((PKG / "limits" / f"{workload}.json").read_text())

    def mine(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    end_to_end = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in names]
    return dict(cell=cell, config=config, traffic=traffic, limits=limits["limits"],
                end_to_end=end_to_end, per_layer=per_layer)


def entry(name: str):
    """The entry module a traffic file names."""
    return importlib.import_module(f"portbench.entries.{name}")


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every limited number is finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    n_envs: int             # rows a step
    steps: int              # steps of the window, per row
    window_s: float         # host clock, synchronised start to synchronised end
    setup_s: float
    p: object               # the configuration as the reference reads it
    flops_per_env_step: int  # the work of a row's step, by the yardsticks
    traffic: dict
    trace: tracing.Trace | None


def read_metrics(specs: list[dict], ctx: Context) -> dict:
    out = {}
    for m in specs:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        n_envs: int | None = None, system: str = "program") -> dict:
    """One run; returns the result (without ``device``'s card fields).
    ``t_start`` is the process's start on the host clock; ``n_envs`` (the
    configuration's by default) sizes the CPU tests and size probes;
    ``system`` is "program" (the port) or "control"."""
    marks = {"start": time.perf_counter()}
    spec = load_cell(workload)
    traffic = spec["traffic"]
    sut = entry(traffic["entry"]).Run(spec, seed, device, n_envs, system)
    marks["program_built"] = time.perf_counter()
    sut.start()
    marks["first_reset"] = time.perf_counter()

    c = 0
    for _ in range(traffic["warmup_chunks"]):
        sut.chunk(c)
        c += 1
    _sync(device)
    setup_s = time.perf_counter() - t_start
    marks["warmed_up"] = t_start + setup_s

    traced = None
    first = c
    if trace:
        with tracing.layer_spans(traffic["layer_spans"]), tracing.profiler() as prof:
            with tracing.span(tracing.WINDOW):
                t0 = time.perf_counter()
                for _ in range(traffic["trace_chunks"]):
                    sut.chunk(c)
                    c += 1
                _sync(device)
                t1 = time.perf_counter()
        traced = tracing.read(prof, (c - first) * sut.steps)
    else:
        t0 = time.perf_counter()
        while True:
            sut.chunk(c)
            c += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        t1 = time.perf_counter()
    steps = (c - first) * sut.steps
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    numbers = sut.check()  # frees the program's state, then runs the reference
    limits = spec["limits"]
    ctx = Context(n_envs=sut.n, steps=steps, window_s=t1 - t0, setup_s=setup_s, p=sut.p,
                  flops_per_env_step=sut.flops_per_env_step, traffic=traffic, trace=traced)
    metrics = read_metrics(spec["per_layer"] if trace else spec["end_to_end"], ctx)
    result = {
        "correct": judge(numbers, limits),
        "attempted": sut.n * steps,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "count": 1, "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = tracing.breakdown(traced)
    result["run"] = {"n_envs": sut.n, "chunks": c - first, "last_chunk": c - 1,
                     "system": system, "unmatched_ops": traced.unmatched if traced else None,
                     "numbers": numbers, "gap_max_at": getattr(sut, "gap_max_at", None),
                     # set-up seconds by part: process start and imports to the
                     # harness's start, the weights and the program, the first
                     # state, the warm-up chunks
                     "setup_parts": [marks["start"] - t_start,
                                     marks["program_built"] - marks["start"],
                                     marks["first_reset"] - marks["program_built"],
                                     marks["warmed_up"] - marks["first_reset"]]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result
