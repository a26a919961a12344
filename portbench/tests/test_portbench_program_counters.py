"""The reader of the program's counter (``autoreset_kept_pct``), and the
trace reader beside the program's own spans: on the CPU, where a traced run
has host spans and counters but no device operations."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, tracing
from portbench.metrics import autoreset_kept_pct
from tvc_ai_torch.utils import profiling

CPU = torch.device("cpu")
CELLS = ["default.rollout_4m", "robust_full_r4d.rollout_4m", "default.env_4m",
         "robust_full_r4d.env_4m"]
EMPTY = tracing.Trace(window_s=1.0, busy_s=0.5, steps=8, ops=[], idle_by_span={},
                      program_host_s=0.0, program_wait_s=0.0, unmatched=0)


def ctx(trace):
    return harness.Context(n_envs=64, steps=8, window_s=1.0, setup_s=1.0, p=None,
                           flops_per_env_step=0, traffic={}, trace=trace)


def test_kept_pct_none_without_trace_or_counters():
    profiling.counters()
    assert autoreset_kept_pct.read(ctx(None)) is None
    assert autoreset_kept_pct.read(ctx(EMPTY)) is None


def test_kept_pct_reads_and_clears_the_counters():
    profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for kept in (3, 5):
            profiling.count(autoreset_kept_pct.KEPT, torch.arange(64) < kept)
            profiling.count(autoreset_kept_pct.BUILT, 64)
    assert autoreset_kept_pct.read(ctx(EMPTY)) == pytest.approx(100.0 * 8 / 128)
    assert autoreset_kept_pct.read(ctx(EMPTY)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_counters_and_keeps_its_spans(cell):
    """A traced run reports the kept share; the trace the existing metrics
    read holds the benchmark's spans alone, the program's spans beside them
    notwithstanding."""
    seen = []
    real = tracing.read

    def read(prof, steps):
        names = {e.name for e in prof.events()}
        seen.append({n for n in names if n.startswith("tvc.")})
        t = real(prof, steps)
        seen.append(t)
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "read", read)
        r = harness.run(cell, 2**33 + 7, 0.2, True, CPU, time.perf_counter(), n_envs=384)
    program_spans, trace = seen
    assert "tvc.env.autoreset" in program_spans
    assert 0 < r["metrics"]["autoreset_kept_pct"]["value"] <= 100
    labels = set(trace.idle_by_span) | {s for _, _, spans in trace.ops for s in spans}
    assert all(s.startswith(tracing.PREFIX) or s == "harness" for s in labels), labels
