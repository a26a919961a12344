"""Host milliseconds per env step spent enqueueing the program's work: the
host time of the program's spans less the time its runtime calls waited for
room in the launch queue (a call longer than ``tracing.WAIT_US``), under the
profiler."""


def read(ctx):
    t = ctx.trace
    if t is None or t.program_host_s <= 0:
        return None
    return 1e3 * (t.program_host_s - t.program_wait_s) / t.steps
