"""The share of the autoreset's rows that the env step keeps, in percent:
100 × the program's counter ``tvc.env.autoreset.kept`` (rows whose episode
ended, summed over the traced window's steps) over ``tvc.env.autoreset.built``
(rows whose reset was built: N a step). The program counts only while a
profiler runs, so the counters hold the traced window alone; reading them
clears them. None where the program keeps no such counters."""

from tvc_ai_torch.utils import profiling

KEPT, BUILT = "tvc.env.autoreset.kept", "tvc.env.autoreset.built"


def read(ctx):
    counters = getattr(profiling, "counters", None)
    if ctx.trace is None or counters is None:
        return None
    c = counters()
    return 100.0 * c[KEPT] / c[BUILT] if c.get(BUILT, 0) > 0 and KEPT in c else None
