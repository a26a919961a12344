"""Device operations per env step launched from inside the program's calls
(the rollout loop's span, which holds the act and env step spans); the
benchmark's own draws are not counted."""

from portbench.tracing import PROGRAM


def read(ctx):
    t = ctx.trace
    n = len(t.layer(PROGRAM)) if t is not None else 0
    return n / t.steps if n else None
