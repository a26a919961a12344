"""Device milliseconds per env step of the operations launched inside the
observation-history window's update (``portbench.history``: the window
shifted, refilled where an episode ended, flattened for the actor)."""

from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "history")) if t is not None else 0.0
    return 1e3 * s / t.steps if s > 0 else None
