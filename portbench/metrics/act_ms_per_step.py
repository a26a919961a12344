"""Device milliseconds per env step of the operations launched inside the act
layer's spans (the actor's forward pass and tanh-Gaussian sample, the safety
projection)."""

from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "act")) if t is not None else 0.0
    return 1e3 * s / t.steps if s > 0 else None
