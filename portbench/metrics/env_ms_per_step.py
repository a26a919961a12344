"""Device milliseconds per env step of the operations launched inside the env
step's spans (pre-physics, K1, observation, mission, reward, termination,
autoreset)."""

from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "env")) if t is not None else 0.0
    return 1e3 * s / t.steps if s > 0 else None
