"""The env step's share of its roofline as one unit, in percent: the least
bytes the step needs (``yardsticks.env_step_bytes_per_env``: the state read
and written once, the action and draws read once, the output written once)
at the card's peak bandwidth over the device time of the env step's spans."""

from portbench import yardsticks
from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "env")) if t is not None else 0.0
    if s <= 0:
        return None
    least = (yardsticks.env_step_bytes_per_env(ctx.p) * ctx.n_envs * t.steps
             / yardsticks.HBM_BYTES_PER_S)
    return 100.0 * least / s
