"""The whole step's share of the card's float32 peak, in percent: the work
of a row's step by the yardsticks (K1's operations, and the actor's forward
FLOPs where the entry acts with the policy), over the traced window."""

from portbench import yardsticks


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    work = ctx.flops_per_env_step * ctx.n_envs * t.steps
    return 100.0 * work / t.window_s / yardsticks.FP32_FLOPS_PER_S
