"""The transformer actor's share of its roofline, in percent: the least time
of its forward pass, its FLOPs (``transformer_yardsticks.actor_flops_per_row``
a row, every row of every step) at the card's float32 peak, over the device
time of the operations launched inside its encoder and head spans. Its least
bytes (the window read, two floats a row written, the weights) are a few
hundred bytes a row, far under the compute bound, so the roofline is the
compute one."""

from portbench import transformer_yardsticks, yardsticks
from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    shape = getattr(ctx.p, "transformer", None)
    if t is None or shape is None:
        return None
    s = sum(t.layer(PREFIX + "tf_encoder")) + sum(t.layer(PREFIX + "tf_head"))
    if s <= 0:
        return None
    least = (transformer_yardsticks.actor_flops_per_row(shape) * ctx.n_envs * t.steps
             / yardsticks.FP32_FLOPS_PER_S)
    return 100.0 * least / s
