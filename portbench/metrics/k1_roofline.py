"""K1's share of its roofline, in percent: its least bytes (145 per env and
launch, ``yardsticks.k1_bytes_per_env``) at the card's peak bandwidth over
the device time of the operations launched inside the step kernel's span
(one a step). K1 is bound by bytes: about 9 FLOP a byte, far below the
card's ridge."""

from portbench import yardsticks
from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    times = t.layer(PREFIX + "k1") if t is not None else []
    if not times or sum(times) <= 0:
        return None
    least = yardsticks.k1_bytes_per_env() * ctx.n_envs * len(times) / yardsticks.HBM_BYTES_PER_S
    return 100.0 * least / sum(times)
