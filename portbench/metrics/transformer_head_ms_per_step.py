"""Device milliseconds per env step of the operations launched inside the
transformer actor's head (``portbench.tf_head``: last-token pooling, the
LayerNorm, squeeze-excitation and the policy head)."""

from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "tf_head")) if t is not None else 0.0
    return 1e3 * s / t.steps if s > 0 else None
