"""Device milliseconds per env step of the operations launched inside the
transformer actor's encoder (``portbench.tf_encoder``: the embedding, the
position encoding and the encoder layers)."""

from portbench.tracing import PREFIX


def read(ctx):
    t = ctx.trace
    s = sum(t.layer(PREFIX + "tf_encoder")) if t is not None else 0.0
    return 1e3 * s / t.steps if s > 0 else None
