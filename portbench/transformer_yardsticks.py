"""The transformer policy's frozen yardsticks: its widths as run, read from a
configuration file, and the work of its forward pass, computed from them.

Like ``yardsticks.py``, these are the benchmark's own and do not follow the
program: a later kernel is judged against the same work.
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench.yardsticks import ACTION_DIM


def shape(config_file: dict) -> SimpleNamespace:
    """The actor's widths from a configuration file of ``portbench/configs``:
    the model's own keys (``network.transformer`` and ``history_len``) and the
    widths the file lists under ``assumed``."""
    net, assumed = config_file["config"]["network"], config_file["assumed"]
    tf = net["transformer"]
    return SimpleNamespace(
        token_dim=assumed["token_dim"], history_len=net["history_len"],
        d_model=tf["d_model"], num_heads=tf["num_heads"], num_layers=tf["num_layers"],
        feed_forward_dim=assumed["feed_forward_dim"],
        head_hidden_dims=tuple(assumed["head_hidden_dims"]),
        squeezed=max(tf["d_model"] // assumed["se_reduction"], 1),
        sequence_length=assumed["sequence_length"], action_dim=ACTION_DIM)


def actor_flops_per_row(s: SimpleNamespace) -> int:
    """The actor's forward pass at sequence length 1: 2 x sum of in x out of
    the products it needs. The embedding; in each encoder layer the value and
    output projections (attention over one key is exactly those two: the query
    and key products change nothing) and the feed-forward pair; the
    squeeze-excitation pair; the policy head's hidden layers and its output
    (mean and log-std)."""
    d = s.d_model
    layer = 2 * d * d + 2 * d * s.feed_forward_dim
    widths = (d, *s.head_hidden_dims, 2 * s.action_dim)
    head = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2 * (s.token_dim * d + s.num_layers * layer + 2 * d * s.squeezed + head)
