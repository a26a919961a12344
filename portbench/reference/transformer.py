"""The plain transformer policy: the upstream project's
``TransformerPolicyNetwork`` (TVC-AI, ``agent/multi_algorithm_agent.py``,
lines 123-227) as the actor, obs → (mean, log_std).

Written from the published description and flax's layer numerics in plain
``torch``, float32 with TF32 off; it imports nothing of the port. The
weights are a dict of tensors keyed by the flax tree's names
(``Dense_0.weight``, ``EncoderLayer_0.MultiHeadDotProductAttention_0.query
.weight``, ``_Head_0.LayerNorm_1.bias``, …), each ``weight`` of a Dense of
shape (out, in); the widths and depths are read from their shapes.

- The tokens: the observation (N, S·token_dim) split into S tokens; the
  live path calls the network at sequence length 1, with the whole
  flattened observation window as its one token.
- A Dense embedding plus the sinusoidal position encoding.
- Pre-norm encoder layers: LayerNorm, multi-head dot-product
  self-attention with biased query, key, value and output projections,
  computed in full (the query scaled by 1/√head_dim, the scores, a softmax
  over the keys, the weighted values) even over one key; a residual;
  LayerNorm, Dense, GELU, Dense, a residual.
- Last-token pooling, a LayerNorm, squeeze-excitation (Dense, ReLU, Dense,
  a sigmoid gate on the features).
- The policy head: (Dense, GELU, LayerNorm) per hidden width, then a Dense
  to the mean and log-std of each action, log-std clamped to [-20, 2].

LayerNorm is flax's: epsilon 1e-6 and the variance as E[x²] − E[x]²
clipped at 0. GELU is the tanh approximation, flax's default.

Departures from the upstream description: no dropout (every caller runs
the network deterministic); no value head (the actor drops its output).

With ``lower`` it runs one precision below the configuration's float32:
the products in TF32 and every float between them in bfloat16 (the
control).
"""

from __future__ import annotations

import contextlib
import math

import torch

from portbench.reference.params import LOG_STD_MAX, LOG_STD_MIN

LN_EPS = 1e-6


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _dense(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """x W^T + b, the product in float32 (TF32 where the caller turned it
    on), the result in x's dtype."""
    return (x.float() @ w[f"{name}.weight"].T + w[f"{name}.bias"]).to(x.dtype)


def _layer_norm(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * w[f"{name}.weight"].to(x.dtype)
    return (x - mean) * mul + w[f"{name}.bias"].to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return x * (0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))))


def position_encoding(length: int, d_model: int) -> torch.Tensor:
    """(length, d_model): sin at the even features, cos at the odd, of the
    position over 10000^(2i / d_model)."""
    position = torch.arange(length, dtype=torch.float32)[:, None]
    rate = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                     * (-math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model)
    pe[:, 0::2] = torch.sin(position * rate)
    pe[:, 1::2] = torch.cos(position * rate)
    return pe


def _attention(w: dict, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    split = (b, s, heads, d // heads)
    q = _dense(w, f"{name}.query", x).view(split) / math.sqrt(d // heads)
    k = _dense(w, f"{name}.key", x).view(split)
    v = _dense(w, f"{name}.value", x).view(split)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    weights = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return _dense(w, f"{name}.out", o.reshape(b, s, d))


def _count(w: dict, prefix: str) -> int:
    """How many modules ``<prefix>0``, ``<prefix>1``, … the weights hold."""
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in w):
        n += 1
    return n


def actor(w: dict, obs: torch.Tensor, heads: int, sequence_length: int = 1,
          lower: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, log_std) of the Gaussian before the tanh, for the observation
    ``obs`` (N, sequence_length·token_dim) and ``heads`` attention heads."""
    dtype = torch.bfloat16 if lower else torch.float32
    with _tf32(lower):
        n = obs.shape[0]
        x = obs.to(dtype).reshape(n, sequence_length, -1)
        x = _dense(w, "Dense_0", x)
        x = x + position_encoding(sequence_length, x.shape[-1]).to(x.device, dtype)
        for i in range(_count(w, "EncoderLayer_")):
            layer = f"EncoderLayer_{i}"
            x = x + _attention(w, f"{layer}.MultiHeadDotProductAttention_0",
                               _layer_norm(w, f"{layer}.LayerNorm_0", x), heads)
            h = _gelu(_dense(w, f"{layer}.Dense_0", _layer_norm(w, f"{layer}.LayerNorm_1", x)))
            x = x + _dense(w, f"{layer}.Dense_1", h)
        x = _layer_norm(w, "LayerNorm_0", x[:, -1, :])
        if "SqueezeExcitation_0.Dense_0.weight" in w:
            gate = _dense(w, "SqueezeExcitation_0.Dense_1",
                          torch.relu(_dense(w, "SqueezeExcitation_0.Dense_0", x)))
            x = x * torch.sigmoid(gate)
        depth = _count(w, "_Head_0.LayerNorm_")
        for i in range(depth):
            x = _layer_norm(w, f"_Head_0.LayerNorm_{i}", _gelu(_dense(w, f"_Head_0.Dense_{i}", x)))
        mean, log_std = _dense(w, f"_Head_0.Dense_{depth}", x).chunk(2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
