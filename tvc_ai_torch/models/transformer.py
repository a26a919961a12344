"""The transformer policy network and its SAC actor facade.

Counterpart of ``tvc_ai_tpu/models/transformer.py``: ``sinusoidal_encoding``,
``SqueezeExcitation``, ``EncoderLayer`` (pre-norm: LayerNorm, multi-head
self-attention, residual; LayerNorm, Dense, GELU, Dense, residual),
``_Head`` (Dense, GELU, LayerNorm per hidden width, then an output Dense),
``TransformerPolicyNetwork`` (obs → Dense embed + positional encoding →
encoder layers → last token → LayerNorm → squeeze-excitation → a policy
head (mean, log_std clamped to [-20, 2]) and a value head) and
``TransformerActor`` (obs → (mean, log_std), the value dropped).

The numerics are flax's (``models.layers``): LayerNorm with epsilon 1e-6 and
the E[x²] − E[x]² variance, the tanh GELU, and ``MultiHeadDotProductAttention``
with biased q/k/v projections, the query scaled by 1/√head_dim before the
dot product, a float32 softmax and a biased output projection. Attention is
``einsum`` + ``softmax``. Two shortcuts are exact:

- over a single key (``sequence_length`` 1, how ``TransformerActor`` calls
  the network) the softmax is exactly 1, so the output is the value
  projection itself; the query and key projections stay as parameters (the
  reference has them, and ``convert`` and the Adam state line up with its
  tree) and get zero gradients, as they do in the reference;
- ``TransformerActor`` skips the value head, whose output the reference
  drops; its parameters stay, with zero gradients.

Dropout is left out: every caller of the reference runs the network
deterministic. Module and parameter names follow the flax tree
(``TransformerPolicyNetwork_0.EncoderLayer_0.MultiHeadDotProductAttention_0
.query``, …): a q/k/v kernel (d_model, heads, head_dim) is held as an
``nn.Linear`` of d_model → heads·head_dim, the out kernel (heads,
head_dim, d_model) as one of heads·head_dim → d_model. There is no top-level
``hidden_0``, so the dormant-unit surgery leaves the transformer alone, as
the reference does.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tvc_ai_torch.models.distributions import clamp_log_std
from tvc_ai_torch.models.layers import LayerNorm, gelu, lecun_dense, orthogonal_dense
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


def sinusoidal_encoding(max_len: int, d_model: int) -> torch.Tensor:
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


class SqueezeExcitation(nn.Module):
    """Feature recalibration: x · sigmoid(Dense(relu(Dense(x))))."""

    def __init__(self, channels: int, generator: torch.Generator, reduction: int = 16):
        super().__init__()
        squeezed = max(channels // reduction, 1)
        self.Dense_0 = lecun_dense(channels, squeezed, generator)
        self.Dense_1 = lecun_dense(squeezed, channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(x))))


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention with ``qkv_features = d_model``."""

    def __init__(self, d_model: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, d_model // num_heads
        self.query = lecun_dense(d_model, d_model, generator)
        self.key = lecun_dense(d_model, d_model, generator)
        self.value = lecun_dense(d_model, d_model, generator)
        self.out = lecun_dense(d_model, d_model, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        heads = (b, s, self.num_heads, self.head_dim)
        v = self.value(x).view(heads)
        if s == 1:
            o = v   # softmax over one key is exactly 1
        else:
            q = self.query(x).view(heads) / math.sqrt(self.head_dim)
            k = self.key(x).view(heads)
            w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(b, s, -1))


class EncoderLayer(nn.Module):
    """Pre-norm transformer encoder block."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 generator: torch.Generator):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, num_heads, generator)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = lecun_dense(d_model, dim_feedforward, generator)
        self.Dense_1 = lecun_dense(dim_feedforward, d_model, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))


class _Head(nn.Module):
    """Dense + GELU + LayerNorm per hidden width, then the output Dense
    (orthogonal init, gain √2)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int], out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.depth = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            self.add_module(f"Dense_{i}", orthogonal_dense(in_features, h, generator))
            self.add_module(f"LayerNorm_{i}", LayerNorm(h))
            in_features = h
        self.add_module(f"Dense_{self.depth}", orthogonal_dense(in_features, out_dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"LayerNorm_{i}")(gelu(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.depth}")(x)


class TransformerPolicyNetwork(nn.Module):
    """obs → (mean, log_std, value). ``token_dim`` is the width of one token:
    the whole observation for ``sequence_length`` 1."""

    def __init__(
        self,
        token_dim: int,
        action_dim: int,
        d_model: int = 256,
        num_heads: int = 8,
        num_layers: int = 4,
        dim_feedforward: int = 512,
        head_hidden_dims: Sequence[int] = (512, 512),
        use_squeeze_excitation: bool = True,
        max_len: int = 5000,
        device: str | torch.device = DEFAULT_DEVICE,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)   # init on the CPU: same weights anywhere
        self.action_dim = action_dim
        self.num_layers = num_layers
        self.use_squeeze_excitation = use_squeeze_excitation
        self.Dense_0 = orthogonal_dense(token_dim, d_model, gen)
        for i in range(num_layers):
            self.add_module(f"EncoderLayer_{i}",
                            EncoderLayer(d_model, num_heads, dim_feedforward, gen))
        self.LayerNorm_0 = LayerNorm(d_model)
        if use_squeeze_excitation:
            self.SqueezeExcitation_0 = SqueezeExcitation(d_model, gen)
        self._Head_0 = _Head(d_model, head_hidden_dims, action_dim * 2, gen)
        self._Head_1 = _Head(d_model, head_hidden_dims, 1, gen)
        self.register_buffer("pe", sinusoidal_encoding(max_len, d_model), persistent=False)
        self.to(dev)

    def forward(self, obs: torch.Tensor, sequence_length: int = 1, with_value: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """obs (B, obs_dim) for sequence length 1, or (B, S·obs_dim) / (B, S,
        obs_dim). The value is None when ``with_value`` is false."""
        batch = obs.shape[0]
        if obs.dim() == 2 and sequence_length > 1:
            obs = obs.reshape(batch, sequence_length, -1)
        elif obs.dim() == 2:
            obs = obs[:, None, :]
        x = self.Dense_0(obs)
        x = x + self.pe[: x.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"EncoderLayer_{i}")(x)
        x = self.LayerNorm_0(x[:, -1, :])   # last-token pooling
        if self.use_squeeze_excitation:
            x = self.SqueezeExcitation_0(x)
        mean, log_std = self._Head_0(x).split(self.action_dim, dim=-1)
        value = self._Head_1(x)[..., 0] if with_value else None
        return mean, clamp_log_std(log_std), value


class TransformerActor(nn.Module):
    """``GaussianActor``-compatible facade: obs → (mean, log_std)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        d_model: int = 256,
        num_heads: int = 8,
        num_layers: int = 4,
        dim_feedforward: int = 512,
        head_hidden_dims: Sequence[int] = (512, 512),
        device: str | torch.device = DEFAULT_DEVICE,
        seed: int = 0,
    ):
        super().__init__()
        self.TransformerPolicyNetwork_0 = TransformerPolicyNetwork(
            obs_dim, action_dim, d_model, num_heads, num_layers, dim_feedforward,
            head_hidden_dims, device=device, seed=seed)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        mean, log_std, _ = self.TransformerPolicyNetwork_0(obs, with_value=False)
        return mean, log_std
