"""Flax's layer defaults, written out for the port's transformer, ICM, RND
and high-level networks.

- ``lecun_dense``: ``nn.Linear`` initialized as flax's default ``Dense``
  (truncated normal, variance 1 / fan_in, zero bias); ``orthogonal_dense``
  as ``Dense(kernel_init=orthogonal(√2))``. Seeded inits differ from
  flax's anyway; ``convert`` carries flax weights across where both
  packages must start equal.
- ``LayerNorm``: flax's, not ``torch.nn.LayerNorm``: epsilon 1e-6 and the
  variance as E[x²] − E[x]² clipped at 0, then
  (x − E[x]) · (rsqrt(var + eps) · scale) + bias.
- ``gelu``: flax's ``nn.gelu``, the tanh approximation.

Layer names follow the flax modules' (``Dense_0``, ``LayerNorm_0``, …), so
``convert`` maps parameters by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tvc_ai_torch.models.mlp import _dense as orthogonal_dense

__all__ = ["LayerNorm", "gelu", "lecun_dense", "orthogonal_dense"]

# flax's truncated normal of unit variance is cut at ±2 standard deviations
_TRUNC_STD = 0.87962566103423978


def lecun_dense(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))   # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
