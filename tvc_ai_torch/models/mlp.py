"""MLP actor.

Counterpart of ``tvc_ai_tpu/models/mlp.py::GaussianActor``: a ReLU stack,
then separate mean and log_std heads; orthogonal init with gain √2 and zero
bias. Layer names match the flax module's (``hidden_0``, …, ``mean_head``,
``log_std_head``) so ``convert.actor_from_flax`` maps them one to one.
The critics (``TwinQ``) come with the training slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


def _dense(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        # flax's kernel is (in, out): initialize that matrix, store its transpose
        kernel = torch.empty(in_features, out_features)
        nn.init.orthogonal_(kernel, gain=math.sqrt(2.0), generator=generator)
        layer.weight.copy_(kernel.T)
        layer.bias.zero_()
    return layer


class GaussianActor(nn.Module):
    """obs (N, obs_dim) → (mean, log_std), each (N, action_dim); the caller
    squashes with tanh."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_dims: Sequence[int] = (256, 256),
        device: str | torch.device = DEFAULT_DEVICE,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)  # init on the CPU: same weights anywhere
        self.hidden_dims = tuple(hidden_dims)
        width = obs_dim
        for i, h in enumerate(self.hidden_dims):
            self.add_module(f"hidden_{i}", _dense(width, h, gen))
            width = h
        self.mean_head = _dense(width, action_dim, gen)
        self.log_std_head = _dense(width, action_dim, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for i in range(len(self.hidden_dims)):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        return self.mean_head(x), self.log_std_head(x)
