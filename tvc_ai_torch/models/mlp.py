"""MLP actors, twin critics and the value head.

Counterpart of ``tvc_ai_tpu/models/mlp.py``: ``GaussianActor`` (a ReLU
stack, then separate mean and log_std heads), ``DeterministicActor`` (a
ReLU stack, then a tanh ``action_head``: TD3), ``QNetwork`` (concat(obs,
action), a ReLU stack, a ``q_head`` of width 1, squeezed), ``TwinQ``
(submodules ``q1`` and ``q2``) and ``ValueNetwork`` (a ReLU stack, a
``v_head`` of width 1, squeezed: PPO); orthogonal init with gain √2 and
zero bias, from a seeded CPU generator. Layer names match the flax
modules' (``hidden_0``, …, ``mean_head``, ``log_std_head``,
``action_head``, ``q_head``, ``v_head``) so the ``convert`` functions map
them one to one.
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


def _add_hidden(module: nn.Module, width: int, hidden_dims: Sequence[int],
                generator: torch.Generator) -> int:
    """Add ``hidden_0``, … to ``module``; returns the last width."""
    for i, h in enumerate(hidden_dims):
        module.add_module(f"hidden_{i}", _dense(width, h, generator))
        width = h
    return width


def _relu_stack(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for i in range(len(module.hidden_dims)):
        x = torch.relu(getattr(module, f"hidden_{i}")(x))
    return x


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
        width = _add_hidden(self, obs_dim, self.hidden_dims, gen)
        self.mean_head = _dense(width, action_dim, gen)
        self.log_std_head = _dense(width, action_dim, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = _relu_stack(self, obs)
        return self.mean_head(x), self.log_std_head(x)


class DeterministicActor(nn.Module):
    """obs (N, obs_dim) → tanh action (N, action_dim) (the TD3 policy)."""

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
        gen = torch.Generator().manual_seed(seed)
        self.hidden_dims = tuple(hidden_dims)
        width = _add_hidden(self, obs_dim, self.hidden_dims, gen)
        self.action_head = _dense(width, action_dim, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.action_head(_relu_stack(self, obs)))


class QNetwork(nn.Module):
    """(obs (N, obs_dim), action (N, action_dim)) → Q (N,)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_dims: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        width = _add_hidden(self, obs_dim + action_dim, self.hidden_dims, generator)
        self.q_head = _dense(width, 1, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = _relu_stack(self, torch.cat([obs, action], dim=-1))
        return self.q_head(x)[..., 0]


class TwinQ(nn.Module):
    """Two independent Q networks evaluated in one call (clipped double-Q)."""

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
        gen = torch.Generator().manual_seed(seed)
        self.q1 = QNetwork(obs_dim, action_dim, hidden_dims, gen)
        self.q2 = QNetwork(obs_dim, action_dim, hidden_dims, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.q1(obs, action), self.q2(obs, action)


class ValueNetwork(nn.Module):
    """obs (N, obs_dim) → V (N,) (the PPO baseline)."""

    def __init__(
        self,
        obs_dim: int,
        hidden_dims: Sequence[int] = (256, 256),
        device: str | torch.device = DEFAULT_DEVICE,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.hidden_dims = tuple(hidden_dims)
        width = _add_hidden(self, obs_dim, self.hidden_dims, gen)
        self.v_head = _dense(width, 1, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.v_head(_relu_stack(self, obs))[..., 0]
