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

``dtype`` is the compute dtype of the hidden stack, as in the reference:
``torch.float32`` (default) or ``torch.bfloat16``. The parameters stay
float32 ``nn.Linear``s either way (so ``convert``, checkpoints and Adam do not
change). In bfloat16 a hidden layer casts its input, weight and bias to
bfloat16, takes ``x @ Wᵀ`` in bfloat16 and then adds the bias as a separate
bfloat16 op: flax's ``Dense`` rounds twice (after the product and after the
bias), where a fused ``addmm`` would round once. The heads cast their input
back to float32 and compute in float32, as the reference's do.
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
                generator: torch.Generator, dtype: torch.dtype) -> int:
    """Add ``hidden_0``, … to ``module`` and set its ``hidden_dims`` and
    compute ``dtype``; returns the last width."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is neither torch.float32 nor torch.bfloat16")
    module.hidden_dims = tuple(hidden_dims)
    module.dtype = dtype
    for i, h in enumerate(module.hidden_dims):
        module.add_module(f"hidden_{i}", _dense(width, h, generator))
        width = h
    return width


def _hidden(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return layer(x)
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).T)
    return y + layer.bias.to(dtype)


def _relu_stack(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The hidden stack in ``module.dtype``; the output is float32 for the heads."""
    for i in range(len(module.hidden_dims)):
        x = torch.relu(_hidden(getattr(module, f"hidden_{i}"), x, module.dtype))
    return x.float()


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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)  # init on the CPU: same weights anywhere
        width = _add_hidden(self, obs_dim, hidden_dims, gen, dtype)
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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        width = _add_hidden(self, obs_dim, hidden_dims, gen, dtype)
        self.action_head = _dense(width, action_dim, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.action_head(_relu_stack(self, obs)))


class QNetwork(nn.Module):
    """(obs (N, obs_dim), action (N, action_dim)) → Q (N,)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_dims: Sequence[int],
                 generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = _add_hidden(self, obs_dim + action_dim, hidden_dims, generator, dtype)
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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.q1 = QNetwork(obs_dim, action_dim, hidden_dims, gen, dtype)
        self.q2 = QNetwork(obs_dim, action_dim, hidden_dims, gen, dtype)
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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        width = _add_hidden(self, obs_dim, hidden_dims, gen, dtype)
        self.v_head = _dense(width, 1, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.v_head(_relu_stack(self, obs))[..., 0]
