"""Intrinsic Curiosity Module (ICM): forward and inverse models, trained.

Counterpart of ``tvc_ai_tpu/models/curiosity.py``: ``CuriosityConfig``,
``ICMNetworks`` (a forward model (s, a) → s' and an inverse model (s, s') →
a, each a 2 × ``hidden_dim`` ReLU MLP), ``CuriosityState``, ``init``,
``intrinsic_reward`` (the forward model's per-sample MSE × ``reward_scale``
on the first ``obs_dim`` observation entries) and ``update`` (one Adam step
on forward MSE + ``inverse_weight`` · inverse MSE, plus an optional
physics-informed term on the forward prediction).

``update`` steps ``state`` in place; ``step`` and the Adam count are host
ints. Nothing is random. Layer names follow the flax tree
(``forward_model.Dense_0``, …).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from tvc_ai_torch.agents import optim
from tvc_ai_torch.models.layers import lecun_dense
from tvc_ai_torch.parallel.mesh import sum_grads_
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class CuriosityConfig:
    obs_dim: int = 8   # the core observation slice obs[:8]
    action_dim: int = 2
    hidden_dim: int = 256
    lr: float = 1e-4
    reward_scale: float = 0.01
    inverse_weight: float = 0.5


class _MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, generator: torch.Generator):
        super().__init__()
        self.Dense_0 = lecun_dense(in_dim, hidden_dim, generator)
        self.Dense_1 = lecun_dense(hidden_dim, hidden_dim, generator)
        self.Dense_2 = lecun_dense(hidden_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Dense_0(x))
        return self.Dense_2(torch.relu(self.Dense_1(x)))


class ICMNetworks(nn.Module):
    def __init__(self, cfg: CuriosityConfig, device: str | torch.device = DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        o, a, h = cfg.obs_dim, cfg.action_dim, cfg.hidden_dim
        self.forward_model = _MLP(o + a, o, h, gen)
        self.inverse_model = _MLP(2 * o, a, h, gen)
        self.to(resolve_device(device))

    def predict_next(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.forward_model(torch.cat([obs, action], dim=-1))

    def predict_action(self, obs: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
        return self.inverse_model(torch.cat([obs, next_obs], dim=-1))

    def forward(self, obs, action, next_obs):
        return self.predict_next(obs, action), self.predict_action(obs, next_obs)


@dataclasses.dataclass
class CuriosityState:
    nets: ICMNetworks
    opt: optim.AdamState
    step: int = 0


def init(cfg: CuriosityConfig, device: str | torch.device = DEFAULT_DEVICE,
         seed: int = 0) -> CuriosityState:
    nets = ICMNetworks(cfg, device, seed)
    return CuriosityState(nets=nets, opt=optim.adam_init(list(nets.parameters())))


@torch.no_grad()
def intrinsic_reward(state: CuriosityState, obs: torch.Tensor, action: torch.Tensor,
                     next_obs: torch.Tensor, cfg: CuriosityConfig) -> torch.Tensor:
    """Per-sample forward-model MSE × ``reward_scale``."""
    pred = state.nets.predict_next(obs[..., : cfg.obs_dim], action)
    return torch.mean((pred - next_obs[..., : cfg.obs_dim]) ** 2, dim=-1) * cfg.reward_scale


def update(
    state: CuriosityState,
    obs: torch.Tensor,
    action: torch.Tensor,
    next_obs: torch.Tensor,
    cfg: CuriosityConfig,
    physics_loss_fn: Callable | None = None,
    axis_name: str | None = None,
) -> tuple[CuriosityState, dict[str, torch.Tensor]]:
    """One joint forward + inverse Adam step, in place.
    ``physics_loss_fn(pred_next, obs, action)`` adds the physics-informed
    penalty on the forward model's prediction; ``axis_name`` all-reduces the
    gradients over the data-parallel ranks (``mesh.sum_grads_``), so the
    replicated ICM stays equal on every rank."""
    o, no = obs[..., : cfg.obs_dim], next_obs[..., : cfg.obs_dim]
    params = list(state.nets.parameters())
    pred_next, pred_action = state.nets(o, action, no)
    fwd = torch.mean((pred_next - no) ** 2)
    inv = torch.mean((pred_action - action) ** 2)
    loss = fwd + cfg.inverse_weight * inv
    if physics_loss_fn is not None:
        phys = physics_loss_fn(pred_next, o, action)
        loss = loss + phys
    else:
        phys = torch.zeros((), device=obs.device)
    grads = sum_grads_(torch.autograd.grad(loss, params), axis_name)
    with torch.no_grad():
        optim.adam_step(params, grads, state.opt, cfg.lr)
    state.step += 1
    return state, {"icm_loss": loss.detach(), "icm_forward_loss": fwd.detach(),
                   "icm_inverse_loss": inv.detach(), "icm_physics_loss": phys.detach()}
