"""Random Network Distillation: a novelty bonus for exploration.

Counterpart of ``tvc_ai_tpu/models/rnd.py``: a frozen, randomly initialized
target network embeds the first ``obs_dim`` observation entries, a
predictor of the same shape is trained to match it, and the per-sample
squared prediction error is the bonus (``raw_bonus``). ``intrinsic_reward``
normalizes it by the running mean and variance, clips it at 0 and scales it
by ``reward_scale``. ``update`` takes one Adam step on the predictor and
moves the normalizer by an EMA of the batch's bonus mean and (ddof 0)
variance, both from the predictor *before* the step.

``update`` changes ``state`` in place; ``step`` and the Adam count are host
ints, ``bonus_mean`` and ``bonus_var`` 0-dim device tensors. The caller
decides the cadence (the loop's ``update_frequency``). Layer names follow
the flax tree (``Dense_0``, …).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tvc_ai_torch.agents import optim
from tvc_ai_torch.models.layers import lecun_dense
from tvc_ai_torch.parallel.mesh import sum_grads_
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class RNDConfig:
    obs_dim: int = 8   # the core observation slice, like the ICM's
    embed_dim: int = 64
    hidden_dims: tuple[int, ...] = (256, 128)
    lr: float = 1e-4
    reward_scale: float = 0.01
    update_frequency: int = 100   # env steps between predictor updates

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))


class Embed(nn.Module):
    """ReLU stack of ``hidden_dims``, then a linear ``embed_dim`` output."""

    def __init__(self, cfg: RNDConfig, generator: torch.Generator):
        super().__init__()
        width = cfg.obs_dim
        for i, h in enumerate(cfg.hidden_dims):
            self.add_module(f"Dense_{i}", lecun_dense(width, h, generator))
            width = h
        self.depth = len(cfg.hidden_dims)
        self.add_module(f"Dense_{self.depth}", lecun_dense(width, cfg.embed_dim, generator))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth}")(x)


@dataclasses.dataclass
class RNDState:
    target: Embed           # frozen
    predictor: Embed
    opt: optim.AdamState
    bonus_mean: torch.Tensor   # () running mean of the raw bonus
    bonus_var: torch.Tensor    # () running variance of the raw bonus
    step: int = 0


def init(cfg: RNDConfig, device: str | torch.device = DEFAULT_DEVICE, seed: int = 0) -> RNDState:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    target = Embed(cfg, gen).to(dev).requires_grad_(False)
    predictor = Embed(cfg, gen).to(dev)
    return RNDState(
        target=target, predictor=predictor,
        opt=optim.adam_init(list(predictor.parameters())),
        bonus_mean=torch.zeros((), device=dev), bonus_var=torch.ones((), device=dev),
    )


def _squared_error(state: RNDState, obs: torch.Tensor, cfg: RNDConfig) -> torch.Tensor:
    o = obs[..., : cfg.obs_dim]
    with torch.no_grad():
        target = state.target(o)
    return (state.predictor(o) - target) ** 2


@torch.no_grad()
def raw_bonus(state: RNDState, obs: torch.Tensor, cfg: RNDConfig) -> torch.Tensor:
    """Per-sample squared prediction error."""
    return torch.mean(_squared_error(state, obs, cfg), dim=-1)


@torch.no_grad()
def intrinsic_reward(state: RNDState, obs: torch.Tensor, cfg: RNDConfig) -> torch.Tensor:
    """The normalized bonus, clipped at 0, × ``reward_scale``."""
    err = raw_bonus(state, obs, cfg)
    z = (err - state.bonus_mean) / torch.sqrt(torch.clamp(state.bonus_var, min=1e-8))
    return torch.clamp(z, min=0.0) * cfg.reward_scale


def update(state: RNDState, obs: torch.Tensor, cfg: RNDConfig, ema: float = 0.99,
           axis_name: str | None = None) -> tuple[RNDState, dict[str, torch.Tensor]]:
    """One predictor Adam step and the normalizer's EMA, in place. With
    ``axis_name`` the gradients (``mesh.sum_grads_``) and the batch's bonus
    mean and variance (averaged) are all-reduced over the data-parallel ranks
    in one all-reduce, so the replicated predictor and normalizer stay equal
    on every rank."""
    sq = _squared_error(state, obs, cfg)
    loss = torch.mean(sq)
    params = list(state.predictor.parameters())
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        err = torch.mean(sq, dim=-1)   # the bonus before the step
        batch_mean = torch.mean(err)
        batch_var = torch.var(err, correction=0)
        *grads, batch_mean, batch_var = sum_grads_(grads, axis_name, [batch_mean, batch_var])
        optim.adam_step(params, grads, state.opt, cfg.lr)
        state.bonus_mean = ema * state.bonus_mean + (1 - ema) * batch_mean
        state.bonus_var = ema * state.bonus_var + (1 - ema) * batch_var
    state.step += 1
    return state, {"rnd_loss": loss.detach(), "rnd_bonus_mean": batch_mean}
