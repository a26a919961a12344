"""Hierarchical RL: a high-level goal policy over a goal-conditioned low level.

Counterpart of ``tvc_ai_tpu/models/hierarchical.py``. ``HighLevelPolicy``
(obs → Dense 256, GELU, LayerNorm → Dense 128, GELU, LayerNorm → goal logits)
picks one of ``num_goals`` discrete goals; the low level consumes
[obs ‖ goal one-hot].

- The fused loop's high level (``training.loop`` ``use_hierarchical``):
  ``HighLevelState``, ``init_high``, ``sample_goal`` and
  ``update_high_masked``, a REINFORCE step with a moving baseline over the
  finished episodes a mask selects.
- The module's other API: ``HierarchicalState`` with a transformer low
  level, ``init``, ``select_goal``, ``get_action`` and
  ``update_high_level``.

Goal draws: ``jax.random.categorical`` is the Gumbel-max trick, so a goal is
``argmax(logits + g)`` with ``g`` standard Gumbel noise (N, num_goals), given
explicitly or drawn from a generator (``gumbel``).

``update_high_masked`` changes nothing when the mask is empty (no episode
finished): the parameters, the Adam moments *and count* and the baseline
keep their values, and ``step`` rises by one only when it is not. The port
decides that without reading the device: the high level's Adam count and
``step`` are device tensors, the bias correction is computed on the device,
and the new values are selected with ``torch.where``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tvc_ai_torch.agents import optim
from tvc_ai_torch.models.layers import LayerNorm, gelu, lecun_dense
from tvc_ai_torch.models.transformer import TransformerPolicyNetwork
from tvc_ai_torch.parallel.mesh import sum_grads_
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

GOALS = ("hover", "land", "recover", "maintain_altitude")


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    num_goals: int = len(GOALS)
    high_level_lr: float = 1e-4
    low_level_lr: float = 3e-4
    d_model: int = 256
    num_layers: int = 4


class HighLevelPolicy(nn.Module):
    """obs → goal logits."""

    def __init__(self, obs_dim: int, num_goals: int = len(GOALS),
                 device: str | torch.device = DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = lecun_dense(obs_dim, 256, gen)
        self.LayerNorm_0 = LayerNorm(256)
        self.Dense_1 = lecun_dense(256, 128, gen)
        self.LayerNorm_1 = LayerNorm(128)
        self.Dense_2 = lecun_dense(128, num_goals, gen)
        self.to(resolve_device(device))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.LayerNorm_0(gelu(self.Dense_0(obs)))
        x = self.LayerNorm_1(gelu(self.Dense_1(x)))
        return self.Dense_2(x)


def gumbel(shape, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """Standard Gumbel noise, −log(−log U) with U in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, device=device, generator=generator) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def _categorical(logits: torch.Tensor, g: torch.Tensor | None,
                 generator: torch.Generator | None) -> torch.Tensor:
    if g is None:
        g = gumbel(logits.shape, logits.device, generator)
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def one_hot(goal: torch.Tensor, num_goals: int, dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(goal.to(torch.int64), num_goals).to(dtype)


# ---------------------------------------------------------------------------
# the fused loop's high level


@dataclasses.dataclass
class HighLevelState:
    policy: HighLevelPolicy
    opt: optim.AdamState   # ``count`` is a 0-dim int32 device tensor
    baseline: torch.Tensor  # () moving-average return baseline
    step: torch.Tensor      # () int32 updates that saw a finished episode


def init_high(obs_dim: int, cfg: HierarchicalConfig,
              device: str | torch.device = DEFAULT_DEVICE, seed: int = 0) -> HighLevelState:
    dev = resolve_device(device)
    policy = HighLevelPolicy(obs_dim, cfg.num_goals, dev, seed)
    opt = optim.adam_init(list(policy.parameters()))
    opt.count = torch.zeros((), dtype=torch.int32, device=dev)
    return HighLevelState(policy=policy, opt=opt, baseline=torch.zeros((), device=dev),
                          step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def sample_goal(state: HighLevelState, obs: torch.Tensor, cfg: HierarchicalConfig,
                g: torch.Tensor | None = None, generator: torch.Generator | None = None,
                deterministic: bool = False) -> torch.Tensor:
    """Goal index per row (int32): softmax-multinomial through the Gumbel
    draws ``g`` (N, num_goals), or argmax when ``deterministic``."""
    logits = state.policy(obs)
    if deterministic:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _categorical(logits, g, generator)


def update_high_masked(
    state: HighLevelState,
    obs: torch.Tensor,        # (B, obs_dim) obs at goal selection
    goal_idx: torch.Tensor,   # (B,)
    returns: torch.Tensor,    # (B,)
    mask: torch.Tensor,       # (B,) 1.0 = a valid episode
    cfg: HierarchicalConfig,
    axis_name: str | None = None,
) -> tuple[HighLevelState, dict[str, torch.Tensor]]:
    """Masked REINFORCE step over a ring of finished episodes, in place;
    nothing moves when ``mask`` is all zero (decided on the device). With
    ``axis_name`` the gradients (``mesh.sum_grads_``), and the mean return,
    the any-episode flag and the loss (averaged), are all-reduced over the
    data-parallel ranks in one all-reduce, and nothing moves only when no
    rank saw an episode."""
    params = list(state.policy.parameters())
    total = torch.sum(mask)
    denom = torch.clamp(total, min=1.0)
    advantage = (returns - state.baseline) * mask
    logp = torch.log_softmax(state.policy(obs), dim=-1)
    chosen = torch.gather(logp, -1, goal_idx.to(torch.int64)[:, None])[:, 0]
    loss = -torch.sum(chosen * advantage) / denom
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        mean_return = torch.sum(returns * mask) / denom
        loss = loss.detach()
        any_frac = (total > 0).to(torch.float32)
        *grads, mean_return, any_frac, loss = sum_grads_(
            grads, axis_name, [mean_return, any_frac, loss])
        has_any = any_frac > 0
        opt = state.opt
        mu = torch._foreach_add(torch._foreach_mul(opt.mu, optim.B1), grads, alpha=1.0 - optim.B1)
        nu = torch._foreach_mul(opt.nu, optim.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - optim.B2)
        count = opt.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(optim.B1, t)
        bc2 = 1.0 - torch.pow(optim.B2, t)
        denom_nu = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom_nu)
        torch._foreach_add_(denom_nu, optim.EPS)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom_nu)
        torch._foreach_mul_(step, -cfg.high_level_lr)
        new_params = torch._foreach_add(params, step)
        for old, new in zip(params, new_params):
            old.copy_(torch.where(has_any, new, old))
        opt.mu = [torch.where(has_any, new, old) for new, old in zip(mu, opt.mu)]
        opt.nu = [torch.where(has_any, new, old) for new, old in zip(nu, opt.nu)]
        opt.count = torch.where(has_any, count, opt.count)
        state.baseline = torch.where(has_any, 0.9 * state.baseline + 0.1 * mean_return,
                                     state.baseline)
        state.step = state.step + has_any.to(torch.int32)
    return state, {"high_level_loss": loss, "high_level_baseline": state.baseline}


# ---------------------------------------------------------------------------
# the module's other API: a transformer low level beside the high level


@dataclasses.dataclass
class HierarchicalState:
    high: HighLevelPolicy
    low: TransformerPolicyNetwork
    high_opt: optim.AdamState
    low_opt: optim.AdamState
    baseline: torch.Tensor   # () moving-average return baseline


def make_networks(obs_dim: int, action_dim: int, cfg: HierarchicalConfig,
                  device: str | torch.device = DEFAULT_DEVICE, seed: int = 0):
    """(high level on obs, transformer low level on [obs ‖ goal one-hot])."""
    high = HighLevelPolicy(obs_dim, cfg.num_goals, device, seed)
    low = TransformerPolicyNetwork(obs_dim + cfg.num_goals, action_dim, d_model=cfg.d_model,
                                   num_layers=cfg.num_layers, device=device, seed=seed + 1)
    return high, low


def init(obs_dim: int, action_dim: int, cfg: HierarchicalConfig,
         device: str | torch.device = DEFAULT_DEVICE, seed: int = 0) -> HierarchicalState:
    high, low = make_networks(obs_dim, action_dim, cfg, device, seed)
    return HierarchicalState(
        high=high, low=low,
        high_opt=optim.adam_init(list(high.parameters())),
        low_opt=optim.adam_init(list(low.parameters())),
        baseline=torch.zeros((), device=resolve_device(device)),
    )


@torch.no_grad()
def select_goal(state: HierarchicalState, obs: torch.Tensor, cfg: HierarchicalConfig,
                g: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Softmax-multinomial goal per row through the Gumbel draws ``g``."""
    return _categorical(state.high(obs), g, generator)


@torch.no_grad()
def get_action(state: HierarchicalState, obs: torch.Tensor, goal_idx: torch.Tensor,
               cfg: HierarchicalConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, log_std, value) of the goal-conditioned low level."""
    view = torch.cat([obs, one_hot(goal_idx, cfg.num_goals, obs.dtype)], dim=-1)
    return state.low(view)


def update_high_level(
    state: HierarchicalState,
    obs: torch.Tensor,        # (B, obs_dim) states where goals were chosen
    goal_idx: torch.Tensor,   # (B,)
    returns: torch.Tensor,    # (B,) episode or segment returns
    cfg: HierarchicalConfig,
) -> tuple[HierarchicalState, dict[str, torch.Tensor]]:
    """REINFORCE with a moving baseline, in place (plain Adam, host count)."""
    params = list(state.high.parameters())
    advantage = returns - state.baseline
    logp = torch.log_softmax(state.high(obs), dim=-1)
    chosen = torch.gather(logp, -1, goal_idx.to(torch.int64)[:, None])[:, 0]
    loss = -torch.mean(chosen * advantage)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        optim.adam_step(params, grads, state.high_opt, cfg.high_level_lr)
        state.baseline = 0.99 * state.baseline + 0.01 * torch.mean(returns)
    return state, {"high_level_loss": loss.detach(), "baseline": state.baseline}
