"""Soft Actor-Critic: configuration, state, acting and the update.

Counterpart of ``tvc_ai_tpu/agents/sac.py``. ``SACState`` holds modules and
optimizer states in place of the reference's parameter pytrees: ``actor``,
``critic`` and ``target_critic`` for ``actor_params``, ``critic_params`` and
``target_critic_params``, ``ema_actor`` for ``ema_actor_params``. ``update``
takes one gradient step **in place** on that state (the counterpart of the
reference donating it) and keeps the reference's order exactly:

- the clipped double-Q target uses the pre-update actor, target critic and α;
- the critic steps through ``chain(clip_by_global_norm, adam(schedule))``;
- the actor loss (and the optional Q-filtered BC term) uses the *updated*
  critic; the critic gets no gradient from it;
- the α loss uses the actor loss's log-prob, detached; α steps with plain
  Adam (no clip, no schedule);
- the Polyak update takes τ from ``state.step`` before the increment;
- the EMA actor moves after the actor.

Each gradient is taken with ``torch.autograd.grad``, so nothing accumulates
in ``.grad``. With ``axis_name`` (data parallel, ``parallel.mesh``) the
critic's, the actor's and α's gradients are each all-reduced over the ranks
before their optimizer step, at the reference's three points, so the clip
sees the gradient all ranks share: their sum, as in the reference
(``mesh.sum_grads_`` says why); the returned metrics stay the rank's own. The standard-normal draws of the target's and the actor
loss's actions are explicit (``UpdateDraws``) or come from ``generator``.
``step`` and the optimizer counts are host ints (they count updates), so an
update makes no host-device synchronisation.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from tvc_ai_torch.agents import optim
from tvc_ai_torch.models import distributions as dist
from tvc_ai_torch.models.mlp import GaussianActor, TwinQ
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.parallel.mesh import sum_grads_
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """The reference's ``SACConfig``, field for field, less ``action_noise``
    and ``curriculum_learning``, which the reference never reads.
    ``architecture="transformer"`` gives the actor a ``TransformerActor``
    (any other value the MLP, as in the reference). Not ported, raising
    ``NotImplementedError``: ``compute_dtype="bfloat16"``."""

    hidden_dims: tuple[int, ...] = (256, 256)
    lr_actor: float = 3e-4
    lr_critic: float = 3e-4
    lr_alpha: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2
    automatic_entropy_tuning: bool = True
    target_entropy: float | None = None  # defaults to -action_dim
    batch_size: int = 256
    buffer_size: int = 1_000_000
    learning_starts: int = 1000
    gradient_clip_norm: float = 10.0
    reward_scale: float = 1.0
    lr_schedule: str = "constant"  # one of optim.SCHEDULES
    schedule_total_steps: int = 2_000_000
    warmup_steps: int = 10_000
    initial_lr_factor: float = 0.1
    adaptive_tau: bool = False
    tau_min: float = 0.001
    tau_max: float = 0.01
    tau_decay: float = 0.999
    ema_decay: float = 0.0
    compute_dtype: str = "float32"
    bc_weight: float = 0.0
    architecture: str = "mlp"
    transformer_d_model: int = 256
    transformer_layers: int = 4
    transformer_heads: int = 8

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"SACConfig.compute_dtype={self.compute_dtype!r} is not ported"
            )
        if self.lr_schedule not in optim.SCHEDULES:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")

    def resolved_target_entropy(self, action_dim: int) -> float:
        return (
            float(self.target_entropy)
            if self.target_entropy is not None
            else -float(action_dim)
        )


@dataclasses.dataclass
class SACState:
    """All learnable state; ``update`` changes it in place."""

    actor: GaussianActor | TransformerActor
    critic: TwinQ
    target_critic: TwinQ
    log_alpha: torch.Tensor          # () float32
    actor_opt: optim.AdamState
    critic_opt: optim.AdamState
    alpha_opt: optim.AdamState
    step: int                        # updates taken
    ema_actor: GaussianActor | TransformerActor | None = None  # read through eval_actor_view


@dataclasses.dataclass
class UpdateDraws:
    """The standard-normal noise one update consumes, each (B, action_dim)."""

    n_next: torch.Tensor   # the target's next action
    n_pi: torch.Tensor     # the actor loss's action


@functools.lru_cache(maxsize=16)
def _schedule(lr: float, cfg: SACConfig) -> Callable[[int], float]:
    return optim.make_schedule(cfg.lr_schedule, lr, cfg.schedule_total_steps,
                               cfg.warmup_steps, cfg.initial_lr_factor)


def effective_tau(cfg: SACConfig, update_step: int) -> float:
    """τ, optionally decaying τ_max → τ_min per update (float32 arithmetic)."""
    if not cfg.adaptive_tau:
        return float(np.float32(cfg.tau))
    f32 = np.float32
    return float(max(f32(cfg.tau_min), f32(cfg.tau_max) * f32(cfg.tau_decay) ** f32(update_step)))


def make_actor(
    obs_dim: int,
    action_dim: int,
    cfg: SACConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> GaussianActor | TransformerActor:
    """The actor ``cfg.architecture`` names. The transformer takes only
    ``d_model``, ``num_layers`` and ``num_heads`` from the config, as the
    reference's ``make_networks`` does: its feed-forward width (512) and
    head widths (512, 512) are ``TransformerActor``'s defaults."""
    if cfg.architecture == "transformer":
        return TransformerActor(obs_dim, action_dim, d_model=cfg.transformer_d_model,
                                num_heads=cfg.transformer_heads,
                                num_layers=cfg.transformer_layers, device=device, seed=seed)
    return GaussianActor(obs_dim, action_dim, cfg.hidden_dims, device=device, seed=seed)


def frozen_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` that takes no gradient (a target network)."""
    return copy.deepcopy(module).requires_grad_(False)


def init(
    obs_dim: int,
    action_dim: int,
    cfg: SACConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> SACState:
    """Seeded networks (initialized on the CPU, so the same on any device),
    the target critic a copy of the critic, log α = log(cfg.alpha), zeroed
    optimizer states."""
    dev = resolve_device(device)
    actor = make_actor(obs_dim, action_dim, cfg, dev, seed)
    critic = TwinQ(obs_dim, action_dim, cfg.hidden_dims, device=dev, seed=seed + 1)
    log_alpha = torch.log(torch.tensor(cfg.alpha, dtype=torch.float32)).to(dev)
    return SACState(
        actor=actor,
        critic=critic,
        target_critic=frozen_copy(critic),
        log_alpha=log_alpha,
        actor_opt=optim.adam_init(list(actor.parameters())),
        critic_opt=optim.adam_init(list(critic.parameters())),
        alpha_opt=optim.adam_init([log_alpha]),
        step=0,
        ema_actor=frozen_copy(actor) if cfg.ema_decay > 0 else None,
    )


def eval_actor_view(state: SACState, cfg: SACConfig) -> SACState:
    """The state to evaluate or export: the EMA actor when enabled, else the live one."""
    if cfg.ema_decay > 0 and state.ema_actor is not None:
        return dataclasses.replace(state, actor=state.ema_actor)
    return state


@torch.no_grad()
def select_action(
    actor: GaussianActor | TransformerActor,
    obs: torch.Tensor,
    n_act: torch.Tensor | None = None,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Policy action in [-1, 1] for a batch of observations.

    ``n_act`` (N, action_dim) is the standard-normal exploration noise; it is
    drawn from ``generator`` when not given.
    """
    mean, log_std = actor(obs)
    if deterministic:
        return dist.deterministic_action(mean)
    action, _ = dist.sample_and_log_prob(mean, log_std, n_act, generator)
    return action


def _clipped_adam(params: list[torch.Tensor], grads, state: optim.AdamState, lr: float,
                  cfg: SACConfig) -> None:
    optim.adam_step(params, optim.clip_by_global_norm(grads, cfg.gradient_clip_norm),
                    state, _schedule(lr, cfg)(state.count))


def update(
    state: SACState,
    batch: dict[str, torch.Tensor],
    cfg: SACConfig,
    draws: UpdateDraws | None = None,
    generator: torch.Generator | None = None,
    axis_name: str | None = None,
) -> tuple[SACState, dict[str, torch.Tensor]]:
    """One SAC gradient step on a sampled batch, in place on ``state``.

    batch keys: obs, action, reward, next_obs, done (float 0/1, terminated
    only: truncation bootstraps), and optionally demo_mask (enables the BC
    term when ``cfg.bc_weight > 0``). Returns ``state`` and a dict of 0-dim
    device tensors. ``axis_name`` all-reduces the three gradients over the
    data-parallel ranks.
    """
    obs, action, next_obs = batch["obs"], batch["action"], batch["next_obs"]
    if draws is None:
        shape = (obs.shape[0], action.shape[-1])
        draws = UpdateDraws(
            n_next=torch.randn(shape, device=obs.device, generator=generator),
            n_pi=torch.randn(shape, device=obs.device, generator=generator),
        )
    actor, critic = state.actor, state.critic
    actor_params, critic_params = list(actor.parameters()), list(critic.parameters())

    # ---- critic: clipped double-Q target from the pre-update actor, target and α
    with torch.no_grad():
        alpha = torch.exp(state.log_alpha)
        next_mean, next_log_std = actor(next_obs)
        next_action, next_logp = dist.sample_and_log_prob(next_mean, next_log_std, draws.n_next)
        tq1, tq2 = state.target_critic(next_obs, next_action)
        target_v = torch.minimum(tq1, tq2) - alpha * next_logp
        target_q = batch["reward"] * cfg.reward_scale + cfg.gamma * (1.0 - batch["done"]) * target_v
    q1, q2 = critic(obs, action)
    critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
    critic_grads = sum_grads_(torch.autograd.grad(critic_loss, critic_params), axis_name)
    with torch.no_grad():
        _clipped_adam(critic_params, critic_grads, state.critic_opt, cfg.lr_critic, cfg)

    # ---- actor, against the updated critic (+ optional Q-filtered BC)
    use_bc = cfg.bc_weight > 0 and "demo_mask" in batch
    mean, log_std = actor(obs)
    pi_action, logp = dist.sample_and_log_prob(mean, log_std, draws.n_pi)
    pq1, pq2 = critic(obs, pi_action)
    q = torch.minimum(pq1, pq2)
    actor_loss = torch.mean(alpha * logp - q)
    if use_bc:
        with torch.no_grad():
            dq1, dq2 = critic(obs, action)
            gate = batch["demo_mask"] * (torch.minimum(dq1, dq2) > q).to(q.dtype)
            q_scale = torch.mean(torch.abs(q)) + 1e-6
        per = torch.mean((torch.tanh(mean) - action) ** 2, dim=-1)
        bc_loss = torch.sum(gate * per) / torch.clamp(torch.sum(gate), min=1.0)
        actor_loss = actor_loss + cfg.bc_weight * q_scale * bc_loss
    # the transformer's value head and, over its one-token input, its query
    # and key projections take no part in the loss: zero gradients, as in
    # the reference, so that clipping and Adam see the whole tree
    actor_grads = sum_grads_(torch.autograd.grad(actor_loss, actor_params, allow_unused=True,
                                                materialize_grads=True), axis_name)
    with torch.no_grad():
        _clipped_adam(actor_params, actor_grads, state.actor_opt, cfg.lr_actor, cfg)

    # ---- temperature (automatic entropy tuning; plain Adam)
    if cfg.automatic_entropy_tuning:
        target_entropy = cfg.resolved_target_entropy(action.shape[-1])
        log_alpha = state.log_alpha.detach().requires_grad_(True)
        alpha_loss = -torch.mean(torch.exp(log_alpha) * (logp.detach() + target_entropy))
        (alpha_grad,) = sum_grads_(torch.autograd.grad(alpha_loss, [log_alpha]), axis_name)
        with torch.no_grad():
            optim.adam_step([state.log_alpha], [alpha_grad], state.alpha_opt, cfg.lr_alpha)
    else:
        alpha_loss = torch.zeros((), device=obs.device)

    with torch.no_grad():
        # ---- soft target update, τ from the step before the increment
        optim.polyak(state.target_critic.parameters(), critic_params,
                     effective_tau(cfg, state.step))
        # ---- EMA shadow actor, after the actor step
        if cfg.ema_decay > 0 and state.ema_actor is not None:
            d = float(np.float32(cfg.ema_decay))
            ema_params = list(state.ema_actor.parameters())
            torch._foreach_mul_(ema_params, d)
            torch._foreach_add_(ema_params, actor_params, alpha=1.0 - d)
        metrics = {
            "critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(),
            "alpha_loss": alpha_loss.detach(),
            "alpha": torch.exp(state.log_alpha),
            "q1_mean": torch.mean(q1.detach()),
            "q2_mean": torch.mean(q2.detach()),
            "entropy": -torch.mean(logp.detach()),
        }
        if use_bc:
            metrics["bc_loss"] = bc_loss.detach()
    state.step += 1
    return state, metrics

