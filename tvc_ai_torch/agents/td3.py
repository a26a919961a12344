"""Twin delayed deterministic policy gradient: configuration, state, acting and the update.

Counterpart of ``tvc_ai_tpu/agents/td3.py``. ``TD3State`` holds modules and
optimizer states in place of the reference's parameter pytrees (``actor``,
``critic``, ``target_actor``, ``target_critic``). ``update`` takes one
gradient step **in place** on that state, in the reference's order:

- the critic's target: the target actor's action plus clipped smoothing
  noise, clipped to [-1, 1], through the target critic (clipped double-Q,
  no reward scale, terminated-only ``done``);
- the critic steps through ``chain(clip_by_global_norm, adam(lr))``;
- on every ``policy_delay``-th update (``(step + 1) % policy_delay == 0``)
  the actor steps against the *updated* critic's ``q1``, then both targets
  move by Polyak averaging with τ; otherwise the actor loss reads 0.

``step`` and the optimizer counts are host ints, so the delay is decided on
the host with no synchronisation. The smoothing noise is explicit
(``noise``, a standard normal (B, action_dim)) or drawn from ``generator``.
With ``axis_name`` (data parallel) the critic's and the actor's gradients
are all-reduced over the ranks before the optimizer steps (summed, as the
reference's are: ``mesh.sum_grads_``), and the reported actor loss is
averaged in the same all-reduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tvc_ai_torch.agents import optim
from tvc_ai_torch.agents.sac import frozen_copy
from tvc_ai_torch.models.mlp import DeterministicActor, TwinQ
from tvc_ai_torch.parallel.mesh import sum_grads_
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class TD3Config:
    hidden_dims: tuple[int, ...] = (256, 256)
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    buffer_size: int = 1_000_000
    learning_starts: int = 100
    policy_delay: int = 2
    target_policy_noise: float = 0.2
    target_noise_clip: float = 0.5
    exploration_noise: float = 0.1
    gradient_clip_norm: float = 10.0

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))


@dataclasses.dataclass
class TD3State:
    """All learnable state; ``update`` changes it in place."""

    actor: DeterministicActor
    critic: TwinQ
    target_actor: DeterministicActor
    target_critic: TwinQ
    actor_opt: optim.AdamState
    critic_opt: optim.AdamState
    step: int                        # updates taken


def init(
    obs_dim: int,
    action_dim: int,
    cfg: TD3Config,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> TD3State:
    """Seeded networks (initialized on the CPU), the targets copies of them,
    zeroed optimizer states."""
    dev = resolve_device(device)
    actor = DeterministicActor(obs_dim, action_dim, cfg.hidden_dims, device=dev, seed=seed)
    critic = TwinQ(obs_dim, action_dim, cfg.hidden_dims, device=dev, seed=seed + 1)
    return TD3State(
        actor=actor,
        critic=critic,
        target_actor=frozen_copy(actor),
        target_critic=frozen_copy(critic),
        actor_opt=optim.adam_init(list(actor.parameters())),
        critic_opt=optim.adam_init(list(critic.parameters())),
        step=0,
    )


@torch.no_grad()
def select_action(
    actor: DeterministicActor,
    obs: torch.Tensor,
    cfg: TD3Config,
    n_act: torch.Tensor | None = None,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The policy's action, plus ``exploration_noise`` × ``n_act`` (a
    standard normal (N, action_dim), drawn from ``generator`` when not
    given) clipped to [-1, 1] unless ``deterministic``."""
    action = actor(obs)
    if deterministic:
        return action
    if n_act is None:
        n_act = torch.randn(action.shape, device=action.device, generator=generator)
    return torch.clamp(action + n_act * cfg.exploration_noise, -1.0, 1.0)


def update(
    state: TD3State,
    batch: dict[str, torch.Tensor],
    cfg: TD3Config,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    axis_name: str | None = None,
) -> tuple[TD3State, dict[str, torch.Tensor]]:
    """One TD3 gradient step on a sampled batch, in place on ``state``.

    batch keys: obs, action, reward, next_obs, done (float 0/1, terminated
    only). ``noise`` (B, action_dim) is the standard normal of the target
    smoothing. Returns ``state`` and ``critic_loss`` / ``actor_loss`` as
    0-dim device tensors.
    """
    obs, action, next_obs = batch["obs"], batch["action"], batch["next_obs"]
    if noise is None:
        noise = torch.randn(action.shape, device=obs.device, generator=generator)
    actor_params, critic_params = list(state.actor.parameters()), list(state.critic.parameters())

    # ---- critic with target-policy smoothing
    with torch.no_grad():
        smoothing = torch.clamp(noise * cfg.target_policy_noise,
                                -cfg.target_noise_clip, cfg.target_noise_clip)
        next_action = torch.clamp(state.target_actor(next_obs) + smoothing, -1.0, 1.0)
        tq1, tq2 = state.target_critic(next_obs, next_action)
        target_q = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * torch.minimum(tq1, tq2)
    q1, q2 = state.critic(obs, action)
    critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
    critic_grads = sum_grads_(torch.autograd.grad(critic_loss, critic_params), axis_name)
    with torch.no_grad():
        optim.adam_step(critic_params,
                        optim.clip_by_global_norm(critic_grads, cfg.gradient_clip_norm),
                        state.critic_opt, cfg.lr)

    # ---- delayed policy and target update, against the updated critic
    if (state.step + 1) % cfg.policy_delay == 0:
        actor_loss = -torch.mean(state.critic.q1(obs, state.actor(obs)))
        # the reported loss rides the gradients' all-reduce (the reference
        # pmeans it too)
        *actor_grads, actor_loss = sum_grads_(
            torch.autograd.grad(actor_loss, actor_params), axis_name, [actor_loss.detach()])
        with torch.no_grad():
            optim.adam_step(actor_params,
                            optim.clip_by_global_norm(actor_grads, cfg.gradient_clip_norm),
                            state.actor_opt, cfg.lr)
            tau = float(np.float32(cfg.tau))
            optim.polyak(state.target_actor.parameters(), actor_params, tau)
            optim.polyak(state.target_critic.parameters(), critic_params, tau)
    else:
        actor_loss = torch.zeros((), device=obs.device)
    state.step += 1
    return state, {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss}
