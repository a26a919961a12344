"""PPO: clipped surrogate, GAE, minibatched epochs, and the stand-alone iteration.

Counterpart of ``tvc_ai_tpu/agents/ppo.py``. ``PPOState`` holds the
``GaussianActor``, the ``ValueNetwork`` and **one** optimizer over both (the
reference's tuple ``(actor_params, value_params)``): one global norm,
clipped at ``max_grad_norm``, covers both networks, then Adam at a constant
lr. ``update`` takes one clipped-surrogate step in place, in the
reference's order: the log-prob of the stored pre-tanh action, the ratio,
advantages normalized over the minibatch (population std, ddof 0, as
``jnp.std``), the clipped objective, the value loss, the entropy of the
pre-squash Gaussian (Σ clamp(log σ) + ½ log(2πe), the tanh correction left
out).

``learn`` is the on-policy phase after a rollout: GAE as a reverse loop
over T (bootstrapping through truncation: ``done`` is terminated only),
then ``n_epochs`` epochs, each a permutation of the T·N rows truncated to
``num_minibatches`` minibatches. The permutations are explicit (``perms``)
or drawn from ``generator``.

``make_train_iteration`` is the stand-alone fused iteration: T steps of
act and ``rocket_env.batched_step_autoreset`` (K1 on the card), then
``learn``. Each step's draws are explicit (``loop.StepDraws``) or come from
the generator, which stands in for the reference's key.

With ``axis_name`` (data parallel, ``parallel.mesh``) each update's
gradient is all-reduced over the ranks before the clip (summed, as the
reference's is: ``mesh.sum_grads_``), and the iteration's metrics are
averaged over the ranks at its end. Each rank
permutes its own rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from tvc_ai_torch.agents import optim, sac
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.models import distributions as dist
from tvc_ai_torch.models.mlp import GaussianActor, ValueNetwork
from tvc_ai_torch.parallel.mesh import pmean_, sum_grads_
from tvc_ai_torch.training.loop import StepDraws
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

# the Gaussian's entropy per dimension past log σ: ½ log(2πe)
ENTROPY_OFFSET = 0.5 * math.log(2.0 * math.pi * math.e)
UPDATE_METRICS = ("ppo_loss", "policy_loss", "value_loss", "entropy", "approx_kl",
                  "clip_fraction")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    hidden_dims: tuple[int, ...] = (256, 256)
    learning_rate: float = 2.5e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    n_epochs: int = 10
    num_minibatches: int = 8
    normalize_advantages: bool = True

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))


@dataclasses.dataclass
class PPOState:
    """All learnable state; ``update`` changes it in place."""

    actor: GaussianActor
    value: ValueNetwork
    opt: optim.AdamState    # over the actor's, then the value network's parameters
    step: int               # updates taken


def parameters(state: PPOState) -> list[torch.Tensor]:
    """The optimizer's parameters: the actor's, then the value network's."""
    return [*state.actor.parameters(), *state.value.parameters()]


def init(
    obs_dim: int,
    action_dim: int,
    cfg: PPOConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> PPOState:
    """Seeded networks (initialized on the CPU) and a zeroed optimizer state."""
    dev = resolve_device(device)
    actor = GaussianActor(obs_dim, action_dim, cfg.hidden_dims, device=dev, seed=seed)
    value = ValueNetwork(obs_dim, cfg.hidden_dims, device=dev, seed=seed + 1)
    return PPOState(actor=actor, value=value,
                    opt=optim.adam_init([*actor.parameters(), *value.parameters()]), step=0)


def select_action(
    state: PPOState,
    obs: torch.Tensor,
    deterministic: bool = False,
    n_act: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The policy's action in [-1, 1]: tanh(mean), or the tanh-Gaussian
    sample at the clamped log std with standard-normal noise ``n_act``
    (drawn from ``generator`` when not given), as ``act`` samples."""
    return sac.select_action(state.actor, obs, n_act, deterministic, generator)


@torch.no_grad()
def act(
    state: PPOState,
    obs: torch.Tensor,
    n_act: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(action, pre_tanh, log_prob, value) of an on-policy step: what the
    rollout stores for the update."""
    mean, log_std = state.actor(obs)
    log_std = dist.clamp_log_std(log_std)
    if n_act is None:
        n_act = torch.randn(mean.shape, device=mean.device, generator=generator)
    pre_tanh = mean + torch.exp(log_std) * n_act
    return (torch.tanh(pre_tanh), pre_tanh, dist.log_prob(mean, log_std, pre_tanh),
            state.value(obs))


def compute_gae(
    rewards: torch.Tensor,     # (T, N)
    values: torch.Tensor,      # (T, N)
    dones: torch.Tensor,       # (T, N) terminated (bootstrap through truncation)
    last_value: torch.Tensor,  # (N,)
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE as a reverse loop over T; returns (advantages, returns)."""
    nonterminal = 1.0 - dones
    next_values = torch.cat([values[1:], last_value[None]])
    deltas = rewards + gamma * next_values * nonterminal - values
    decay = gamma * lam * nonterminal
    gae = torch.zeros_like(last_value)
    advantages = []
    for t in reversed(range(rewards.shape[0])):
        gae = deltas[t] + decay[t] * gae
        advantages.append(gae)
    advantages = torch.stack(advantages[::-1])
    return advantages, advantages + values


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """(adv − mean) / (std + 1e-8) with the population std (ddof 0, as ``jnp.std``)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def update(
    state: PPOState,
    batch: dict[str, torch.Tensor],
    cfg: PPOConfig,
    axis_name: str | None = None,
) -> tuple[PPOState, dict[str, torch.Tensor]]:
    """One clipped-surrogate gradient step on a minibatch with keys
    obs / pre_tanh / log_prob / advantage / return, in place on ``state``.
    Returns ``state`` and a dict of 0-dim device tensors (the rank's own
    under ``axis_name``, which all-reduces the gradient)."""
    params = parameters(state)
    mean, log_std = state.actor(batch["obs"])
    logp = dist.log_prob(mean, log_std, batch["pre_tanh"])
    ratio = torch.exp(logp - batch["log_prob"])
    adv = batch["advantage"]
    if cfg.normalize_advantages:
        adv = normalize_advantages(adv)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_range, 1 + cfg.clip_range) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = torch.mean((state.value(batch["obs"]) - batch["return"]) ** 2)
    entropy = torch.mean(torch.sum(dist.clamp_log_std(log_std) + ENTROPY_OFFSET, dim=-1))
    total = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    grads = sum_grads_(torch.autograd.grad(total, params), axis_name)
    with torch.no_grad():
        optim.adam_step(params, optim.clip_by_global_norm(grads, cfg.max_grad_norm), state.opt,
                        cfg.learning_rate)
        metrics = {
            "ppo_loss": total.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": entropy.detach(),
            "approx_kl": torch.mean(batch["log_prob"] - logp.detach()),
            "clip_fraction": torch.mean(
                (torch.abs(ratio.detach() - 1.0) > cfg.clip_range).to(torch.float32)),
        }
    state.step += 1
    return state, metrics


def learn(
    state: PPOState,
    traj: dict[str, torch.Tensor],
    last_value: torch.Tensor,
    cfg: PPOConfig,
    perms: Sequence[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    axis_name: str | None = None,
) -> tuple[PPOState, dict[str, torch.Tensor]]:
    """GAE and ``n_epochs`` epochs of minibatch updates on a rollout.

    ``traj`` holds (T, N, ...) tensors obs / pre_tanh / log_prob / value /
    reward / done; ``perms`` one permutation of the T·N rows per epoch.
    The metrics are the mean over each epoch's minibatches, then over the
    epochs (the rank's own; ``axis_name`` reaches each update).
    """
    if perms is not None and len(perms) != cfg.n_epochs:
        raise ValueError(f"{len(perms)} permutations, want {cfg.n_epochs}")
    advantages, returns = compute_gae(traj["reward"], traj["value"], traj["done"], last_value,
                                      cfg.gamma, cfg.gae_lambda)
    rows = advantages.numel()
    flat = {
        "obs": traj["obs"].reshape(rows, -1),
        "pre_tanh": traj["pre_tanh"].reshape(rows, -1),
        "log_prob": traj["log_prob"].reshape(rows),
        "advantage": advantages.reshape(rows),
        "return": returns.reshape(rows),
    }
    n_mb = cfg.num_minibatches
    mb_size = max(rows // n_mb, 1)
    per_update = []
    for e in range(cfg.n_epochs):
        perm = (perms[e] if perms is not None
                else torch.randperm(rows, device=advantages.device, generator=generator))
        idx = perm[: mb_size * n_mb].reshape(n_mb, mb_size)
        for i in range(n_mb):
            state, m = update(state, {k: v.index_select(0, idx[i]) for k, v in flat.items()}, cfg,
                              axis_name)
            per_update.append(torch.stack([m[k] for k in UPDATE_METRICS]))
    means = torch.stack(per_update).reshape(cfg.n_epochs, n_mb, -1).mean(dim=1).mean(dim=0)
    return state, dict(zip(UPDATE_METRICS, means.unbind()))


def make_train_iteration(
    cfg: PPOConfig,
    num_envs: int,
    rollout_steps: int,
    obs_dim: int,
    action_dim: int,
    axis_name: str | None = None,
):
    """Build ``train_iteration(state, env_states, obs, generator, env_params,
    draws=None, perms=None) -> (state, env_states, obs, generator, metrics)``:
    ``rollout_steps`` on-policy steps of ``num_envs`` envs, then ``learn``.
    ``draws`` holds one ``StepDraws`` per step; ``metrics`` holds 0-dim
    device tensors (the update means, ``reward_mean`` and ``success_rate``
    over the episodes that ended; averaged over the ranks under
    ``axis_name``)."""

    def train_iteration(state: PPOState, env_states: EnvState, obs: torch.Tensor,
                        generator: torch.Generator | None, env_params: EnvParams,
                        draws: Sequence[StepDraws] | None = None,
                        perms: Sequence[torch.Tensor] | None = None):
        if draws is not None and len(draws) != rollout_steps:
            raise ValueError(f"draws holds {len(draws)} steps, want {rollout_steps}")
        if obs.shape != (num_envs, obs_dim):
            raise ValueError(f"obs has shape {tuple(obs.shape)}, want ({num_envs}, {obs_dim})")
        steps = []
        for t in range(rollout_steps):
            d = draws[t] if draws is not None else StepDraws()
            action, pre_tanh, logp, value = act(state, obs, d.n_act, generator)
            env_states, out, next_obs = rocket_env.batched_step_autoreset(
                env_states, action, env_params, generator=generator, n_imu=d.n_imu,
                reset_draws=d.reset, u_drop=d.u_drop)
            ended = out.terminated | out.truncated
            steps.append({"obs": obs, "pre_tanh": pre_tanh, "log_prob": logp, "value": value,
                          "reward": out.reward, "done": out.terminated.to(torch.float32),
                          "ended": ended, "success": ended & out.mission_success})
            obs = next_obs
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        with torch.no_grad():
            last_value = state.value(obs)
        state, metrics = learn(state, traj, last_value, cfg, perms, generator, axis_name)
        metrics["reward_mean"] = traj["reward"].mean()
        metrics["success_rate"] = traj["success"].sum() / torch.clamp(traj["ended"].sum(),
                                                                      min=1).to(torch.float32)
        pmean_(metrics.values(), axis_name)
        return state, env_states, obs, generator, metrics

    return train_iteration
