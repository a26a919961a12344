"""Policy-in-the-loop rollout: the act-and-simulate half of the SAC iteration.

Counterpart of the per-step body of
``tvc_ai_tpu/training/loop.py::make_train_iteration`` (act with
``sac.select_action``, project with ``apply_safety``, step all envs with
``batched_step_autoreset``) for ``history_len=1``. The replay write and the
SAC update come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tvc_ai_torch.agents import sac
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.models.safety import SafetyConstraints, apply_safety


@dataclasses.dataclass
class StepDraws:
    """The random numbers one rollout step consumes (see ``rocket_env``)."""

    n_act: torch.Tensor | None = None   # (N, 2) exploration noise
    n_imu: torch.Tensor | None = None   # (N, 7) IMU noise of the new obs
    reset: ResetDraws | None = None     # the autoreset's draws


@dataclasses.dataclass
class Rollout:
    states: EnvState
    obs: torch.Tensor          # (N, obs_dim) the policy observation after the last step
    reward: torch.Tensor       # (steps, N)
    terminated: torch.Tensor   # (steps, N)
    truncated: torch.Tensor    # (steps, N)


def collect(
    actor: GaussianActor,
    env_states: EnvState,
    obs: torch.Tensor,
    env_params: EnvParams,
    steps: int,
    safety: SafetyConstraints | None = SafetyConstraints(),
    generator: torch.Generator | None = None,
    draws: Sequence[StepDraws] | None = None,
) -> Rollout:
    """Run ``steps`` act-and-simulate steps for the N envs in ``env_states``.

    Each step samples a tanh-Gaussian action, applies the safety projection
    (skipped when ``safety`` is None), then ``batched_step_autoreset`` (the K1
    kernel on CUDA). ``draws`` gives each step's random numbers; otherwise
    they come from ``generator`` on the envs' device.
    """
    if draws is not None and len(draws) != steps:
        raise ValueError(f"draws holds {len(draws)} steps, want {steps}")
    rewards, terminated, truncated = [], [], []
    for t in range(steps):
        d = draws[t] if draws is not None else StepDraws()
        actions = sac.select_action(actor, obs, d.n_act, generator=generator)
        if safety is not None:
            actions, _ = apply_safety(obs, actions, safety)
        env_states, out, obs = rocket_env.batched_step_autoreset(
            env_states, actions, env_params,
            generator=generator, n_imu=d.n_imu, reset_draws=d.reset,
        )
        rewards.append(out.reward)
        terminated.append(out.terminated)
        truncated.append(out.truncated)
    return Rollout(
        states=env_states,
        obs=obs,
        reward=torch.stack(rewards),
        terminated=torch.stack(terminated),
        truncated=torch.stack(truncated),
    )
