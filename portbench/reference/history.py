"""The reference's rollout with an observation-history window: the policy
acts on the window of the last H observations, newest last, flattened to
(N, H·obs_dim), and the window moves with every env step.

A frozen reading of how the port's trainer keeps its window: it starts as H
copies of the first observation; after a step the true next observation
(before the autoreset) is shifted in, and where the episode ended the whole
window is refilled with the fresh episode's first observation.
"""

from __future__ import annotations

import torch

from portbench.reference import env


def start(obs: torch.Tensor, history: int) -> torch.Tensor:
    """The first window: ``history`` copies of each env's first observation."""
    return obs.repeat(1, history)


def advance(window: torch.Tensor, true_next: torch.Tensor, next_obs: torch.Tensor,
            done: torch.Tensor) -> torch.Tensor:
    """The window after one step: ``true_next`` shifted in, or, where
    ``done``, the fresh episode's first observation ``next_obs`` throughout."""
    width = true_next.shape[1]
    shifted = torch.cat([window[:, width:], true_next], dim=1)
    return torch.where(done[:, None], start(next_obs, window.shape[1] // width), shifted)


def chunk(p, action, state: dict, window: torch.Tensor, steps):
    """As ``reference.chunk``, with the window in place of the observation:
    the action ``action(p, window, d)`` of the step's draws ``d``, the env step
    with its autoreset, the window advanced. Returns (state, window, rewards,
    terminated, truncated), the last three (steps, n)."""
    rewards, terminated, truncated = [], [], []
    for d in steps:
        state, out, next_obs = env.step_autoreset(
            p, state, action(p, window, d), _cast(d.get("n_imu"), p.dtype), d.get("u_drop"),
            {k: _cast(v, p.dtype) for k, v in d["reset"].items()})
        window = advance(window, out["obs"], next_obs, out["terminated"] | out["truncated"])
        rewards.append(out["reward"])
        terminated.append(out["terminated"])
        truncated.append(out["truncated"])
    return state, window, torch.stack(rewards), torch.stack(terminated), torch.stack(truncated)


def _cast(x, dtype):
    return None if x is None else x.to(dtype)
