"""Soft Actor-Critic, the act half.

Counterpart of the actor side of ``tvc_ai_tpu/agents/sac.py``: the
``SACConfig`` fields that shape the actor, ``make_actor`` and
``select_action``. The replay buffer, critics and the update come with the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from tvc_ai_torch.models import distributions as dist
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class SACConfig:
    hidden_dims: tuple[int, ...] = (256, 256)
    # "float32" only: the bfloat16 hidden stack is not ported
    compute_dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"SACConfig.compute_dtype={self.compute_dtype!r} is not ported"
            )


def make_actor(
    obs_dim: int,
    action_dim: int,
    cfg: SACConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> GaussianActor:
    return GaussianActor(obs_dim, action_dim, cfg.hidden_dims, device=device, seed=seed)


@torch.no_grad()
def select_action(
    actor: GaussianActor,
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
