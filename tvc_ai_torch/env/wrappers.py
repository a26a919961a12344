"""Gymnasium environments over the single-env core.

Counterpart of ``tvc_ai_tpu/env/wrappers.py``, both API generations:

- ``EnhancedRocketTVCEnv``: 10-D obs [quat, ω, fuel, phase, progress], the
  constructor flags (``enable_hierarchical`` / ``enable_curiosity`` /
  ``enable_physics_informed``), mission phases; with curiosity on (the
  default) the ICM's forward-model bonus is added to the step reward;
- ``RocketTVCEnv`` + ``RocketConfig``: the legacy 8-D obs [quat, ω, fuel]
  and ``current_mass`` under domain randomization.

Everything but gymnasium's part lives in ``env.single``
(``EnhancedRocketTVC`` / ``RocketTVC``: the constructors, reset, step, the
obs width, the curiosity bonus, the ``step_draws`` hook): the env is an
N = 1 batch on ``device`` (CUDA by default) stepped through
``rocket_env.batched_step``, so on the card the physics is K1, and each step
makes one device-to-host read. This module adds ``gym.Env``, the spaces,
``metadata`` and gymnasium's ``np_random`` seeding on reset.

This is the only module of the port that imports gymnasium.
"""

from __future__ import annotations

import functools
from typing import Optional

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from tvc_ai_torch.env.single import EnhancedRocketTVC, RocketConfig, RocketTVC
from tvc_ai_torch.env.types import ACTION_DIM

__all__ = ["EnhancedRocketTVCEnv", "RocketConfig", "RocketTVCEnv"]


class _GymPart:
    """What gymnasium adds to an ``env.single.EnvShell``: the spaces, the
    metadata and the seeding of ``np_random``."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 60}

    @functools.cached_property
    def action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(ACTION_DIM,), dtype=np.float32)

    @functools.cached_property
    def observation_space(self) -> spaces.Box:
        return spaces.Box(low=self.obs_low, high=self.obs_high, dtype=np.float32)

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        gym.Env.reset(self, seed=seed)
        return super().reset(seed=seed, options=options)


class EnhancedRocketTVCEnv(_GymPart, EnhancedRocketTVC, gym.Env):
    """``env.single.EnhancedRocketTVC`` as a ``gym.Env``."""


class RocketTVCEnv(_GymPart, RocketTVC, gym.Env):
    """``env.single.RocketTVC`` as a ``gym.Env``."""
