"""The legacy physical-configuration object the evaluation suites build on.

Counterpart of ``tvc_ai_tpu/env/wrappers.py::RocketConfig`` and its
``to_env_params``. The Gymnasium classes of that module wait for their own
slice (ROADMAP module 12).
"""

from __future__ import annotations

import dataclasses
import math

from tvc_ai_torch.env.types import EnvParams, RandomizationConfig, as_float32
from tvc_ai_torch.physics.types import RocketParams


@dataclasses.dataclass
class RocketConfig:
    """Legacy physical configuration (mutable, like the original); the
    reference's defaults (mass 1.5 kg, CG offset 0.05 m)."""

    mass: float = 1.5                 # kg
    radius: float = 0.05              # m
    length: float = 1.0               # m
    thrust_mean: float = 35.0         # N
    burn_time: float = 20.0           # s (→ 0.001 fuel/step at 50 Hz)
    max_gimbal_angle: float = math.radians(18.0)
    mass_variation: float = 0.3       # ± fraction
    thrust_variation: float = 0.2     # σ fraction
    cg_offset_max: float = 0.05       # m
    wind_max: float = 3.0             # N
    sensor_noise_std: float = 0.02

    def to_env_params(
        self,
        *,
        domain_randomization: bool,
        sensor_noise: bool,
        max_episode_steps: int,
    ) -> EnvParams:
        dt = 0.02
        rocket = RocketParams(
            mass=self.mass,
            radius=self.radius,
            length=self.length,
            thrust=self.thrust_mean,
            max_gimbal=self.max_gimbal_angle,
            fuel_burn_rate=dt / self.burn_time,
        )
        rnd = RandomizationConfig(
            enabled=bool(domain_randomization),
            sensor_noise_enabled=bool(sensor_noise),
            mass_variation=self.mass_variation,
            thrust_variation=self.thrust_variation,
            cg_offset_max=self.cg_offset_max,
            wind_max=self.wind_max,
            sensor_noise_std=self.sensor_noise_std,
        )
        return as_float32(EnvParams(
            rocket=rocket, randomization=rnd, max_episode_steps=max_episode_steps
        ))
