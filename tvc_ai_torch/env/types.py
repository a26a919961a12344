"""Environment state and parameter containers.

Counterpart of ``tvc_ai_tpu/env/types.py``. Configurations are frozen
dataclasses of Python scalars with the reference's defaults; states are
dataclasses of tensors with a leading env axis N.

Deliberate deviation: ``EnvState`` has no ``key``. PyTorch cannot reproduce
JAX's threefry streams, so every function that draws random numbers takes its
draws as optional tensors (or a ``torch.Generator``) instead of carrying a
per-env key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tvc_ai_torch.physics.types import RigidBodyState, RocketParams

# mission phases, in the reference's order (the observation holds phase / 7)
PHASE_BOOST = 0
PHASE_COAST = 1
PHASE_LANDING = 2
PHASE_TOUCHDOWN = 3
PHASE_HOVER = 4
PHASE_COMPLETE = 5
PHASE_FAILED = 6
NUM_PHASES = 7
PHASE_NAMES = ("boost", "coast", "landing", "touchdown", "hover", "complete", "failed")

OBS_DIM = 10        # [quat(4), ω(3), fuel, phase, progress]
OBS_DIM_LEGACY = 8  # [quat(4), ω(3), fuel] (the legacy gym env's observation)
ACTION_DIM = 2      # gimbal [pitch, yaw] in [-1, 1]
TRIM_OBS_DIM = 4    # optional [ema_qx, ema_qy, ema_act_pitch, ema_act_yaw]
DRIFT_OBS_DIM = 4   # optional scaled [vx, vy, x, y]
ACTION_OBS_DIM = 2  # optional previously commanded action


@dataclasses.dataclass
class DomainParams:
    """Per-episode randomized physics, one draw per env per reset; (N,) / (N, 3)."""

    mass: torch.Tensor
    thrust_scale: torch.Tensor
    cg_offset: torch.Tensor        # body frame, m
    wind: torch.Tensor             # world frame, N
    sensor_noise_std: torch.Tensor
    progress_rate: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomizationConfig:
    """Randomization ranges and the robust-training options: the easy/hard
    mixture (``dr_mixture_enabled``, gate ``dr_prob``), feasible-only draws
    (``feasible_only``, ``feasible_tries`` candidates), hold-last sensor
    dropout and a one-step actuator delay."""

    enabled: bool = False
    sensor_noise_enabled: bool = False
    mass_variation: float = 0.3
    thrust_variation: float = 0.2
    cg_offset_max: float = 0.1
    wind_max: float = 3.0
    sensor_noise_std: float = 0.02
    dr_prob: float = 1.0
    dr_mixture_enabled: bool = False
    sensor_noise_uniform: bool = False
    sensor_dropout_enabled: bool = False
    sensor_dropout_prob: float = 0.0
    progress_rate_randomized: bool = False
    progress_rate_min: float = 1.0
    progress_rate_max: float = 1.0
    init_tilt_max: float = 0.0
    init_omega_max: float = 0.0
    init_pos_jitter: float = 0.0
    actuator_delay: bool = False
    feasible_only: bool = False
    feasible_tries: int = 8
    feasible_tilt_limit: float = 0.087


@dataclasses.dataclass(frozen=True)
class SuccessConfig:
    """Landing criteria held for ``success_duration`` consecutive steps."""

    max_tilt_angle: float = 0.087
    max_angular_velocity: float = 0.1
    max_horizontal_velocity: float = 0.5
    max_vertical_velocity: float = 2.0
    min_altitude: float = 0.2
    max_altitude: float = 2.0
    success_duration: int = 100


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Multi-objective reward weights, with the optional survival-normalized
    success payout and equilibrium-relative tilt shaping."""

    mission_completion_weight: float = 100.0
    safety_compliance_weight: float = 50.0
    fuel_efficiency_weight: float = 20.0
    stability_bonus_weight: float = 10.0
    control_smoothness_weight: float = 5.0
    altitude_maintenance_weight: float = 5.0
    crash_penalty: float = -1000.0
    excessive_tilt_threshold: float = 0.52
    excessive_tilt_scale: float = -500.0
    saturation_threshold: float = 0.9
    saturation_scale: float = -50.0
    gradient_penalty: float = 0.1
    diversity_bonus: float = 0.05
    clip_min: float = -1000.0
    clip_max: float = 200.0
    target_altitude: float = 3.0
    variance_window: int = 10
    survival_normalized_success: bool = False
    survival_success_scale: float = 1.0
    equilibrium_relative_shaping: bool = False


@dataclasses.dataclass(frozen=True)
class TerminationConfig:
    terminate_on_success: bool = True
    crash_altitude: float = 0.1
    max_tilt: float = 0.52
    max_altitude: float = 20.0
    max_horizontal_distance: float = 50.0


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Full environment configuration, shared by the batch."""

    rocket: RocketParams = dataclasses.field(default_factory=RocketParams)
    randomization: RandomizationConfig = dataclasses.field(
        default_factory=RandomizationConfig
    )
    success: SuccessConfig = dataclasses.field(default_factory=SuccessConfig)
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    termination: TerminationConfig = dataclasses.field(default_factory=TerminationConfig)
    max_episode_steps: int = 1000
    init_pos: tuple[float, float, float] = (0.0, 0.0, 1.0)
    trim_obs_enabled: bool = False
    trim_obs_decay: float = 0.99
    trim_obs_tilt_scale: float = 10.0
    trim_obs_integral: bool = False
    trim_obs_clip: float = 0.5
    drift_obs_enabled: bool = False
    drift_obs_vel_scale: float = 2.0
    drift_obs_pos_scale: float = 0.5
    action_obs_enabled: bool = False


# the float fields the reference keeps as Python floats (static pytree fields)
_PYTHON_FLOATS = frozenset({"dt"})


def as_float32(obj):
    """``obj`` (a frozen dataclass tree of scalars, e.g. ``EnvParams``) with
    every float field rounded to float32, as the reference's arrays hold
    them, except ``RocketParams.dt``, which the reference keeps as a Python
    float."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = as_float32(v)
        elif isinstance(v, float) and f.name not in _PYTHON_FLOATS:
            changes[f.name] = float(np.float32(v))
        elif isinstance(v, tuple):
            changes[f.name] = tuple(float(np.float32(x)) for x in v)
    return dataclasses.replace(obj, **changes)


def obs_dim(params: EnvParams) -> int:
    """Observation width: 10, +4 trim, +4 drift, +2 previous action."""
    return (
        OBS_DIM
        + (TRIM_OBS_DIM if params.trim_obs_enabled else 0)
        + (DRIFT_OBS_DIM if params.drift_obs_enabled else 0)
        + (ACTION_OBS_DIM if params.action_obs_enabled else 0)
    )


@dataclasses.dataclass
class EnvState:
    """Per-env state, leading axis N (no PRNG key: see the module note)."""

    body: RigidBodyState
    fuel: torch.Tensor               # (N,) remaining fuel fraction
    step_count: torch.Tensor         # (N,) int32
    phase: torch.Tensor              # (N,) int32 PHASE_*
    mission_success: torch.Tensor    # (N,) bool
    success_count: torch.Tensor      # (N,) int32 consecutive criteria-met steps
    prev_action: torch.Tensor        # (N, 2)
    has_prev_action: torch.Tensor    # (N,) bool
    reward_window: torch.Tensor      # (N, variance_window)
    reward_window_len: torch.Tensor  # (N,) int32
    trim: torch.Tensor               # (N, 4), zeros unless trim_obs_enabled
    dr: DomainParams
    # (N, 7) last presented [quat, ω] reading, held on sensor-dropout steps;
    # None unless sensor dropout is enabled (its only consumer)
    prev_imu: torch.Tensor | None = None


@dataclasses.dataclass
class StepOutput:
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    altitude: torch.Tensor
    tilt: torch.Tensor
    angular_velocity_mag: torch.Tensor
    fuel: torch.Tensor
    phase: torch.Tensor
    mission_success: torch.Tensor
    crashed: torch.Tensor
    reward_components: dict[str, torch.Tensor]
