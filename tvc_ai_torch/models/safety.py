"""CBF-style analytic safety projection applied at act time.

Counterpart of ``tvc_ai_tpu/models/safety.py`` (``SafetyConstraints`` to
``apply_safety``): where the observation or the proposed action violates a
constraint (tilt, angular rate, control effort), the action is replaced by a
proportional-derivative stabilizing gimbal command, rescaled onto the effort
ball. The learned correction head waits for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SafetyConstraints:
    max_tilt: float = 0.52
    max_angular_velocity: float = 5.0
    min_altitude: float = 0.1
    max_altitude: float = 20.0
    max_control_effort: float = 1.0
    fuel_reserve: float = 0.1


def obs_safety_features(obs: torch.Tensor):
    """tilt, |ω|, ω, pitch, yaw from the observation's quaternion and ω."""
    omega = obs[..., 4:7]
    x, y, z, w = obs[..., 0], obs[..., 1], obs[..., 2], obs[..., 3]
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    tilt = torch.sqrt(pitch**2 + yaw**2)
    return tilt, torch.linalg.vector_norm(omega, dim=-1), omega, pitch, yaw


def violations(obs: torch.Tensor, action: torch.Tensor, c: SafetyConstraints) -> torch.Tensor:
    """Per-row violation mask: tilt | angular rate | effort."""
    tilt, omega_mag, *_ = obs_safety_features(obs)
    effort = torch.linalg.vector_norm(action, dim=-1)
    return (
        (tilt > c.max_tilt)
        | (omega_mag > c.max_angular_velocity)
        | (effort > c.max_control_effort)
    )


def analytic_safe_action(
    obs: torch.Tensor, action: torch.Tensor, c: SafetyConstraints
) -> torch.Tensor:
    """PD stabilizing gimbal on an attitude violation (gains 2.0 / 0.5, clipped);
    rescale onto the unit effort ball on an effort violation."""
    tilt, omega_mag, omega, pitch, yaw = obs_safety_features(obs)
    stabilize = torch.clamp(
        torch.stack(
            [-2.0 * pitch - 0.5 * omega[..., 1], -2.0 * yaw - 0.5 * omega[..., 2]],
            dim=-1,
        ),
        -1.0, 1.0,
    )
    attitude_bad = (tilt > c.max_tilt) | (omega_mag > c.max_angular_velocity)
    out = torch.where(attitude_bad[..., None], stabilize, action)
    effort = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    out = torch.where(
        effort > c.max_control_effort,
        out * (c.max_control_effort / torch.clamp(effort, min=1e-8)),
        out,
    )
    return torch.clamp(out, -1.0, 1.0)


def apply_safety(
    obs: torch.Tensor, action: torch.Tensor, c: SafetyConstraints
) -> tuple[torch.Tensor, torch.Tensor]:
    """(safe_action, violation_mask): the correction only where violated."""
    mask = violations(obs, action, c)
    safe = analytic_safe_action(obs, action, c)
    return torch.where(mask[..., None], safe, action), mask
