"""CBF-style analytic safety projection applied at act time, and the
optional learned correction head.

Counterpart of ``tvc_ai_tpu/models/safety.py``: where the observation or the
proposed action violates a constraint (tilt, angular rate, control effort),
``apply_safety`` replaces the action by a proportional-derivative stabilizing
gimbal command, rescaled onto the effort ball. ``SafetyCorrectionNet`` is the
trainable correction MLP and ``correction_loss`` its training signal: the
distance to the analytic safe action where a constraint is violated, plus
0.1 × the distance to the proposal elsewhere.

The net's output clip is ``minimum(maximum(x, -1), 1)``, as ``jnp.clip``
computes it: at exactly ±1 both sides then pass half the gradient
(``torch.clamp`` would pass all of it).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tvc_ai_torch.env.types import ACTION_DIM, OBS_DIM
from tvc_ai_torch.models.layers import lecun_dense
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


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


class SafetyCorrectionNet(nn.Module):
    """[obs ‖ action] → Dense 128 → ReLU → Dense 64 → ReLU → Dense
    ``action_dim`` → clip to [-1, 1]. Layers ``Dense_0``..``Dense_2``, as
    the flax module names them; flax's default init, seeded on the CPU."""

    def __init__(
        self,
        action_dim: int = ACTION_DIM,
        obs_dim: int = OBS_DIM,
        device: str | torch.device = DEFAULT_DEVICE,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = lecun_dense(obs_dim + action_dim, 128, gen)
        self.Dense_1 = lecun_dense(128, 64, gen)
        self.Dense_2 = lecun_dense(64, action_dim, gen)
        self.to(dev)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.minimum(torch.maximum(self.Dense_2(x), -one), one)


def correction_loss(
    net: SafetyCorrectionNet,
    obs: torch.Tensor,
    action: torch.Tensor,
    c: SafetyConstraints,
) -> torch.Tensor:
    """mean over rows of mask·‖corrected − safe‖² + 0.1·(1 − mask)·‖corrected
    − action‖², the mask being the row's violation."""
    corrected = net(obs, action)
    target = analytic_safe_action(obs, action, c)
    mask = violations(obs, action, c).to(torch.float32)[..., None]
    to_target = torch.sum(mask * (corrected - target) ** 2, dim=-1)
    stay_close = torch.sum((1 - mask) * (corrected - action) ** 2, dim=-1)
    return torch.mean(to_target + 0.1 * stay_close)
