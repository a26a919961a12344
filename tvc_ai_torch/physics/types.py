"""State and parameter containers for the rigid-body core.

Counterpart of ``tvc_ai_tpu/physics/types.py``. States are dataclasses of
batched tensors (leading env axis N); ``RocketParams`` is a frozen dataclass
of Python scalars shared by the whole batch (per-episode randomized
quantities live in ``env.types.DomainParams``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class RigidBodyState:
    """Batch of rigid bodies: world-frame pos/vel/omega, body->world quat (xyzw)."""

    pos: torch.Tensor    # (N, 3) m
    quat: torch.Tensor   # (N, 4) xyzw, unit
    vel: torch.Tensor    # (N, 3) m/s
    omega: torch.Tensor  # (N, 3) rad/s, world frame


@dataclasses.dataclass(frozen=True)
class RocketParams:
    """Physical parameters of the rocket and world (defaults as the reference).

    Cylinder 2 kg, 1 m, r 0.05 m; 35 N thrust at (0, 0, -0.5) body frame,
    gimbal ±18°; exponential atmosphere drag; Bullet-style body damping per
    substep; penalty ground contact; 0.02 s control step in 4 substeps.
    ``double_gravity`` keeps the reference's quirk of applying gravity both
    in the engine and manually (effective 2 g).
    """

    mass: float = 2.0
    length: float = 1.0
    radius: float = 0.05
    thrust: float = 35.0
    max_gimbal: float = math.radians(18.0)
    fuel_burn_rate: float = 0.001
    thrust_offset: tuple[float, float, float] = (0.0, 0.0, -0.5)

    gravity: float = 9.81
    double_gravity: bool = True
    gyroscopic: bool = False
    magnus_effect: bool = False
    magnus_coeff: float = 1.0
    ground_effect: bool = False
    ground_effect_strength: float = 0.1
    ground_effect_height: float = 0.5

    drag_coeff: float = 0.47
    rho0: float = 1.225
    atmosphere_scale_height: float = 8400.0
    aero_angular_damping: float = 0.02
    drag_min_speed: float = 0.1

    linear_damping: float = 0.01
    angular_damping: float = 0.02

    dt: float = 0.02
    substeps: int = 4

    contact_stiffness: float = 4000.0
    contact_damping: float = 60.0
    contact_friction: float = 0.8

    def inertia_body(self, mass: torch.Tensor) -> torch.Tensor:
        """(N, 3) diagonal body-frame inertia [Ixx, Iyy, Izz] of a solid cylinder."""
        i_xx = (1.0 / 12.0) * mass * (3.0 * self.radius**2 + self.length**2)
        i_zz = 0.5 * mass * self.radius**2
        return torch.stack([i_xx, i_xx, i_zz], dim=-1)


@dataclasses.dataclass
class ForceTorque:
    """World-frame external force and torque about the CG, (N, 3) each."""

    force: torch.Tensor
    torque: torch.Tensor

    def __add__(self, other: "ForceTorque") -> "ForceTorque":
        return ForceTorque(self.force + other.force, self.torque + other.torque)
