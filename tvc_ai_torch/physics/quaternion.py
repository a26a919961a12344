"""Quaternion algebra, xyzw layout, over batched (..., 4) / (..., 3) tensors.

Counterpart of ``tvc_ai_tpu/physics/quaternion.py``; same conventions
(vector part first, body->world rotation, PyBullet's ZYX Euler order).
"""

from __future__ import annotations

import math

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit quaternion, guarding the zero quaternion."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v body->world by unit q (two-cross-product Rodrigues form)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v world->body."""
    return rotate(conjugate(q), v)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation quaternion from unit axis (..., 3) and angle (...,) in radians."""
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def exp_map(omega_dt: torch.Tensor) -> torch.Tensor:
    """Quaternion exponential of a rotation vector; sin(θ/2)/θ via sinc."""
    theta = torch.linalg.vector_norm(omega_dt, dim=-1, keepdim=True)
    k = 0.5 * torch.sinc(theta / (2.0 * math.pi))
    return torch.cat([omega_dt * k, torch.cos(0.5 * theta)], dim=-1)


def integrate(q: torch.Tensor, omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """q' = exp(ω·dt) ⊗ q, renormalized (world-frame rates multiply on the left)."""
    return normalize(multiply(exp_map(omega_world * dt), q))


def to_euler_zyx(q: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) as PyBullet's getEulerFromQuaternion returns them."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def tilt_angle(q: torch.Tensor) -> torch.Tensor:
    """Reference tilt: sqrt(pitch² + yaw²) of the ZYX Euler angles.

    Mixes pitch with yaw (heading) rather than roll, as the reference does;
    kept for behavioural parity.
    """
    e = to_euler_zyx(q)
    return torch.sqrt(e[..., 1] ** 2 + e[..., 2] ** 2)
