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


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix (body->world)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


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


def tilt_from_up(q: torch.Tensor) -> torch.Tensor:
    """Physical tilt: the angle between the body +Z axis and world +Z
    (arccos of the rotation matrix's R[2,2])."""
    x, y = q[..., 0], q[..., 1]
    up_z = 1.0 - 2.0 * (x * x + y * y)
    return torch.arccos(torch.clamp(up_z, -1.0, 1.0))


def random_tilt_quaternion(
    max_tilt: float | torch.Tensor,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """A quaternion tilted from vertical by up to ``max_tilt`` radians about a
    horizontal axis. ``u`` (..., 2) holds the two uniforms in [0, 1): the
    angle is ``u0 · max_tilt``, the axis' azimuth ``u1 · 2π``; one pair is
    drawn from ``generator`` when ``u`` is not given."""
    if u is None:
        device = generator.device if generator is not None else None
        u = torch.rand(2, generator=generator, device=device)
    angle = u[..., 0] * max_tilt
    azimuth = u[..., 1] * (2.0 * math.pi)
    axis = torch.stack([torch.cos(azimuth), torch.sin(azimuth), torch.zeros_like(azimuth)],
                       dim=-1)
    return from_axis_angle(axis, angle)
