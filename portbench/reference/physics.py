"""Plain rigid-body physics: quaternion algebra and the semi-implicit Euler
control step with penalty contact, over (N, 3) / (N, 4) tensors.

A frozen copy of the port's plain integrator (the version its CUDA step
kernel is held against), parity physics only. Every function computes in
the dtype of the tensors it is given.
"""

from __future__ import annotations

import math

import torch


# ----------------------------------------------------------------- quaternions
def q_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def q_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def q_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v body->world by unit q (xyzw)."""
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def q_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return q_rotate(torch.cat([-q[..., :3], q[..., 3:]], dim=-1), v)


def q_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def q_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """q' = exp(omega dt) (x) q, renormalized."""
    w = omega_world * dt
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    k = 0.5 * torch.sinc(theta / (2.0 * math.pi))
    return q_normalize(q_multiply(torch.cat([w * k, torch.cos(0.5 * theta)], dim=-1), q))


def tilt_angle(q: torch.Tensor) -> torch.Tensor:
    """sqrt(pitch^2 + yaw^2) of the ZYX Euler angles (the env's tilt)."""
    x, y, z, w = q.unbind(-1)
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.sqrt(pitch ** 2 + yaw ** 2)


# ----------------------------------------------------------------- integrator
def _z_only(fz: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(fz)
    return torch.stack([zero, zero, fz], dim=-1)


def _forces(body: dict, gimbal, thrust_active, rp, mass, thrust_scale, cg_offset, wind):
    """External force and torque, once per control step from the pre-step state."""
    g = rp.gravity if rp.double_gravity else 0.0
    force = _z_only(-g * mass)
    torque = torch.zeros_like(force)
    # gimbaled thrust at the thrust offset, lever from the CG
    thrust = rp.thrust * thrust_scale
    pitch, yaw = gimbal[..., 0], gimbal[..., 1]
    f_body = torch.stack([thrust * torch.sin(yaw), thrust * torch.sin(pitch),
                          thrust * torch.cos(pitch) * torch.cos(yaw)], dim=-1)
    f_world = q_rotate(body["quat"], f_body)
    ox, oy, oz = rp.thrust_offset
    lever = torch.stack([ox - cg_offset[..., 0], oy - cg_offset[..., 1],
                         oz - cg_offset[..., 2]], dim=-1)
    lever_world = q_rotate(body["quat"], lever)
    f_thrust = f_world * thrust_active[..., None].to(f_world.dtype)
    force = force + f_thrust
    torque = torque + torch.linalg.cross(lever_world, f_thrust)
    # exponential-atmosphere drag and aerodynamic angular damping
    pos, vel, omega = body["pos"], body["vel"], body["omega"]
    rho = rp.rho0 * torch.exp(-pos[..., 2] / rp.atmosphere_scale_height)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    drag_mag = 0.5 * rho * speed ** 2 * rp.drag_coeff * (math.pi * rp.radius ** 2)
    inv_speed = torch.where(speed > 1e-9, 1.0 / torch.clamp(speed, min=1e-9),
                            torch.zeros_like(speed))
    drag = -vel * (drag_mag * inv_speed)[..., None]
    force = force + torch.where((speed > rp.drag_min_speed)[..., None], drag,
                                torch.zeros_like(drag))
    torque = torque + (-(rp.aero_angular_damping * rho)[..., None] * omega)
    return force + wind, torque + torch.zeros_like(wind)


def _contact(body: dict, rp):
    """Penalty contact at both cylinder ends, regularized Coulomb friction."""
    total_f = total_t = None
    for sign in (-1.0, 1.0):
        r_body = _z_only(torch.full_like(body["pos"][..., 2], sign * 0.5 * rp.length))
        r_world = q_rotate(body["quat"], r_body)
        p_world = body["pos"] + r_world
        v_point = body["vel"] + torch.linalg.cross(body["omega"], r_world)
        depth = torch.clamp(-p_world[..., 2], min=0.0)
        fn = rp.contact_stiffness * depth - rp.contact_damping * v_point[..., 2]
        fn = torch.where(depth > 0.0, torch.clamp(fn, min=0.0), torch.zeros_like(fn))
        v_t = v_point[..., :2]
        v_t_mag = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
        ft = -rp.contact_friction * fn[..., None] * v_t / (v_t_mag + 1e-3)
        f = torch.cat([ft, fn[..., None]], dim=-1)
        t = torch.linalg.cross(r_world, f)
        total_f = f if total_f is None else total_f + f
        total_t = t if total_t is None else total_t + t
    return total_f, total_t


def integrate(body: dict, gimbal, thrust_active, rp, mass, thrust_scale, cg_offset,
              wind) -> dict:
    """One control step (``rp.dt``) in ``rp.substeps`` substeps; returns the
    new pos, quat, vel, omega."""
    w_force, w_torque = _forces(body, gimbal, thrust_active, rp, mass, thrust_scale,
                                cg_offset, wind)
    dt = rp.dt / rp.substeps
    i_xx = (1.0 / 12.0) * mass * (3.0 * rp.radius ** 2 + rp.length ** 2)
    inertia = torch.stack([i_xx, i_xx, 0.5 * mass * rp.radius ** 2], dim=-1)
    for _ in range(rp.substeps):
        c_force, c_torque = _contact(body, rp)
        force = w_force + c_force
        torque = w_torque + c_torque
        force = force - _z_only(rp.gravity * mass)
        vel = body["vel"] + force * (1.0 / mass)[..., None] * dt
        torque_body = q_rotate_inverse(body["quat"], torque)
        omega = body["omega"] + q_rotate(body["quat"], torque_body / inertia) * dt
        vel = vel * (1.0 - rp.linear_damping) ** dt
        omega = omega * (1.0 - rp.angular_damping) ** dt
        body = dict(pos=body["pos"] + vel * dt, quat=q_integrate(body["quat"], omega, dt),
                    vel=vel, omega=omega)
    return body
