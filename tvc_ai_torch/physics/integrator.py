"""Batched 6-DOF semi-implicit-Euler rigid-body integrator (plain PyTorch).

Counterpart of ``tvc_ai_tpu/physics/integrator.py`` over (N, 3)/(N, 4)
tensors: forces are accumulated once per control step from the pre-step
state, then ``params.substeps`` substeps each add penalty contact, engine
gravity and body damping and advance the quaternion by its exponential map.

This is the plain version of the K1 kernel (``ops.step_kernel``): the kernel's
wrapper runs it for CPU tensors, and ``env.rocket_env`` runs it on any device
when one of the opt-in terms (Magnus, ground effect, gyroscopic), which the
kernel does not implement, is on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.physics.types import ForceTorque, RigidBodyState, RocketParams


class ThrustControl(NamedTuple):
    """gimbal (N, 2) radians [pitch, yaw]; thrust_active (N,) bool fuel gate."""

    gimbal: torch.Tensor
    thrust_active: torch.Tensor


def thrust_body_vector(gimbal: torch.Tensor, thrust: torch.Tensor) -> torch.Tensor:
    """[T·sin(yaw), T·sin(pitch), T·cos(pitch)·cos(yaw)] in the body frame."""
    pitch, yaw = gimbal[..., 0], gimbal[..., 1]
    return torch.stack(
        [
            thrust * torch.sin(yaw),
            thrust * torch.sin(pitch),
            thrust * torch.cos(pitch) * torch.cos(yaw),
        ],
        dim=-1,
    )


def _z_only(fz: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(fz)
    return torch.stack([zero, zero, fz], dim=-1)


def gravity_wrench(params: RocketParams, mass: torch.Tensor) -> ForceTorque:
    """The manually applied half of double gravity (zero when it is off)."""
    g = params.gravity if params.double_gravity else 0.0
    force = _z_only(-g * mass)
    return ForceTorque(force=force, torque=torch.zeros_like(force))


def thrust_wrench(
    state: RigidBodyState,
    control: ThrustControl,
    params: RocketParams,
    thrust_scale: torch.Tensor,
    cg_offset: torch.Tensor,
) -> ForceTorque:
    """Gimbaled thrust at ``thrust_offset`` (body frame) minus the CG offset."""
    thrust = params.thrust * thrust_scale
    if params.ground_effect:
        alt = torch.clamp(state.pos[..., 2], min=0.0)
        thrust = thrust * (
            1.0
            + params.ground_effect_strength
            * torch.exp(-alt / params.ground_effect_height)
        )
    f_world = quat.rotate(state.quat, thrust_body_vector(control.gimbal, thrust))
    ox, oy, oz = params.thrust_offset
    lever_body = torch.stack(
        [ox - cg_offset[..., 0], oy - cg_offset[..., 1], oz - cg_offset[..., 2]],
        dim=-1,
    )
    lever_world = quat.rotate(state.quat, lever_body)
    force = f_world * control.thrust_active[..., None].to(f_world.dtype)
    return ForceTorque(force=force, torque=torch.linalg.cross(lever_world, force))


def aero_wrench(state: RigidBodyState, params: RocketParams) -> ForceTorque:
    """Exponential-atmosphere quadratic drag (gated on drag_min_speed) and
    aerodynamic angular damping −c·ρ·ω; opt-in Magnus lift."""
    rho = params.rho0 * torch.exp(-state.pos[..., 2] / params.atmosphere_scale_height)
    speed = torch.linalg.vector_norm(state.vel, dim=-1)
    area = math.pi * params.radius**2
    drag_mag = 0.5 * rho * speed**2 * params.drag_coeff * area
    inv_speed = torch.where(
        speed > 1e-9, 1.0 / torch.clamp(speed, min=1e-9), torch.zeros_like(speed)
    )
    drag = -state.vel * (drag_mag * inv_speed)[..., None]
    force = torch.where(
        (speed > params.drag_min_speed)[..., None], drag, torch.zeros_like(drag)
    )
    torque = -(params.aero_angular_damping * rho)[..., None] * state.omega
    if params.magnus_effect:
        area_vol = math.pi * params.radius**2 * params.length
        force = force + (params.magnus_coeff * rho * area_vol)[..., None] * (
            torch.linalg.cross(state.omega, state.vel)
        )
    return ForceTorque(force=force, torque=torque)


def contact_wrench(state: RigidBodyState, params: RocketParams) -> ForceTorque:
    """Penalty contact at both cylinder ends with regularized Coulomb friction."""
    total = None
    for sign in (-1.0, 1.0):
        r_body = _z_only(torch.full_like(state.pos[..., 2], sign * 0.5 * params.length))
        r_world = quat.rotate(state.quat, r_body)
        p_world = state.pos + r_world
        v_point = state.vel + torch.linalg.cross(state.omega, r_world)
        depth = torch.clamp(-p_world[..., 2], min=0.0)
        fn = params.contact_stiffness * depth - params.contact_damping * v_point[..., 2]
        fn = torch.where(depth > 0.0, torch.clamp(fn, min=0.0), torch.zeros_like(fn))
        v_t = v_point[..., :2]
        v_t_mag = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
        ft = -params.contact_friction * fn[..., None] * v_t / (v_t_mag + 1e-3)
        force = torch.cat([ft, fn[..., None]], dim=-1)
        wrench = ForceTorque(force=force, torque=torch.linalg.cross(r_world, force))
        total = wrench if total is None else total + wrench
    return total


def accumulate_forces(
    state: RigidBodyState,
    control: ThrustControl,
    params: RocketParams,
    mass: torch.Tensor,
    thrust_scale: torch.Tensor,
    cg_offset: torch.Tensor,
    wind: torch.Tensor,
) -> ForceTorque:
    """External wrench, computed once per control step from the pre-step state."""
    total = gravity_wrench(params, mass)
    total = total + thrust_wrench(state, control, params, thrust_scale, cg_offset)
    total = total + aero_wrench(state, params)
    return total + ForceTorque(force=wind, torque=torch.zeros_like(wind))


def substep(
    state: RigidBodyState,
    wrench: ForceTorque,
    params: RocketParams,
    mass: torch.Tensor,
    dt: float,
) -> RigidBodyState:
    """One semi-implicit Euler substep."""
    inertia = params.inertia_body(mass)
    contact = contact_wrench(state, params)
    force = wrench.force + contact.force
    torque = wrench.torque + contact.torque
    # engine gravity, always on
    force = force - _z_only(params.gravity * mass)

    vel = state.vel + force * (1.0 / mass)[..., None] * dt
    # ω' = ω + R diag(1/I) Rᵀ τ dt
    torque_body = quat.rotate_inverse(state.quat, torque)
    if params.gyroscopic:
        omega_body = quat.rotate_inverse(state.quat, state.omega)
        torque_body = torque_body - torch.linalg.cross(omega_body, inertia * omega_body)
    omega = state.omega + quat.rotate(state.quat, torque_body / inertia) * dt

    vel = vel * (1.0 - params.linear_damping) ** dt
    omega = omega * (1.0 - params.angular_damping) ** dt
    pos = state.pos + vel * dt
    return RigidBodyState(
        pos=pos, quat=quat.integrate(state.quat, omega, dt), vel=vel, omega=omega
    )


def step(
    state: RigidBodyState,
    control: ThrustControl,
    params: RocketParams,
    mass: torch.Tensor | None = None,
    thrust_scale: torch.Tensor | None = None,
    cg_offset: torch.Tensor | None = None,
    wind: torch.Tensor | None = None,
) -> RigidBodyState:
    """Advance one control step (``params.dt``) in ``params.substeps`` substeps.

    The per-env arrays carry domain randomization and default to nominal.
    """
    n = state.pos.shape[:-1]
    if mass is None:
        mass = torch.full(n, params.mass, dtype=state.pos.dtype, device=state.pos.device)
    if thrust_scale is None:
        thrust_scale = torch.ones_like(mass)
    if cg_offset is None:
        cg_offset = torch.zeros_like(state.pos)
    if wind is None:
        wind = torch.zeros_like(state.pos)
    wrench = accumulate_forces(state, control, params, mass, thrust_scale, cg_offset, wind)
    dt_sub = params.dt / params.substeps
    for _ in range(params.substeps):
        state = substep(state, wrench, params, mass, dt_sub)
    return state
