"""LQR ground-balance demonstrations for replay seeding (``training.demo_seeding``).

Counterpart of the part of ``tvc_ai_tpu/training/demos.py`` that the
trainer's demonstration seeding runs: the blind ground-balance LQR
(``design_lqr``), its action (``lqr_action``), the demonstration rollout
(``generate_demonstrations``) and the replay write (``seed_replay_buffer``).
The gain-scheduled teacher of the distillation chain (``LQRSchedule`` and
its design, verification and interpolation) is not here.

The plant (the reference's module docstring has the derivation): under the
double-gravity quirk thrust (35 N) is below the effective weight, so the
strict success window is a ground-balance regime, the vehicle standing on
the penalty point contact. The controller is synthesized from the true
dynamics: the Jacobian of the exact 50 Hz step map (the plain
``physics.integrator.step``) about the standing equilibrium, per tilt
plane, then a discrete LQR. The Jacobian is averaged over the four (±slip,
±spin) corners: a small slip keeps the regularized friction's slope mild,
and a small spin keeps the quaternion exponential's ``|ω| = 0`` point (whose
derivative is undefined) out of the linearization.

Where it runs. ``design_lqr`` runs on the host CPU in float32, as the
reference pins it there: it is thousands of tiny residual evaluations and
four 6×6 Jacobians (``torch.func.jacrev``) whose result is a handful of
scalars; the result is cached per ``RocketParams``. The rollout runs on the
caller's device through ``rocket_env.batched_step_autoreset``: K1 on the
card, its plain version on the CPU (the reference steps the plain
``vmap(step_autoreset)`` there). Its draws are explicit (``reset_draws``
and one ``StepDraws`` per step) or come from ``generator``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.physics import integrator
from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.training.loop import StepDraws
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

F32 = torch.float32


class LQRDesign(NamedTuple):
    """Per-plane gains and the equilibrium of the ground-balance LQR.

    Planar state (yaw plane): [x, z, theta, vx, vz, omega_y], theta tipping
    body +z toward +x, control the gimbal yaw in radians. The pitch plane
    mirrors it: [y, z, phi, vy, vz, omega_x], phi tipping body +z toward
    -y, control the gimbal pitch. The fields are float32 numpy values.
    """

    gain: np.ndarray               # (6,) yaw-plane LQR gain
    gain_pitch: np.ndarray         # (6,) pitch-plane LQR gain
    z_eq: np.float32               # equilibrium CG altitude (standing, d = 0)
    trim_slope: np.float32         # d(theta*)/d(dx), yaw plane
    trim_slope_pitch: np.float32   # d(phi*)/d(dy), pitch plane


def _stack(like: torch.Tensor, *xs) -> torch.Tensor:
    """(..., len(xs)) float32 of tensors and numbers, broadcast to ``like``'s
    shape (a 0-dim ``like`` gives a vector)."""
    return torch.stack([torch.broadcast_to(x, like.shape) if isinstance(x, torch.Tensor)
                        else torch.full_like(like, x, dtype=F32) for x in xs], dim=-1)


def _embed(s: torch.Tensor, pitch: bool) -> RigidBodyState:
    """The body of planar states s (..., 6) of the yaw or the pitch plane."""
    half, zero = s[..., 2] * 0.5, 0.0
    if pitch:
        return RigidBodyState(pos=_stack(half, zero, s[..., 0], s[..., 1]),
                              quat=_stack(half, torch.sin(half), zero, zero, torch.cos(half)),
                              vel=_stack(half, zero, s[..., 3], s[..., 4]),
                              omega=_stack(half, s[..., 5], zero, zero))
    return RigidBodyState(pos=_stack(half, s[..., 0], zero, s[..., 1]),
                          quat=_stack(half, zero, torch.sin(half), zero, torch.cos(half)),
                          vel=_stack(half, s[..., 3], zero, s[..., 4]),
                          omega=_stack(half, zero, s[..., 5], zero))


def _plane_inputs(u: torch.Tensor, d, pitch: bool):
    """(gimbal, cg offset) of one plane's controls u (...) and CG offset d."""
    if pitch:
        return _stack(u, u, 0.0), _stack(u, 0.0, d, 0.0)
    return _stack(u, 0.0, u), _stack(u, d, 0.0, 0.0)


def _plane_step(s: torch.Tensor, u: torch.Tensor, d, rp: RocketParams, pitch: bool,
                mass: torch.Tensor | None = None,
                thrust_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The exact 50 Hz control-step map restricted to one tilt plane, over
    states s (..., 6) and controls u (...); ``mass`` and ``thrust_scale``
    (...) default to the nominal plant."""
    body = _embed(s, pitch)
    gimbal, cg = _plane_inputs(u, d, pitch)
    control = integrator.ThrustControl(gimbal=gimbal, thrust_active=torch.ones_like(u))
    nxt = integrator.step(body, control, rp, mass=mass, thrust_scale=thrust_scale, cg_offset=cg)
    if pitch:
        ang = 2.0 * torch.atan2(nxt.quat[..., 0], nxt.quat[..., 3])
        return torch.stack([nxt.pos[..., 1], nxt.pos[..., 2], ang, nxt.vel[..., 1],
                            nxt.vel[..., 2], nxt.omega[..., 0]], dim=-1)
    ang = 2.0 * torch.atan2(nxt.quat[..., 1], nxt.quat[..., 3])
    return torch.stack([nxt.pos[..., 0], nxt.pos[..., 2], ang, nxt.vel[..., 0],
                        nxt.vel[..., 2], nxt.omega[..., 1]], dim=-1)


def _static_residual(q3: torch.Tensor, d, rp: RocketParams, pitch: bool,
                     mass: torch.Tensor | None = None,
                     thrust_scale: torch.Tensor | None = None) -> torch.Tensor:
    """(lateral force, vertical force, plane torque) at rest, over q3 (..., 3)
    = (theta, u, depth): zero at the standing equilibrium."""
    theta, u, depth = q3[..., 0], q3[..., 1], q3[..., 2]
    z = 0.5 * rp.length * torch.cos(theta) - depth
    body = _embed(_stack(theta, 0.0, z, theta, 0.0, 0.0, 0.0), pitch)
    gimbal, cg = _plane_inputs(u, d, pitch)
    control = integrator.ThrustControl(gimbal=gimbal, thrust_active=torch.ones_like(u))
    if mass is None:
        mass = torch.full_like(theta, rp.mass)
    if thrust_scale is None:
        thrust_scale = torch.ones_like(theta)
    wrench = integrator.accumulate_forces(body, control, rp, mass, thrust_scale, cg,
                                          torch.zeros_like(body.pos))
    contact = integrator.contact_wrench(body, rp)
    force = wrench.force + contact.force
    force = force - _stack(mass, 0.0, 0.0, rp.gravity * mass)   # the engine's half of gravity
    torque = wrench.torque + contact.torque
    if pitch:
        return torch.stack([force[..., 1], force[..., 2], torque[..., 0]], dim=-1)
    return torch.stack([force[..., 0], force[..., 2], torque[..., 1]], dim=-1)


@torch.no_grad()
def solve_equilibrium(rp: RocketParams, d: float, pitch: bool = False) -> np.ndarray:
    """The standing equilibrium (theta*, u*, depth*) at CG offset d, float64.

    At zero slip the regularized friction vanishes, so lateral force balance
    needs the thrust vertical in the world (u as a function of theta); the
    normal balance fixes the penetration depth; torque balance fixes theta.
    A forward-only nested bisection on the exact static residual, as the
    reference's (not Newton: the contact and drag norms have no derivative at
    exactly zero velocity).
    """
    g_eff = 2.0 * float(rp.gravity)  # double gravity
    depth = (float(rp.mass) * g_eff - float(rp.thrust)) / float(rp.contact_stiffness)

    def residual(theta: float, u: float) -> np.ndarray:
        q3 = torch.tensor([theta, u, depth], dtype=F32)
        return _static_residual(q3, d, rp, pitch).numpy()

    def bisect(f, lo: float, hi: float, iters: int = 40) -> float:
        flo = f(lo)
        if flo * f(hi) > 0:
            raise AssertionError(f"no sign change in [{lo}, {hi}] at d={d} pitch={pitch}")
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            fmid = f(mid)
            if flo * fmid <= 0:
                hi = mid
            else:
                lo, flo = mid, fmid
        return 0.5 * (lo + hi)

    def u_for(theta: float) -> float:
        # null the lateral thrust component (|u| within the gimbal range)
        return bisect(lambda u: float(residual(theta, u)[0]), -0.3, 0.3)

    theta = bisect(lambda th: float(residual(th, u_for(th))[2]), -0.25, 0.25)
    u = u_for(theta)
    res = residual(theta, u)
    if np.max(np.abs(res)) > 0.05:  # N / N·m: a forward sanity check
        raise AssertionError(f"equilibrium residual {res} too large at d={d} pitch={pitch}")
    return np.array([theta, u, depth], np.float64)


def equilibrium_tilt(params: EnvParams, d: float) -> float:
    """The standing-equilibrium tilt magnitude at CG offset d (radians)."""
    return abs(float(solve_equilibrium(params.rocket, d)[0]))


def _dlqr_batch(a: np.ndarray, b: np.ndarray, q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Discrete-time LQR of a stack of plants a (C, n, n), b (C, n, m) by
    the reference's float64 Riccati fixed-point iteration, each plant
    stopping at its own convergence, a diverging one (``p`` non-finite or
    above 1e12) getting a zero gain. Returns (C, m, n)."""
    c = a.shape[0]
    at, bt = a.transpose(0, 2, 1), b.transpose(0, 2, 1)
    p = np.broadcast_to(q, a.shape).copy()
    active = np.ones(c, bool)
    diverged = np.zeros(c, bool)
    for _ in range(3000):
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        pa, aa, ba = p[idx], a[idx], b[idx]
        btp = bt[idx] @ pa
        k = np.linalg.solve(r + btp @ ba, btp @ aa)
        p_next = q + at[idx] @ pa @ (aa - ba @ k)
        p_next = 0.5 * (p_next + p_next.transpose(0, 2, 1))
        with np.errstate(invalid="ignore"):
            bad = ~np.isfinite(p_next).all((1, 2)) | (np.abs(p_next).max((1, 2)) > 1e12)
            conv = np.abs(p_next - pa).max((1, 2)) < 1e-9 * (1.0 + np.abs(pa).max((1, 2)))
        diverged[idx[bad]] = True
        p[idx[~bad]] = p_next[~bad]
        active[idx[bad | conv]] = False
    btp = bt @ p
    k = np.linalg.solve(r + btp @ b, btp @ a)
    k[diverged] = 0.0
    return k


def _dlqr(a: np.ndarray, b: np.ndarray, q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Discrete-time LQR of one plant by Riccati fixed-point iteration, in
    float64 (``_dlqr_batch`` of a stack of one). A diverging iteration (an
    unstabilizable plant) returns a zero gain instead of overflowing."""
    return _dlqr_batch(a[None], b[None], q, r)[0]


# LQR weights, scaled ~1/limit² against the success window (tilt 0.087,
# |omega| 0.1, horizontal speed 0.5) with a light position cost: position
# feedback gives the integral action, so it must be nonzero but slow. The
# altitude channel (z, vz) carries ~zero weight: with fixed thrust it is
# uncontrollable.
_Q_DIAG = (1.0, 1e-4, 625.0, 16.0, 1e-4, 400.0)
_R = 100.0
# linearize at this slip speed (friction slope ~8/s here against ~1700/s at
# stick) and this spin (off the quaternion exponential's |omega| = 0 point)
_LIN_SLIP = 0.02
_LIN_SPIN = 0.01


def design_lqr(params: EnvParams) -> LQRDesign:
    """Per-plane ground-balance LQR gains synthesized from the true step
    map, on the host CPU (cached per ``RocketParams``)."""
    return _design_lqr_impl(params.rocket)


@functools.lru_cache(maxsize=8)
def _design_lqr_impl(rp: RocketParams) -> LQRDesign:
    gains, slopes, z_eq = [], [], None
    for pitch in (False, True):
        theta_e, u_e, depth_e = solve_equilibrium(rp, 0.0, pitch)
        z0 = 0.5 * float(rp.length) * np.cos(theta_e) - depth_e
        if not pitch:
            z_eq = z0
        u_star = torch.tensor(u_e, dtype=F32)
        jac = torch.func.jacrev(lambda s, u: _plane_step(s, u, 0.0, rp, pitch), argnums=(0, 1))
        # the friction couplings are odd in the slip sign: averaging the
        # four corners keeps only the symmetric dynamics
        a = np.zeros((6, 6))
        b = np.zeros((6, 1))
        for slip in (_LIN_SLIP, -_LIN_SLIP):
            for spin in (_LIN_SPIN, -_LIN_SPIN):
                s_star = torch.tensor([0.0, z0, theta_e, slip, 0.0, spin], dtype=F32)
                ja, jb = jac(s_star, u_star)
                if not (torch.isfinite(ja).all() and torch.isfinite(jb).all()):
                    raise FloatingPointError(
                        f"non-finite step-map Jacobian at slip {slip} spin {spin} pitch {pitch}")
                a += 0.25 * ja.numpy().astype(np.float64)
                b += 0.25 * jb.numpy().astype(np.float64).reshape(6, 1)
        k = _dlqr(a, b, np.diag(_Q_DIAG), np.array([[_R]]))
        gains.append(k[0].astype(np.float32))
        # the trim slope d(theta*)/dd, numerically at d = 0.02
        th_d = solve_equilibrium(rp, 0.02, pitch)[0]
        slopes.append(np.float32((th_d - theta_e) / 0.02))
    for g in gains:   # the cache hands the same arrays to every caller
        g.setflags(write=False)
    return LQRDesign(gain=gains[0], gain_pitch=gains[1], z_eq=np.float32(z_eq),
                     trim_slope=slopes[0], trim_slope_pitch=slopes[1])


class LQRSchedule(NamedTuple):
    """The gain-scheduled ground-balance LQR over the (mass, thrust-scale) DR
    grid: the privileged teacher of the distillation chain and the
    evaluation suites' feasibility oracle. Float32 tensors (on the CPU as
    designed; ``to`` moves them).

    ``cell_success`` and ``feasible`` are the verification's measurement:
    the selected design's strict-window success on its own plant from
    tilt-perturbed starts, and the cells that pass. A failing cell's gains
    are the nearest passing cell's (its ``z_eq`` and trim slopes stay its
    own plant's), so interpolation never blends in a destabilizing design.
    """

    mass_grid: torch.Tensor          # (M,) kg
    tscale_grid: torch.Tensor        # (T,)
    gain: torch.Tensor               # (M, T, 6) yaw-plane gains
    gain_pitch: torch.Tensor         # (M, T, 6)
    z_eq: torch.Tensor               # (M, T)
    trim_slope: torch.Tensor         # (M, T)
    trim_slope_pitch: torch.Tensor   # (M, T)
    cell_success: torch.Tensor | None = None   # (M, T)
    feasible: torch.Tensor | None = None       # (M, T) bool
    # the port's addition: every variant's success per cell (M, T, variants),
    # which the selection read (card-vs-CPU checks count flipped rollouts)
    variant_success: torch.Tensor | None = None

    def to(self, device: str | torch.device) -> "LQRSchedule":
        return LQRSchedule(*(None if x is None else x.to(device) for x in self))


def _grid_design(rp: RocketParams, mass: torch.Tensor, thrust: torch.Tensor, pitch: bool):
    """One plane's linearization at every cell: the Jacobians A (C, 6, 6) and
    B (C, 6) of the step map averaged over the four (±slip, ±spin) corners
    about the d = 0 standing state, the standing CG height z0 (C,) and the
    trim slope dθ*/dd (C,), all float32.

    The cells are one batch through the plain integrator (the cells do not
    interact, so row j of every cell's Jacobian is the gradient of output j
    summed over the cells). The trim slope is a central difference of the
    static torque residual with u = −θ substituted: derivatives through the
    contact and drag norms at rest are not finite.
    """
    rp1 = dataclasses.replace(rp, thrust=1.0)   # thrust = 1 · scale: the cell's thrust exactly
    g_eff = 2.0 * float(rp.gravity)
    depth = (mass * g_eff - thrust) / float(rp.contact_stiffness)
    z0 = 0.5 * float(rp.length) - depth
    a = torch.zeros(mass.shape[0], 6, 6)
    b = torch.zeros(mass.shape[0], 6)
    for slip in (_LIN_SLIP, -_LIN_SLIP):
        for spin in (_LIN_SPIN, -_LIN_SPIN):
            s = _stack(z0, 0.0, z0, 0.0, slip, 0.0, spin).requires_grad_(True)
            u = torch.zeros_like(z0, requires_grad=True)
            out = _plane_step(s, u, 0.0, rp1, pitch, mass=mass, thrust_scale=thrust)
            rows = [torch.autograd.grad(out[:, j].sum(), (s, u), retain_graph=j < 5)
                    for j in range(6)]
            a = a + 0.25 * torch.stack([r[0] for r in rows], dim=1)
            b = b + 0.25 * torch.stack([r[1] for r in rows], dim=1)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise FloatingPointError(f"non-finite step-map Jacobian on the grid (pitch {pitch})")
    eps = torch.tensor(1e-3, dtype=F32)
    zero = torch.tensor(0.0, dtype=F32)

    def torque_res(theta, d):
        theta = torch.broadcast_to(theta, mass.shape)
        q3 = torch.stack([theta, -theta, depth], dim=-1)
        return _static_residual(q3, d, rp1, pitch, mass=mass, thrust_scale=thrust)[..., 2]

    with torch.no_grad():
        f_th = (torque_res(eps, zero) - torque_res(-eps, zero)) / (2.0 * eps)
        f_d = (torque_res(zero, eps) - torque_res(zero, -eps)) / (2.0 * eps)
    return a.detach(), b.detach(), z0, -f_d / f_th


def design_lqr_schedule(
    params: EnvParams,
    n_mass: int = 7,
    n_tscale: int = 7,
    ttw_margin: float = 0.95,
    verify: bool = True,
    verify_rollouts: int = 8,
    verify_horizon: int = 600,
    verify_tilt: float = 0.02,
    fill_threshold: float = 0.3,
    device: str | torch.device = DEFAULT_DEVICE,
    generator: torch.Generator | None = None,
    verify_draws: tuple[ResetDraws, torch.Tensor] | None = None,
) -> LQRSchedule:
    """The LQR synthesized at every (mass, thrust-scale) point of the env's
    DR box (mass ±mass_variation, thrust scale ±2·thrust_variation), as the
    reference's ``design_lqr_schedule``: thrust clamped to ``ttw_margin`` ×
    the double-gravity weight (no standing equilibrium above it); at d = 0
    the equilibrium is analytic (θ* = u* = 0, depth (m·g_eff − T)/k); one
    batched linearization per plane (``_grid_design``) on the host CPU in
    float32, the Riccati iterations in float64.

    ``verify`` rolls each cell's design (R × 1, × 0.25, × 4, and the nominal
    cell's gains) on its own true plant from tilt-perturbed starts on
    ``device`` (K1 on the card), keeps the best variant per cell and fills
    the cells below ``fill_threshold`` from the nearest passing cell
    (``_verify_schedule``). Its draws are ``verify_draws`` (the reset's
    draws and the tilt axis angles, one per row) or come from ``generator``
    (a generator on ``device`` seeded 0 when not given).
    """
    dev = resolve_device(device) if verify else None
    rp = params.rocket
    rnd = params.randomization
    g_eff = 2.0 * float(rp.gravity)
    mv, tv = float(rnd.mass_variation), float(rnd.thrust_variation)
    m0, t0 = float(rp.mass), float(rp.thrust)
    mass_grid = np.linspace(m0 * (1.0 - mv), m0 * (1.0 + mv), n_mass)
    tscale_grid = np.linspace(1.0 - 2.0 * tv, 1.0 + 2.0 * tv, n_tscale)
    mm, tt = np.meshgrid(mass_grid, tscale_grid, indexing="ij")
    mass_flat = torch.tensor(mm.ravel(), dtype=F32)
    thrust_flat = torch.tensor(np.minimum(tt.ravel() * t0, ttw_margin * mm.ravel() * g_eff),
                               dtype=F32)
    shape = (n_mass, n_tscale)
    out, ab_planes = {}, {}
    for pitch in (False, True):
        a, b, z0, slope = _grid_design(rp, mass_flat, thrust_flat, pitch)
        a_np = a.numpy().astype(np.float64)
        b_np = b.numpy().astype(np.float64).reshape(-1, 6, 1)
        ab_planes[pitch] = (a_np, b_np)
        gains = _dlqr_batch(a_np, b_np, np.diag(_Q_DIAG), np.array([[_R]]))[:, 0]
        suffix = "_pitch" if pitch else ""
        out["gain" + suffix] = torch.tensor(gains.reshape(shape + (6,)), dtype=F32)
        out["trim_slope" + suffix] = slope.reshape(shape)
        if not pitch:
            out["z_eq"] = z0.reshape(shape)
    sched = LQRSchedule(mass_grid=torch.tensor(mass_grid, dtype=F32),
                        tscale_grid=torch.tensor(tscale_grid, dtype=F32), **out)
    if not verify:
        return sched
    return _verify_schedule(params, sched, ab_planes, tscale_true=tt.ravel().astype(np.float32),
                            rollouts=verify_rollouts, horizon=verify_horizon,
                            tilt0=verify_tilt, fill_threshold=fill_threshold, device=dev,
                            generator=generator, draws=verify_draws)


# the control-cost variants tried per cell in the verification: R/4 slides
# the base harder through stiction, R·4 calms designs that chatter
_VERIFY_R_SCALES = (1.0, 0.25, 4.0)


def _verify_schedule(
    params: EnvParams,
    sched: LQRSchedule,
    ab_planes: dict,
    tscale_true: np.ndarray,
    rollouts: int,
    horizon: int,
    tilt0: float,
    fill_threshold: float,
    device: str | torch.device = DEFAULT_DEVICE,
    generator: torch.Generator | None = None,
    draws: tuple[ResetDraws, torch.Tensor] | None = None,
) -> LQRSchedule:
    """Roll every cell's candidate gain sets on the cell's true plant
    (unclamped thrust, cg = wind = 0, randomization and noise off,
    tilt-perturbed starts) in one batch of cells × variants × rollouts rows
    on ``device``; keep the best variant per cell (the first of equals) and
    give failing cells the nearest passing cell's gains."""
    dev = resolve_device(device)
    n_mass, n_tscale = sched.mass_grid.shape[0], sched.tscale_grid.shape[0]
    cells = n_mass * n_tscale
    mass_flat = np.repeat(sched.mass_grid.numpy(), n_tscale)
    base_gain = sched.gain.numpy().reshape(cells, 6)
    base_gain_p = sched.gain_pitch.numpy().reshape(cells, 6)
    variants, variants_pitch = [], []
    for r_scale in _VERIFY_R_SCALES:
        if r_scale == 1.0:
            variants.append(base_gain)
            variants_pitch.append(base_gain_p)
            continue
        r_mat = np.array([[_R * r_scale]])
        for plane, dest in ((False, variants), (True, variants_pitch)):
            a_np, b_np = ab_planes[plane]
            g = _dlqr_batch(a_np, b_np, np.diag(_Q_DIAG), r_mat)[:, 0].astype(np.float32)
            dest.append(np.nan_to_num(g))
    # the nominal cell's design as a cross-plant fallback
    i_nom = (n_mass // 2) * n_tscale + (n_tscale // 2)
    variants.append(np.broadcast_to(base_gain[i_nom], (cells, 6)).copy())
    variants_pitch.append(np.broadcast_to(base_gain_p[i_nom], (cells, 6)).copy())
    n_var = len(variants)

    # (cell, variant, rollout) flattened into one batch
    rows = cells * n_var * rollouts
    z_eq_flat = sched.z_eq.numpy().reshape(cells)

    def per_row(x):
        return torch.tensor(np.repeat(x, n_var * rollouts, 0), dtype=F32, device=dev)

    design_rows = LQRDesign(
        gain=torch.tensor(np.repeat(np.stack(variants, 1).reshape(-1, 6), rollouts, 0),
                          device=dev),
        gain_pitch=torch.tensor(np.repeat(np.stack(variants_pitch, 1).reshape(-1, 6), rollouts,
                                          0), device=dev),
        z_eq=per_row(z_eq_flat),
        trim_slope=torch.zeros(rows, dtype=F32, device=dev),
        trim_slope_pitch=torch.zeros(rows, dtype=F32, device=dev),
    )
    v_params = dataclasses.replace(params, randomization=dataclasses.replace(
        params.randomization, enabled=False, sensor_noise_enabled=False,
        sensor_noise_uniform=False, progress_rate_randomized=False))
    if draws is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    succ = _verify_rollouts(v_params, per_row(mass_flat), per_row(tscale_true), design_rows,
                            horizon, tilt0, generator=generator,
                            reset_draws=None if draws is None else draws[0],
                            ang=None if draws is None else draws[1])
    success = succ.cpu().numpy().astype(np.float32).reshape(cells, n_var, rollouts).mean(-1)
    best_var = success.argmax(1)
    best_succ = success[np.arange(cells), best_var]
    sel_gain = np.stack(variants, 1)[np.arange(cells), best_var]
    sel_gain_p = np.stack(variants_pitch, 1)[np.arange(cells), best_var]

    ok = best_succ >= fill_threshold
    if ok.any() and not ok.all():
        ii, jj = np.divmod(np.arange(cells), n_tscale)
        ok_idx = np.flatnonzero(ok)
        for c in np.flatnonzero(~ok):
            src = ok_idx[((ii[ok_idx] - ii[c]) ** 2 + (jj[ok_idx] - jj[c]) ** 2).argmin()]
            sel_gain[c] = sel_gain[src]
            sel_gain_p[c] = sel_gain_p[src]
    shape = (n_mass, n_tscale)
    return sched._replace(
        gain=torch.tensor(sel_gain.reshape(shape + (6,)), dtype=F32),
        gain_pitch=torch.tensor(sel_gain_p.reshape(shape + (6,)), dtype=F32),
        cell_success=torch.tensor(best_succ.reshape(shape), dtype=F32),
        feasible=torch.tensor(ok.reshape(shape)),
        variant_success=torch.tensor(success.reshape(shape + (n_var,)), dtype=F32),
    )


def verify_start(params: EnvParams, mass_r: torch.Tensor, tsc_r: torch.Tensor, tilt0: float,
                 generator: torch.Generator | None = None,
                 reset_draws: ResetDraws | None = None,
                 ang: torch.Tensor | None = None) -> EnvState:
    """The verification's starts: a reset of one env per row on the row's
    (mass, thrust scale) plant with cg = wind = 0, tilted by ``tilt0`` about
    the horizontal axis at angle ``ang`` (N,) in [0, 2π) (drawn from
    ``generator`` when not given)."""
    n, dev = mass_r.shape[0], mass_r.device
    states, _ = rocket_env.reset(params, n, dev, generator=generator, draws=reset_draws)
    zeros3 = torch.zeros((n, 3), dtype=F32, device=dev)
    states.dr = dataclasses.replace(states.dr, mass=mass_r, thrust_scale=tsc_r,
                                    cg_offset=zeros3, wind=zeros3.clone())
    if ang is None:
        ang = torch.rand(n, device=dev, generator=generator) * (2.0 * np.pi)
    axis = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], dim=-1)
    half = float(np.float32(tilt0 / 2.0))
    dq = torch.cat([axis * float(np.sin(np.float32(half))),
                    torch.full((n, 1), float(np.cos(np.float32(half))), device=dev)], dim=-1)
    states.body = dataclasses.replace(states.body, quat=quat.multiply(dq, states.body.quat))
    return states


@torch.no_grad()
def _verify_rollouts(
    params: EnvParams,
    mass_r: torch.Tensor,
    tsc_r: torch.Tensor,
    design_r: LQRDesign,
    horizon: int,
    tilt0: float,
    generator: torch.Generator | None = None,
    reset_draws: ResetDraws | None = None,
    ang: torch.Tensor | None = None,
) -> torch.Tensor:
    """First-episode strict success (N,) of per-row controllers on per-row
    plants from ``verify_start``'s tilted starts (a symmetric start balances
    any gain set on the knife edge), through ``batched_step_autoreset`` (K1
    on the card). An episode still running at the horizon counts as its
    current window state. The autoreset's draws come from ``generator``;
    they cannot change the result (only first episodes count)."""
    rp = params.rocket
    states = verify_start(params, mass_r, tsc_r, tilt0, generator, reset_draws, ang)
    n, dev = mass_r.shape[0], mass_r.device
    d0 = torch.zeros((n, 3), dtype=F32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    succ = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(horizon):
        act = lqr_action(states.body, design_r, d0, rp)
        states, out, _ = rocket_env.batched_step_autoreset(states, act, params,
                                                           generator=generator)
        ep_done = out.terminated | out.truncated
        succ = torch.where(~done & ep_done, out.mission_success, succ)
        done = done | ep_done
    return torch.where(done, succ, states.mission_success)


def interp_design(sched: LQRSchedule, mass: torch.Tensor, thrust_scale: torch.Tensor
                  ) -> LQRDesign:
    """Bilinear interpolation of the schedule at per-env (mass, thrust scale)
    draws (N,): an ``LQRDesign`` of (N, 6) and (N,) tensors on their device,
    which ``lqr_action`` takes. A zero-width axis (every grid point equal)
    pins to cell 0 with weight 0."""
    dev = mass.device

    def axis_coords(grid, x):
        grid = grid.to(dev)
        x = torch.clamp(x, grid[0], grid[-1])
        extent = grid[-1] - grid[0]
        f = torch.where(extent > 0,
                        (x - grid[0]) / torch.where(extent > 0, extent, 1.0)
                        * (grid.shape[0] - 1), 0.0)
        i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, grid.shape[0] - 2)
        return i0, f - i0

    mi, mw = axis_coords(sched.mass_grid, mass)
    ti, tw = axis_coords(sched.tscale_grid, thrust_scale)

    def bilerp(table):
        table = table.to(dev)
        wm = mw[..., None] if table.dim() == 3 else mw
        wt = tw[..., None] if table.dim() == 3 else tw
        c0 = table[mi, ti] * (1 - wt) + table[mi, ti + 1] * wt
        c1 = table[mi + 1, ti] * (1 - wt) + table[mi + 1, ti + 1] * wt
        return c0 * (1 - wm) + c1 * wm

    return LQRDesign(gain=bilerp(sched.gain), gain_pitch=bilerp(sched.gain_pitch),
                     z_eq=bilerp(sched.z_eq), trim_slope=bilerp(sched.trim_slope),
                     trim_slope_pitch=bilerp(sched.trim_slope_pitch))


def lqr_action_scheduled(body: RigidBodyState, sched: LQRSchedule, mass: torch.Tensor,
                         thrust_scale: torch.Tensor, d_known: torch.Tensor,
                         rp: RocketParams) -> torch.Tensor:
    """The gain-scheduled teacher's action: the design interpolated at the
    true (mass, thrust) draw, blind to the CG offset (``d_known`` zeros)."""
    return lqr_action(body, interp_design(sched, mass, thrust_scale), d_known, rp)


def lqr_action(body: RigidBodyState, design: LQRDesign, d_known: torch.Tensor,
               rp: RocketParams) -> torch.Tensor:
    """The policy's action in [-1, 1]² from the full body state (N envs).

    ``d_known`` (N, 3) is the CG offset the controller is told (zeros: blind;
    the LQR's position feedback supplies the integral action that absorbs
    the unknown trim). ``design`` holds one design (numpy fields) or one per
    env (tensors with a leading N axis, as ``interp_design`` gives).
    """
    dev = body.pos.device

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    up = torch.zeros_like(body.pos)   # made on the device: no host copy per call
    up[..., 2] = 1.0
    zhat = quat.rotate(body.quat, up)
    theta_x = torch.atan2(zhat[..., 0], zhat[..., 2])
    phi = torch.atan2(-zhat[..., 1], zhat[..., 2])
    th_star = t(design.trim_slope) * d_known[..., 0]
    ph_star = t(design.trim_slope_pitch) * d_known[..., 1]
    pos, vel, omega = body.pos, body.vel, body.omega
    sx = torch.stack([pos[..., 0], pos[..., 2], theta_x, vel[..., 0], vel[..., 2],
                      omega[..., 1]], dim=-1)
    sy = torch.stack([pos[..., 1], pos[..., 2], phi, vel[..., 1], vel[..., 2],
                      omega[..., 0]], dim=-1)
    zero = torch.zeros_like(th_star)
    z_eq = t(design.z_eq).expand_as(th_star)
    sx_star = torch.stack([zero, z_eq, th_star, zero, zero, zero], dim=-1)
    sy_star = torch.stack([zero, z_eq, ph_star, zero, zero, zero], dim=-1)
    u_yaw = -th_star - torch.sum(t(design.gain) * (sx - sx_star), dim=-1)
    u_pitch = -ph_star - torch.sum(t(design.gain_pitch) * (sy - sy_star), dim=-1)
    act = torch.stack([u_pitch, u_yaw], dim=-1) / rp.max_gimbal
    return torch.clamp(act, -1.0, 1.0)


@torch.no_grad()
def generate_demonstrations(
    env_params: EnvParams,
    design: LQRDesign,
    num_envs: int,
    num_steps: int,
    privileged: bool = False,
    history_len: int = 1,
    device: str | torch.device = DEFAULT_DEVICE,
    generator: torch.Generator | None = None,
    reset_draws: ResetDraws | None = None,
    step_draws: Sequence[StepDraws] | None = None,
) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """Roll the LQR in ``num_envs`` envs for ``num_steps`` steps and return
    replay-ready transitions and their statistics.

    The envs run with ``env_params`` as training will (domain draws,
    autoreset, every observation channel), so the stored (obs, action,
    reward, next_obs, done) live in the learner's observation space; the LQR
    acts on the body state, which nothing stored leaks. With ``history_len >
    1`` the stored views are the stacked [oldest..newest] windows, built as
    ``training.loop`` builds them; ``next_obs`` is the true next view (before
    the autoreset) and ``done`` is terminated only, as the loop's replay
    write. ``privileged=True`` tells the controller each episode's true CG
    offset (measured worse than blind in the reference; kept for probes).

    Returns ``(transitions, stats)``: transitions of shape (num_steps,
    num_envs, ...) and ``demo_transitions``, ``demo_episodes`` and
    ``demo_success_rate`` (one device read, at the end).
    """
    dev = resolve_device(device)
    if step_draws is not None and len(step_draws) != num_steps:
        raise ValueError(f"step_draws holds {len(step_draws)} steps, want {num_steps}")
    rp = env_params.rocket
    states, obs = rocket_env.reset(env_params, num_envs, dev, generator=generator,
                                   draws=reset_draws)
    window = obs[:, None, :].repeat(1, history_len, 1) if history_len > 1 else None
    blind = torch.zeros((num_envs, 3), dtype=F32, device=dev)
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    successes = torch.zeros((), dtype=torch.int64, device=dev)
    rows = []
    for t in range(num_steps):
        d = step_draws[t] if step_draws is not None else StepDraws()
        actions = lqr_action(states.body, design, states.dr.cg_offset if privileged else blind, rp)
        states, out, next_obs = rocket_env.batched_step_autoreset(
            states, actions, env_params, generator=generator, n_imu=d.n_imu,
            reset_draws=d.reset, u_drop=d.u_drop)
        done = out.terminated | out.truncated
        if history_len > 1:
            stored_obs = window.reshape(num_envs, -1)
            shifted = torch.cat([window[:, 1:], out.obs[:, None, :]], dim=1)
            stored_next = shifted.reshape(num_envs, -1)
            fresh = next_obs[:, None, :].expand(-1, history_len, -1)
            window = torch.where(done[:, None, None], fresh, shifted)
        else:
            stored_obs, stored_next = obs, out.obs
        rows.append({"obs": stored_obs, "action": actions, "reward": out.reward,
                     "next_obs": stored_next, "done": out.terminated.to(F32)})
        episodes += done.sum()
        successes += (done & out.mission_success).sum()
        obs = next_obs
    transitions = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    n_eps, n_succ = torch.stack([episodes, successes]).tolist()
    stats = {
        "demo_transitions": float(num_steps * num_envs),
        "demo_episodes": float(n_eps),
        "demo_success_rate": n_succ / max(n_eps, 1),
    }
    return transitions, stats


def seed_replay_buffer(buffer: replay_mod.ReplayBuffer, transitions: dict[str, torch.Tensor]
                       ) -> replay_mod.ReplayBuffer:
    """Write (T, B, ...) transitions into a ring replay one step batch at a
    time (``add_batch``'s no-straddle rule: the capacity must be a multiple of
    B, which the trainer guarantees by generating B = a divisor of num_envs)."""
    steps = next(iter(transitions.values())).shape[0]
    for t in range(steps):
        buffer = replay_mod.add_batch(buffer, {k: v[t] for k, v in transitions.items()})
    return buffer
