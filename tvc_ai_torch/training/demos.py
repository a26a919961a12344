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

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams
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


def _vec(*xs) -> torch.Tensor:
    """A float32 vector of 0-dim tensors and numbers."""
    return torch.stack([x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=F32)
                        for x in xs])


def _embed_yaw(s: torch.Tensor) -> RigidBodyState:
    half = s[2] * 0.5
    return RigidBodyState(pos=_vec(s[0], 0.0, s[1]),
                          quat=_vec(0.0, torch.sin(half), 0.0, torch.cos(half)),
                          vel=_vec(s[3], 0.0, s[4]), omega=_vec(0.0, s[5], 0.0))


def _embed_pitch(s: torch.Tensor) -> RigidBodyState:
    half = s[2] * 0.5
    return RigidBodyState(pos=_vec(0.0, s[0], s[1]),
                          quat=_vec(torch.sin(half), 0.0, 0.0, torch.cos(half)),
                          vel=_vec(0.0, s[3], s[4]), omega=_vec(s[5], 0.0, 0.0))


def _plane_inputs(u, d, pitch: bool):
    """(gimbal, cg offset) of one plane's control u and CG offset d."""
    if pitch:
        return _vec(u, 0.0), _vec(0.0, d, 0.0)
    return _vec(0.0, u), _vec(d, 0.0, 0.0)


def _plane_step(s: torch.Tensor, u: torch.Tensor, d: float, rp: RocketParams,
                pitch: bool) -> torch.Tensor:
    """The exact 50 Hz control-step map restricted to one tilt plane."""
    body = _embed_pitch(s) if pitch else _embed_yaw(s)
    gimbal, cg = _plane_inputs(u, d, pitch)
    control = integrator.ThrustControl(gimbal=gimbal, thrust_active=torch.tensor(1.0))
    nxt = integrator.step(body, control, rp, cg_offset=cg)
    if pitch:
        ang = 2.0 * torch.atan2(nxt.quat[0], nxt.quat[3])
        return torch.stack([nxt.pos[1], nxt.pos[2], ang, nxt.vel[1], nxt.vel[2], nxt.omega[0]])
    ang = 2.0 * torch.atan2(nxt.quat[1], nxt.quat[3])
    return torch.stack([nxt.pos[0], nxt.pos[2], ang, nxt.vel[0], nxt.vel[2], nxt.omega[1]])


def _static_residual(q3: torch.Tensor, d: float, rp: RocketParams, pitch: bool) -> torch.Tensor:
    """(lateral force, vertical force, plane torque) at rest: zero at the
    standing equilibrium (theta, u, depth)."""
    theta, u, depth = q3[0], q3[1], q3[2]
    z = 0.5 * rp.length * torch.cos(theta) - depth
    s = _vec(0.0, z, theta, 0.0, 0.0, 0.0)
    body = _embed_pitch(s) if pitch else _embed_yaw(s)
    gimbal, cg = _plane_inputs(u, d, pitch)
    control = integrator.ThrustControl(gimbal=gimbal, thrust_active=torch.tensor(1.0))
    mass = torch.tensor(rp.mass, dtype=F32)
    wrench = integrator.accumulate_forces(body, control, rp, mass, torch.tensor(1.0), cg,
                                          torch.zeros(3))
    contact = integrator.contact_wrench(body, rp)
    force = wrench.force + contact.force
    force = force - _vec(0.0, 0.0, rp.gravity * mass)   # the engine's half of gravity
    torque = wrench.torque + contact.torque
    if pitch:
        return torch.stack([force[1], force[2], torque[0]])
    return torch.stack([force[0], force[2], torque[1]])


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


def _dlqr(a: np.ndarray, b: np.ndarray, q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Discrete-time LQR by Riccati fixed-point iteration, in float64.

    A diverging iteration (an unstabilizable plant) returns a zero gain
    instead of overflowing.
    """
    p = q.copy()
    for _ in range(3000):
        btp = b.T @ p
        k = np.linalg.solve(r + btp @ b, btp @ a)
        p_next = q + a.T @ p @ (a - b @ k)
        p_next = 0.5 * (p_next + p_next.T)
        if not np.all(np.isfinite(p_next)) or np.max(np.abs(p_next)) > 1e12:
            return np.zeros((b.shape[1], a.shape[0]), a.dtype)
        if np.max(np.abs(p_next - p)) < 1e-9 * (1.0 + np.max(np.abs(p))):
            p = p_next
            break
        p = p_next
    btp = b.T @ p
    return np.linalg.solve(r + btp @ b, btp @ a)


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


def lqr_action(body: RigidBodyState, design: LQRDesign, d_known: torch.Tensor,
               rp: RocketParams) -> torch.Tensor:
    """The policy's action in [-1, 1]² from the full body state (N envs).

    ``d_known`` (N, 3) is the CG offset the controller is told (zeros: blind;
    the LQR's position feedback supplies the integral action that absorbs
    the unknown trim).
    """
    dev = body.pos.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    zhat = quat.rotate(body.quat, t([0.0, 0.0, 1.0]).expand_as(body.pos))
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
