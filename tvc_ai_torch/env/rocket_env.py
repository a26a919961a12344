"""The batched rocket-TVC environment.

Counterpart of ``tvc_ai_tpu/env/rocket_env.py``, with the batch axis written
out (every function takes and returns N envs). It keeps the reference's
ordering quirks: the observation and the reward see the pre-update phase and
success flag, while termination sees the post-update flag. Double gravity
stays on by default.

Randomness is explicit. Each function that draws takes its draws as optional
tensors and otherwise draws them from ``generator`` on the device:

- reset: ``ResetDraws`` — ``u_init`` (N, 7) uniform [-1, 1], the domain draws
  ``u_dr`` (N, 7) and ``n_dr`` (N, 3) (or, with ``feasible_only``, the
  candidates ``u_feas`` (N, K, 4) and ``n_feas`` (N, K, 3)), and the first
  observation's IMU noise ``n_imu`` (N, 7) standard normal;
- step: ``n_imu`` (N, 7), the IMU noise of the new observation, and
  ``u_drop`` (N,) uniform [0, 1), its sensor-dropout draw;
- autoreset: one ``ResetDraws`` for all N envs, used where an episode ended
  (the reset is computed for every env and selected by mask, with no host
  synchronisation).

``batched_step_autoreset`` is the production path: pre-physics, the K1 CUDA
kernel (``ops.step_kernel``; its plain version on CPU tensors), post-physics,
then the masked autoreset. ``batched_step`` is the same step without the
autoreset (the evaluation rollout's); ``step`` is the plain reference.

The robust-training options act around the integrate, never in it: actuator
delay hands the physics the previous command, sensor dropout holds the last
presented IMU reading (``EnvState.prev_imu``), equilibrium-relative shaping
and the survival-normalized payout change the reward, and feasible-only draws
and the easy/hard mixture change the reset's domain draw.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from tvc_ai_torch.env import mission as mission_mod
from tvc_ai_torch.env import randomization
from tvc_ai_torch.env import reward as reward_mod
from tvc_ai_torch.env.types import (
    ACTION_DIM,
    NUM_PHASES,
    PHASE_BOOST,
    TRIM_OBS_DIM,
    EnvParams,
    EnvState,
    StepOutput,
)
from tvc_ai_torch.ops.step_kernel import step_kernel
from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.integrator import step as physics_step
from tvc_ai_torch.physics.types import RigidBodyState
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device
from tvc_ai_torch.utils.tree import tree_map


@dataclasses.dataclass
class ResetDraws:
    """The random numbers one reset of N envs consumes.

    ``u_dr`` is needed when any uniform domain draw is on, ``n_dr`` when
    domain randomization is on without ``feasible_only``, ``u_feas`` and
    ``n_feas`` (K = ``feasible_tries`` candidates) when it is on with it,
    ``n_imu`` when sensor noise is on; unneeded fields may be ``None``.
    """

    u_init: torch.Tensor
    u_dr: torch.Tensor | None = None
    n_dr: torch.Tensor | None = None
    n_imu: torch.Tensor | None = None
    u_feas: torch.Tensor | None = None   # (N, K, 4) uniform [-1, 1)
    n_feas: torch.Tensor | None = None   # (N, K, 3) standard normal


def draw_reset(
    params: EnvParams, n: int, device: torch.device,
    generator: torch.Generator | None = None,
) -> ResetDraws:
    """Draw what a reset of n envs needs (only the fields the config uses)."""
    rnd = params.randomization
    # the feasibility candidates replace the single normal draw
    feasible, k = rnd.enabled and rnd.feasible_only, rnd.feasible_tries
    return ResetDraws(
        u_init=randomization.draw_uniform((n, 7), device, generator),
        u_dr=(
            randomization.draw_uniform((n, 7), device, generator)
            if randomization.needs_uniform(rnd) else None
        ),
        n_dr=(
            torch.randn((n, 3), device=device, generator=generator)
            if rnd.enabled and not feasible else None
        ),
        n_imu=(
            torch.randn((n, 7), device=device, generator=generator)
            if rnd.sensor_noise_enabled else None
        ),
        u_feas=randomization.draw_uniform((n, k, 4), device, generator) if feasible else None,
        n_feas=(
            torch.randn((n, k, 3), device=device, generator=generator) if feasible else None
        ),
    )


def _observe(
    body: RigidBodyState,
    fuel: torch.Tensor,
    phase: torch.Tensor,
    step_count: torch.Tensor,
    params: EnvParams,
    noise_std: torch.Tensor,
    progress_rate: torch.Tensor,
    n_imu: torch.Tensor | None,
    prev_imu: torch.Tensor | None = None,
    u_drop: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(N, 10) observation [quat, ω, fuel, phase/7, progress], IMU noise on
    the quaternion (renormalized) and ω when sensor noise is on.

    With sensor dropout on, the IMU channels hold ``prev_imu`` where
    ``u_drop < sensor_dropout_prob`` (no drop without a ``prev_imu``: the
    reset's first reading). Returns ``(obs, imu)``: ``imu`` is the presented
    (N, 7) [quat, ω] reading, the next ``prev_imu``; None without dropout.
    """
    rnd = params.randomization
    q, w = body.quat, body.omega
    if rnd.sensor_noise_enabled:
        noise = n_imu * noise_std[:, None]
        q = quat.normalize(q + noise[:, :4])
        w = w + noise[:, 4:]
    phase_value = phase.to(torch.float32) / NUM_PHASES
    progress = torch.clamp(
        step_count.to(torch.float32) * progress_rate / params.max_episode_steps,
        max=1.0,
    )
    tail = [fuel[:, None], phase_value[:, None], progress[:, None]]
    if not rnd.sensor_dropout_enabled:
        return torch.cat([q, w, *tail], dim=-1), None
    imu = torch.cat([q, w], dim=-1)
    if prev_imu is not None:
        imu = torch.where((u_drop < rnd.sensor_dropout_prob)[:, None], prev_imu, imu)
    return torch.cat([imu, *tail], dim=-1), imu


def _append_trim(obs: torch.Tensor, trim: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """Append the scaled trim channels when the gate is on (obs += 4)."""
    if not params.trim_obs_enabled:
        return obs
    scaled = torch.cat([trim[:, :2] * params.trim_obs_tilt_scale, trim[:, 2:]], dim=-1)
    return torch.cat([obs, scaled], dim=-1)


def _append_drift(obs: torch.Tensor, body: RigidBodyState, params: EnvParams) -> torch.Tensor:
    """Append scaled [vx, vy, x, y] when the gate is on (obs += 4)."""
    if not params.drift_obs_enabled:
        return obs
    return torch.cat(
        [
            obs,
            body.vel[:, :2] * params.drift_obs_vel_scale,
            body.pos[:, :2] * params.drift_obs_pos_scale,
        ],
        dim=-1,
    )


def _append_action(obs: torch.Tensor, action: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """Append the commanded action when the gate is on (obs += 2)."""
    if not params.action_obs_enabled:
        return obs
    return torch.cat([obs, action], dim=-1)


def _reset_from_draws(params: EnvParams, draws: ResetDraws) -> tuple[EnvState, torch.Tensor]:
    rnd = params.randomization
    u = draws.u_init
    n, dev, f32 = u.shape[0], u.device, torch.float32
    dr = randomization.sample_domain_params(
        params.rocket, rnd, n, dev, u_dr=draws.u_dr, n_dr=draws.n_dr,
        u_feas=draws.u_feas, n_feas=draws.n_feas,
    )
    # tilt angle ~ U[0, max], azimuth ~ U[-π, π], ω and xy position jitter
    angle = (u[:, 0] * 0.5 + 0.5) * rnd.init_tilt_max
    azimuth = u[:, 1] * math.pi
    axis = torch.stack(
        [torch.cos(azimuth), torch.sin(azimuth), torch.zeros_like(azimuth)], dim=-1
    )
    q0 = quat.from_axis_angle(axis, angle)
    omega0 = u[:, 2:5] * rnd.init_omega_max
    ix, iy, iz = params.init_pos
    jitter = u[:, 5:7] * rnd.init_pos_jitter
    pos0 = torch.stack(
        [ix + jitter[:, 0], iy + jitter[:, 1], torch.full_like(jitter[:, 0], iz)], dim=-1
    )
    body = RigidBodyState(
        pos=pos0, quat=q0, vel=torch.zeros(n, 3, dtype=f32, device=dev), omega=omega0
    )
    fuel = torch.ones(n, dtype=f32, device=dev)
    phase = torch.full((n,), PHASE_BOOST, dtype=torch.int32, device=dev)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    # no dropout at reset: the first presented reading seeds prev_imu
    obs, imu = _observe(body, fuel, phase, zeros_i, params, dr.sensor_noise_std,
                        dr.progress_rate, draws.n_imu)
    trim = torch.zeros(n, TRIM_OBS_DIM, dtype=f32, device=dev)
    prev_action = torch.zeros(n, ACTION_DIM, dtype=f32, device=dev)
    obs = _append_trim(obs, trim, params)
    obs = _append_drift(obs, body, params)
    obs = _append_action(obs, prev_action, params)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    state = EnvState(
        body=body,
        fuel=fuel,
        step_count=zeros_i,
        phase=phase,
        mission_success=false,
        success_count=zeros_i,
        prev_action=prev_action,
        has_prev_action=false,
        reward_window=torch.zeros(n, params.reward.variance_window, dtype=f32, device=dev),
        reward_window_len=zeros_i,
        trim=trim,
        dr=dr,
        prev_imu=imu,
    )
    return state, obs


def reset(
    params: EnvParams,
    n: int,
    device: str | torch.device = DEFAULT_DEVICE,
    generator: torch.Generator | None = None,
    draws: ResetDraws | None = None,
) -> tuple[EnvState, torch.Tensor]:
    """Reset n envs: pose ``init_pos``/upright plus any configured initial
    randomization, a fresh domain draw, the first observation."""
    dev = resolve_device(device)
    if draws is None:
        draws = draw_reset(params, n, dev, generator)
    elif draws.u_init.device.type != dev.type or draws.u_init.shape[0] != n:
        raise ValueError(
            f"draws are for {draws.u_init.shape[0]} envs on {draws.u_init.device}, "
            f"want {n} on {dev}"
        )
    return _reset_from_draws(params, draws)


def _pre_physics(state: EnvState, action: torch.Tensor, params: EnvParams):
    """Action conditioning and the fuel gate (checked before the burn). With
    actuator delay the physics gets the previous command; the reward, the
    smoothness and trim terms and the action channels keep this one."""
    action = torch.clamp(action, -1.0, 1.0)
    applied = state.prev_action if params.randomization.actuator_delay else action
    gimbal = applied * params.rocket.max_gimbal
    thrust_active = state.fuel > 0.0
    fuel = torch.where(
        thrust_active,
        torch.clamp(state.fuel - params.rocket.fuel_burn_rate, min=0.0),
        state.fuel,
    )
    return action, gimbal, thrust_active, fuel


def _post_physics(
    state: EnvState,
    body: RigidBodyState,
    action: torch.Tensor,
    fuel: torch.Tensor,
    params: EnvParams,
    n_imu: torch.Tensor | None,
    u_drop: torch.Tensor | None = None,
) -> tuple[EnvState, StepOutput]:
    """Everything after the rigid-body integrate: observation, FSM, reward,
    termination."""
    step_count = state.step_count + 1
    altitude = body.pos[:, 2]
    tilt = quat.tilt_angle(body.quat)
    ang_mag = torch.linalg.vector_norm(body.omega, dim=-1)
    horiz_vel = torch.linalg.vector_norm(body.vel[:, :2], dim=-1)
    vert_vel = torch.abs(body.vel[:, 2])
    crashed = altitude < params.termination.crash_altitude

    # observation with the PRE-update phase
    obs, imu = _observe(body, fuel, state.phase, step_count, params,
                        state.dr.sensor_noise_std, state.dr.progress_rate, n_imu,
                        prev_imu=state.prev_imu, u_drop=u_drop)
    # obs[:, :2] is the presented qx, qy reading (after noise and dropout)
    trim = state.trim
    if params.trim_obs_enabled:
        d = params.trim_obs_decay
        if params.trim_obs_integral:
            tilt_i = torch.clamp(
                trim[:, :2] + (1.0 - d) * obs[:, :2],
                -params.trim_obs_clip, params.trim_obs_clip,
            )
            trim = torch.cat([tilt_i, d * trim[:, 2:] + (1.0 - d) * action], dim=-1)
        else:
            trim = d * trim + (1.0 - d) * torch.cat([obs[:, :2], action], dim=-1)
        obs = _append_trim(obs, trim, params)
    obs = _append_drift(obs, body, params)
    obs = _append_action(obs, action, params)

    new_phase, completed = mission_mod.update_phase(
        state.phase, altitude, tilt, fuel, ang_mag, params.success
    )
    success_count, window_success = mission_mod.update_success_window(
        state.success_count, altitude, tilt, ang_mag, horiz_vel, vert_vel,
        params.success,
    )
    mission_success = state.mission_success | completed | window_success

    # reward with the PRE-update phase and success flag; with equilibrium-
    # relative shaping its tilt is measured from the episode's hover axis
    # (gimbal -> CG line world-vertical); the FSM and termination keep the
    # true tilt
    rcfg = params.reward
    reward_tilt = tilt
    if rcfg.equilibrium_relative_shaping:
        to_cg = state.dr.cg_offset - _constant(params.rocket.thrust_offset, body.quat.device)
        bhat = to_cg / torch.linalg.vector_norm(to_cg, dim=-1, keepdim=True)
        reward_tilt = torch.arccos(torch.clamp(quat.rotate(body.quat, bhat)[:, 2], -1.0, 1.0))
    total_reward, reward_window, reward_window_len, components = reward_mod.compute_reward(
        rcfg,
        altitude=altitude,
        tilt=reward_tilt,
        angular_velocity_mag=ang_mag,
        fuel=fuel,
        crashed=crashed,
        mission_successful=state.mission_success,
        phase=state.phase,
        action=action,
        prev_action=state.prev_action,
        has_prev_action=state.has_prev_action,
        reward_window=state.reward_window,
        reward_window_len=state.reward_window_len,
    )
    if rcfg.survival_normalized_success:
        # a one-time payout on the first success step, after the per-step
        # clip: the mean of the window this step filled (its reward
        # included) times the steps left
        first = (completed | window_success) & ~state.mission_success
        fill = torch.clamp(reward_window_len.to(torch.float32), 1.0,
                           float(rcfg.variance_window))
        mean = reward_window.sum(dim=-1) / fill
        remaining = torch.clamp(params.max_episode_steps - step_count, min=0).to(torch.float32)
        total_reward = total_reward + torch.where(
            first, torch.clamp(mean, min=0.0) * remaining * rcfg.survival_success_scale, 0.0)

    # termination with the POST-update success flag
    term = params.termination
    horiz_dist = torch.linalg.vector_norm(body.pos[:, :2], dim=-1)
    terminated = (
        crashed
        | (tilt > term.max_tilt)
        | (altitude > term.max_altitude)
        | (horiz_dist > term.max_horizontal_distance)
    )
    if term.terminate_on_success:
        terminated = terminated | mission_success
    truncated = step_count >= params.max_episode_steps

    new_state = EnvState(
        body=body,
        fuel=fuel,
        step_count=step_count,
        phase=new_phase,
        mission_success=mission_success,
        success_count=success_count,
        prev_action=action,
        has_prev_action=torch.ones_like(state.has_prev_action),
        reward_window=reward_window,
        reward_window_len=reward_window_len,
        trim=trim,
        dr=state.dr,
        prev_imu=imu,
    )
    out = StepOutput(
        obs=obs,
        reward=total_reward,
        terminated=terminated,
        truncated=truncated,
        altitude=altitude,
        tilt=tilt,
        angular_velocity_mag=ang_mag,
        fuel=fuel,
        phase=new_phase,
        mission_success=mission_success,
        crashed=crashed,
        reward_components=components,
    )
    return new_state, out


@functools.lru_cache(maxsize=16)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, made once (a fresh
    host-to-device copy per step would synchronise)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _step_draws(params: EnvParams, like: torch.Tensor, generator, n_imu, u_drop):
    """The step's IMU noise and dropout draws, from ``generator`` where not given."""
    rnd = params.randomization
    n = like.shape[0]
    if n_imu is None and rnd.sensor_noise_enabled:
        n_imu = torch.randn((n, 7), device=like.device, generator=generator)
    if u_drop is None and rnd.sensor_dropout_enabled:
        u_drop = torch.rand((n,), device=like.device, generator=generator)
    return n_imu, u_drop


def _step(state, action, params, integrate, generator, n_imu, u_drop):
    """Pre-physics, ``integrate`` (the plain integrator or K1), post-physics."""
    if params.randomization.sensor_dropout_enabled and state.prev_imu is None:
        raise ValueError("sensor dropout is on but the state holds no prev_imu; "
                         "reset it with these parameters")
    n_imu, u_drop = _step_draws(params, action, generator, n_imu, u_drop)
    action, gimbal, thrust_active, fuel = _pre_physics(state, action, params)
    body = integrate(
        state.body,
        ThrustControl(gimbal=gimbal, thrust_active=thrust_active),
        params.rocket,
        mass=state.dr.mass,
        thrust_scale=state.dr.thrust_scale,
        cg_offset=state.dr.cg_offset,
        wind=state.dr.wind,
    )
    return _post_physics(state, body, action, fuel, params, n_imu, u_drop)


def step(
    state: EnvState,
    action: torch.Tensor,
    params: EnvParams,
    generator: torch.Generator | None = None,
    n_imu: torch.Tensor | None = None,
    u_drop: torch.Tensor | None = None,
) -> tuple[EnvState, StepOutput]:
    """One control step of N envs, no autoreset, plain integrator."""
    return _step(state, action, params, physics_step, generator, n_imu, u_drop)


def _finish_autoreset(
    new_state: EnvState,
    out: StepOutput,
    params: EnvParams,
    generator: torch.Generator | None,
    reset_draws: ResetDraws | None,
) -> tuple[EnvState, StepOutput, torch.Tensor]:
    """Masked in-place reset where the episode ended."""
    done = out.terminated | out.truncated
    if reset_draws is None:
        reset_draws = draw_reset(params, done.shape[0], done.device, generator)
    reset_state, reset_obs = _reset_from_draws(params, reset_draws)

    def select(r: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        return torch.where(done.view(-1, *([1] * (n.dim() - 1))), r, n)

    carried = tree_map(select, reset_state, new_state)
    return carried, out, select(reset_obs, out.obs)


def step_autoreset(
    state: EnvState,
    action: torch.Tensor,
    params: EnvParams,
    generator: torch.Generator | None = None,
    n_imu: torch.Tensor | None = None,
    reset_draws: ResetDraws | None = None,
    u_drop: torch.Tensor | None = None,
) -> tuple[EnvState, StepOutput, torch.Tensor]:
    """``step`` then the masked reset; returns (state, out, next_policy_obs).

    ``out.obs`` is the true next observation (for replay); ``next_policy_obs``
    equals it except where the episode ended, where it is the first
    observation of the fresh episode.
    """
    new_state, out = step(state, action, params, generator, n_imu, u_drop)
    return _finish_autoreset(new_state, out, params, generator, reset_draws)


def pallas_physics_ok(params: EnvParams) -> bool:
    """True when K1 implements the configured physics (no opt-in term on)."""
    r = params.rocket
    return not (r.magnus_effect or r.ground_effect or r.gyroscopic)


def batched_step(
    states: EnvState,
    actions: torch.Tensor,
    params: EnvParams,
    generator: torch.Generator | None = None,
    n_imu: torch.Tensor | None = None,
    u_drop: torch.Tensor | None = None,
) -> tuple[EnvState, StepOutput]:
    """The production N-env step without autoreset (the evaluation rollout's):
    ``step`` with the integrate done by K1 whenever ``pallas_physics_ok``.
    The opt-in physics terms K1 does not implement take the plain integrator.
    On CPU tensors K1's wrapper runs its plain version."""
    integrate = step_kernel if pallas_physics_ok(params) else physics_step
    return _step(states, actions, params, integrate, generator, n_imu, u_drop)


def batched_step_autoreset(
    states: EnvState,
    actions: torch.Tensor,
    params: EnvParams,
    generator: torch.Generator | None = None,
    n_imu: torch.Tensor | None = None,
    reset_draws: ResetDraws | None = None,
    u_drop: torch.Tensor | None = None,
) -> tuple[EnvState, StepOutput, torch.Tensor]:
    """The production N-env step: ``step_autoreset`` with the integrate done
    by K1 (``ops.step_kernel``) whenever ``pallas_physics_ok``, and by the
    plain integrator for the opt-in terms K1 does not implement. On CPU
    tensors K1's wrapper runs its plain version.
    """
    new_state, out = batched_step(states, actions, params, generator, n_imu, u_drop)
    return _finish_autoreset(new_state, out, params, generator, reset_draws)
