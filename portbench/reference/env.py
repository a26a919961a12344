"""The plain batched rocket env: reset from draws, one control step, the
masked autoreset.

A frozen copy of the port's plain env code (domain draw with feasible-only
candidates and the easy/hard gate, observation with IMU noise, dropout and
the optional trim / drift / action channels, actuator delay, mission FSM,
the reward with its anti-hacking terms and the survival-normalized payout,
termination and truncation). The state is a flat dict keyed by the port's
``EnvState`` field paths (``body.pos``, ``dr.mass``, ...); every random
number comes in as a draw, every float is computed in ``p.dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import physics
from portbench.reference.params import (
    NUM_PHASES,
    PHASE_BOOST,
    PHASE_COAST,
    PHASE_COMPLETE,
    PHASE_LANDING,
    PHASE_TOUCHDOWN,
)

BODY = ("pos", "quat", "vel", "omega")


# --------------------------------------------------------------- domain draw
def _feasible_mask(mass, thrust_scale, cg_offset, rp, tilt_limit):
    g_eff = rp.gravity * (2.0 if rp.double_gravity else 1.0)
    thrust = thrust_scale * rp.thrust
    weight = mass * g_eff
    climb = thrust > weight
    sin_gimbal = float(np.sin(np.float32(rp.max_gimbal)))
    pinned = rp.contact_friction * (weight - thrust) > thrust * sin_gimbal
    cg_mag = torch.sqrt(torch.sum(cg_offset[..., :2] ** 2, dim=-1))
    tilted = torch.atan2(2.0 * thrust * cg_mag, weight) > tilt_limit
    return ~(climb | (~climb & pinned) | tilted)


def _thrust_scale(n, cfg):
    return 1.0 + torch.clamp(n * cfg.thrust_variation, -2.0 * cfg.thrust_variation,
                             2.0 * cfg.thrust_variation)


def _cg(u, cfg):
    cg = u * cfg.cg_offset_max
    return torch.cat([cg[..., :2], cg[..., 2:] * 0.5], dim=-1)


def domain(p, d: dict, n: int, dev) -> dict:
    """Per-episode physics from the reset's draws (``u_dr``, ``n_dr`` or the
    candidates ``u_feas``, ``n_feas``)."""
    rp, cfg, dt = p.rocket, p.randomization, p.dtype
    noise_std = torch.full((n,), cfg.sensor_noise_std if cfg.sensor_noise_enabled else 0.0,
                           dtype=dt, device=dev)
    out = {"dr.mass": torch.full((n,), rp.mass, dtype=dt, device=dev),
           "dr.thrust_scale": torch.ones(n, dtype=dt, device=dev),
           "dr.cg_offset": torch.zeros(n, 3, dtype=dt, device=dev),
           "dr.wind": torch.zeros(n, 3, dtype=dt, device=dev),
           "dr.sensor_noise_std": noise_std,
           "dr.progress_rate": torch.ones(n, dtype=dt, device=dev)}
    if not cfg.needs_uniform:
        return out
    u_dr = d["u_dr"]
    if cfg.sensor_noise_enabled and cfg.sensor_noise_uniform:
        out["dr.sensor_noise_std"] = noise_std * (u_dr[:, 5] * 0.5 + 0.5)
    if cfg.progress_rate_randomized:
        out["dr.progress_rate"] = cfg.progress_rate_min + (u_dr[:, 6] * 0.5 + 0.5) * (
            cfg.progress_rate_max - cfg.progress_rate_min)
    if not cfg.enabled:
        return out
    if cfg.feasible_only:
        u_feas, n_feas = d["u_feas"], d["n_feas"]
        mass_k = rp.mass * (1.0 + u_feas[..., 0] * cfg.mass_variation)
        thrust_k = _thrust_scale(n_feas[..., 0], cfg)
        cg_k = _cg(u_feas[..., 1:4], cfg)
        ok = _feasible_mask(mass_k, thrust_k, cg_k, rp, cfg.feasible_tilt_limit)
        i = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
        any_ok = ok.any(dim=1)
        mass = torch.where(any_ok, mass_k.gather(1, i)[:, 0], rp.mass)
        thrust_scale = torch.where(any_ok, thrust_k.gather(1, i)[:, 0], 1.0)
        cg_offset = torch.where(any_ok[:, None],
                                cg_k.gather(1, i[:, :, None].expand(n, 1, 3))[:, 0], 0.0)
        wind_src = n_feas.gather(1, i[:, :, None].expand(n, 1, 3))[:, 0, 1:]
    else:
        n_dr = d["n_dr"]
        mass = rp.mass * (1.0 + u_dr[:, 0] * cfg.mass_variation)
        thrust_scale = _thrust_scale(n_dr[:, 0], cfg)
        cg_offset = _cg(u_dr[:, 1:4], cfg)
        wind_src = n_dr[:, 1:]
    wind_xy = torch.clamp(wind_src * (cfg.wind_max * 0.5), -cfg.wind_max, cfg.wind_max)
    wind = torch.cat([wind_xy, torch.zeros(n, 1, dtype=dt, device=dev)], dim=-1)
    if cfg.dr_mixture_enabled:
        hard = (u_dr[:, 4] * 0.5 + 0.5) < cfg.dr_prob
        mass = torch.where(hard, mass, rp.mass)
        thrust_scale = torch.where(hard, thrust_scale, 1.0)
        cg_offset = torch.where(hard[:, None], cg_offset, 0.0)
        wind = torch.where(hard[:, None], wind, 0.0)
    out.update({"dr.mass": mass, "dr.thrust_scale": thrust_scale, "dr.cg_offset": cg_offset,
                "dr.wind": wind})
    return out


# --------------------------------------------------------------- observation
def _observe(p, body, fuel, phase, step_count, noise_std, progress_rate, n_imu,
             prev_imu=None, u_drop=None):
    rnd = p.randomization
    q, w = body["quat"], body["omega"]
    if rnd.sensor_noise_enabled:
        noise = n_imu * noise_std[:, None]
        q = physics.q_normalize(q + noise[:, :4])
        w = w + noise[:, 4:]
    phase_value = phase.to(p.dtype) / NUM_PHASES
    progress = torch.clamp(step_count.to(p.dtype) * progress_rate / p.max_episode_steps,
                           max=1.0)
    tail = [fuel[:, None], phase_value[:, None], progress[:, None]]
    if not rnd.sensor_dropout_enabled:
        return torch.cat([q, w, *tail], dim=-1), None
    imu = torch.cat([q, w], dim=-1)
    if prev_imu is not None:
        imu = torch.where((u_drop < rnd.sensor_dropout_prob)[:, None], prev_imu, imu)
    return torch.cat([imu, *tail], dim=-1), imu


def _append_trim(p, obs, trim):
    if not p.trim_obs_enabled:
        return obs
    return torch.cat([obs, torch.cat([trim[:, :2] * p.trim_obs_tilt_scale, trim[:, 2:]],
                                     dim=-1)], dim=-1)


def _append_drift(p, obs, body):
    if not p.drift_obs_enabled:
        return obs
    return torch.cat([obs, body["vel"][:, :2] * p.drift_obs_vel_scale,
                      body["pos"][:, :2] * p.drift_obs_pos_scale], dim=-1)


def _append_action(p, obs, action):
    return torch.cat([obs, action], dim=-1) if p.action_obs_enabled else obs


# --------------------------------------------------------------------- reset
def reset(p, d: dict) -> tuple[dict, torch.Tensor]:
    """Fresh episodes from the reset draws ``d`` (``u_init`` and the domain
    and IMU draws the config uses); returns (state, first observation)."""
    rnd, dt = p.randomization, p.dtype
    u = d["u_init"]
    n, dev = u.shape[0], u.device
    dr = domain(p, d, n, dev)
    angle = (u[:, 0] * 0.5 + 0.5) * rnd.init_tilt_max
    azimuth = u[:, 1] * math.pi
    axis = torch.stack([torch.cos(azimuth), torch.sin(azimuth), torch.zeros_like(azimuth)],
                       dim=-1)
    ix, iy, iz = p.init_pos
    jitter = u[:, 5:7] * rnd.init_pos_jitter
    body = {"pos": torch.stack([ix + jitter[:, 0], iy + jitter[:, 1],
                                torch.full_like(jitter[:, 0], iz)], dim=-1),
            "quat": physics.q_from_axis_angle(axis, angle),
            "vel": torch.zeros(n, 3, dtype=dt, device=dev),
            "omega": u[:, 2:5] * rnd.init_omega_max}
    fuel = torch.ones(n, dtype=dt, device=dev)
    phase = torch.full((n,), PHASE_BOOST, dtype=torch.int32, device=dev)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    obs, imu = _observe(p, body, fuel, phase, zeros_i, dr["dr.sensor_noise_std"],
                        dr["dr.progress_rate"], d.get("n_imu"))
    trim = torch.zeros(n, 4, dtype=dt, device=dev)
    prev_action = torch.zeros(n, 2, dtype=dt, device=dev)
    obs = _append_action(p, _append_drift(p, _append_trim(p, obs, trim), body), prev_action)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    state = {**{f"body.{k}": body[k] for k in BODY},
             "fuel": fuel, "step_count": zeros_i, "phase": phase, "mission_success": false,
             "success_count": zeros_i, "prev_action": prev_action, "has_prev_action": false,
             "reward_window": torch.zeros(n, p.reward.variance_window, dtype=dt, device=dev),
             "reward_window_len": zeros_i, "trim": trim, **dr}
    if imu is not None:
        state["prev_imu"] = imu
    return state, obs


# -------------------------------------------------------------------- reward
def _reward(cfg, altitude, tilt, ang, fuel, crashed, mission_successful, phase, action,
            prev_action, has_prev_action, window, window_len):
    zero = torch.zeros_like(altitude)
    effort = torch.linalg.vector_norm(action, dim=-1)
    mission = torch.where(mission_successful, 1.0,
                          torch.where(phase == PHASE_LANDING, 0.1, zero))
    tilt_term = torch.exp(-10.0 * torch.clamp(tilt - 0.087, min=0.0))
    ang_term = torch.exp(-5.0 * torch.clamp(ang - 0.1, min=0.0))
    alt_term = torch.where((altitude >= 0.2) & (altitude <= 20.0), 1.0, zero + 0.5)
    safety = (tilt_term + ang_term + alt_term) / 3.0
    fuel_eff = torch.where((fuel > 0.1) & (effort < 0.5), fuel * (1.0 - effort), zero)
    stability = torch.where((tilt < 0.05) & (ang < 0.1), 1.0,
                            torch.where((tilt < 0.1) & (ang < 0.2), 0.5, zero))
    action_diff = torch.linalg.vector_norm(action - prev_action, dim=-1)
    smooth = torch.where(has_prev_action, torch.exp(-5.0 * action_diff), zero + 1.0)
    alt_keep = torch.exp(-2.0 * torch.abs(altitude - cfg.target_altitude))
    crash = torch.where(crashed, cfg.crash_penalty, zero)
    excessive = torch.where(tilt > cfg.excessive_tilt_threshold,
                            cfg.excessive_tilt_scale * (tilt - cfg.excessive_tilt_threshold),
                            zero)
    saturation = torch.where(effort > cfg.saturation_threshold,
                             cfg.saturation_scale * (effort - cfg.saturation_threshold), zero)
    terms = [mission * cfg.mission_completion_weight, safety * cfg.safety_compliance_weight,
             fuel_eff * cfg.fuel_efficiency_weight, stability * cfg.stability_bonus_weight,
             smooth * cfg.control_smoothness_weight,
             alt_keep * cfg.altitude_maintenance_weight, crash, excessive, saturation]
    subtotal = sum(terms)
    w = cfg.variance_window
    n = torch.clamp(window_len, max=w).to(altitude.dtype)
    have_full = window_len > w
    denom = torch.clamp(n, min=1.0)
    mean = window.sum(dim=-1) / denom
    valid = torch.arange(w, device=altitude.device) < window_len[:, None]
    var = torch.where(valid, (window - mean[:, None]) ** 2,
                      torch.zeros_like(window)).sum(dim=-1) / denom
    variance_penalty = torch.where(have_full & (var > 10000.0), -cfg.gradient_penalty * var,
                                   zero)
    spread = window.amax(dim=-1) - window.amin(dim=-1)
    diversity = torch.where((window_len >= 2) & (spread > 1e-6), cfg.diversity_bonus, zero)
    total = torch.clamp(subtotal + (variance_penalty + diversity), cfg.clip_min, cfg.clip_max)
    new_window = torch.cat([window[:, 1:], total[:, None]], dim=-1)
    return total, new_window, torch.clamp(window_len + 1, max=2 ** 30)


# ---------------------------------------------------------------------- step
def step(p, s: dict, action: torch.Tensor, n_imu, u_drop) -> tuple[dict, dict]:
    """One control step without autoreset; returns (state, output) with
    output keys obs, reward, terminated, truncated."""
    rp, rnd, dt = p.rocket, p.randomization, p.dtype
    action = torch.clamp(action, -1.0, 1.0)
    applied = s["prev_action"] if rnd.actuator_delay else action
    thrust_active = s["fuel"] > 0.0
    fuel = torch.where(thrust_active, torch.clamp(s["fuel"] - rp.fuel_burn_rate, min=0.0),
                       s["fuel"])
    body = physics.integrate({k: s[f"body.{k}"] for k in BODY}, applied * rp.max_gimbal,
                             thrust_active, rp, s["dr.mass"], s["dr.thrust_scale"],
                             s["dr.cg_offset"], s["dr.wind"])
    step_count = s["step_count"] + 1
    altitude = body["pos"][:, 2]
    tilt = physics.tilt_angle(body["quat"])
    ang = torch.linalg.vector_norm(body["omega"], dim=-1)
    horiz_vel = torch.linalg.vector_norm(body["vel"][:, :2], dim=-1)
    vert_vel = torch.abs(body["vel"][:, 2])
    crashed = altitude < p.termination.crash_altitude
    obs, imu = _observe(p, body, fuel, s["phase"], step_count, s["dr.sensor_noise_std"],
                        s["dr.progress_rate"], n_imu, prev_imu=s.get("prev_imu"),
                        u_drop=u_drop)
    trim = s["trim"]
    if p.trim_obs_enabled:
        dcy = p.trim_obs_decay
        if p.trim_obs_integral:
            tilt_i = torch.clamp(trim[:, :2] + (1.0 - dcy) * obs[:, :2], -p.trim_obs_clip,
                                 p.trim_obs_clip)
            trim = torch.cat([tilt_i, dcy * trim[:, 2:] + (1.0 - dcy) * action], dim=-1)
        else:
            trim = dcy * trim + (1.0 - dcy) * torch.cat([obs[:, :2], action], dim=-1)
        obs = _append_trim(p, obs, trim)
    obs = _append_action(p, _append_drift(p, obs, body), action)

    # mission FSM (one transition at most) and the success window
    sc, phase = p.success, s["phase"]
    to_coast = (phase == PHASE_BOOST) & (fuel < 0.8)
    to_landing = (phase == PHASE_COAST) & (altitude < 5.0)
    to_touchdown = (phase == PHASE_LANDING) & (altitude < 1.0)
    completed = ((phase == PHASE_TOUCHDOWN) & (altitude < 0.5)
                 & (tilt < sc.max_tilt_angle) & (ang < sc.max_angular_velocity))
    new_phase = torch.where(to_coast, PHASE_COAST, phase)
    new_phase = torch.where(to_landing, PHASE_LANDING, new_phase)
    new_phase = torch.where(to_touchdown, PHASE_TOUCHDOWN, new_phase)
    new_phase = torch.where(completed, PHASE_COMPLETE, new_phase)
    met = ((tilt < sc.max_tilt_angle) & (vert_vel < sc.max_vertical_velocity)
           & (horiz_vel < sc.max_horizontal_velocity) & (altitude >= sc.min_altitude)
           & (altitude <= sc.max_altitude) & (ang < sc.max_angular_velocity))
    success_count = torch.where(met, s["success_count"] + 1, 0)
    window_success = success_count >= sc.success_duration
    mission_success = s["mission_success"] | completed | window_success

    rcfg = p.reward
    reward_tilt = tilt
    if rcfg.equilibrium_relative_shaping:
        to_cg = s["dr.cg_offset"] - torch.tensor(rp.thrust_offset, dtype=dt, device=tilt.device)
        bhat = to_cg / torch.linalg.vector_norm(to_cg, dim=-1, keepdim=True)
        reward_tilt = torch.arccos(torch.clamp(physics.q_rotate(body["quat"], bhat)[:, 2],
                                               -1.0, 1.0))
    total, window, window_len = _reward(
        rcfg, altitude, reward_tilt, ang, fuel, crashed, s["mission_success"], phase, action,
        s["prev_action"], s["has_prev_action"], s["reward_window"], s["reward_window_len"])
    if rcfg.survival_normalized_success:
        first = (completed | window_success) & ~s["mission_success"]
        fill = torch.clamp(window_len.to(dt), 1.0, float(rcfg.variance_window))
        mean = window.sum(dim=-1) / fill
        remaining = torch.clamp(p.max_episode_steps - step_count, min=0).to(dt)
        total = total + torch.where(
            first, torch.clamp(mean, min=0.0) * remaining * rcfg.survival_success_scale, 0.0)

    term = p.termination
    horiz_dist = torch.linalg.vector_norm(body["pos"][:, :2], dim=-1)
    terminated = (crashed | (tilt > term.max_tilt) | (altitude > term.max_altitude)
                  | (horiz_dist > term.max_horizontal_distance))
    if term.terminate_on_success:
        terminated = terminated | mission_success
    truncated = step_count >= p.max_episode_steps
    new = {**{f"body.{k}": body[k] for k in BODY}, "fuel": fuel, "step_count": step_count,
           "phase": new_phase, "mission_success": mission_success,
           "success_count": success_count, "prev_action": action,
           "has_prev_action": torch.ones_like(s["has_prev_action"]), "reward_window": window,
           "reward_window_len": window_len, "trim": trim,
           **{k: v for k, v in s.items() if k.startswith("dr.")}}
    if imu is not None:
        new["prev_imu"] = imu
    return new, {"obs": obs, "reward": total, "terminated": terminated,
                 "truncated": truncated}


def step_autoreset(p, s: dict, action, n_imu, u_drop, reset_draws: dict):
    """``step``, then a reset of every env from ``reset_draws`` selected where
    the episode ended; returns (state, output, next policy observation)."""
    new, out = step(p, s, action, n_imu, u_drop)
    done = out["terminated"] | out["truncated"]
    fresh, fresh_obs = reset(p, reset_draws)

    def select(r, x):
        return torch.where(done.view(-1, *([1] * (x.dim() - 1))), r, x)

    return {k: select(fresh[k], new[k]) for k in new}, out, select(fresh_obs, out["obs"])
