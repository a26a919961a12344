"""The reference's own reading of a configuration file.

A frozen copy of what the port derives from the same nested configuration
(its ``config/build.py``, the env and physics dataclasses' defaults): every
float rounded to float32 as the port's parameter arrays hold it, except the
control step ``dt``, which stays a Python float. Nothing here imports the
port; the numbers come from the configuration file alone, and the constants
the configuration does not hold are copied below.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

# constants of the env and physics that no configuration key sets
ROCKET_FIXED = dict(
    thrust_offset=(0.0, 0.0, -0.5), gravity=9.81, drag_coeff=0.47, rho0=1.225,
    atmosphere_scale_height=8400.0, aero_angular_damping=0.02, drag_min_speed=0.1,
    linear_damping=0.01, angular_damping=0.02, contact_stiffness=4000.0,
    contact_damping=60.0, contact_friction=0.8,
)
REWARD_FIXED = dict(
    excessive_tilt_threshold=0.52, excessive_tilt_scale=-500.0, saturation_threshold=0.9,
    saturation_scale=-50.0, variance_window=10,
)
MAX_HORIZONTAL_DISTANCE = 50.0
INIT_POS = (0.0, 0.0, 1.0)
NUM_PHASES = 7
PHASE_BOOST, PHASE_COAST, PHASE_LANDING, PHASE_TOUCHDOWN, PHASE_COMPLETE = 0, 1, 2, 3, 5
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def f32(x: float) -> float:
    return float(np.float32(x))


def _ns(**kw) -> SimpleNamespace:
    return SimpleNamespace(**{k: (f32(v) if isinstance(v, float) else
                                  tuple(f32(a) for a in v) if isinstance(v, tuple) else v)
                              for k, v in kw.items()})


def from_config(cfg: dict, dtype: torch.dtype = torch.float32) -> SimpleNamespace:
    """Env, policy and safety parameters from the nested configuration ``cfg``
    (the ``config`` object of a file under ``portbench/configs``); ``dtype``
    is the float type the reference computes in."""
    e, dr = cfg["env"], cfg["env"]["domain_randomization"]
    ms, r, sc = cfg["mission_success"], cfg["reward_function"], cfg["safety"]["constraints"]
    if e["magnus_effect"] or e["ground_effect"] or e["gyroscopic"]:
        raise NotImplementedError("the reference holds the parity physics only")
    rocket = _ns(
        mass=e["mass"], length=e["length"], radius=e["radius"], thrust=e["thrust"],
        max_gimbal=math.radians(e["max_gimbal_deg"]), fuel_burn_rate=e["fuel_burn_rate"],
        double_gravity=e["double_gravity"], substeps=e["substeps"], **ROCKET_FIXED)
    rocket.dt = float(e["physics_timestep"])
    rnd = _ns(
        enabled=dr["enabled"], sensor_noise_enabled=dr["sensor_noise_enabled"],
        sensor_noise_uniform=dr["sensor_noise_uniform"], mass_variation=dr["mass_variation"],
        thrust_variation=dr["thrust_variation"], cg_offset_max=dr["cg_offset_max"],
        wind_max=dr["wind_max"], sensor_noise_std=dr["sensor_noise_std"],
        init_tilt_max=dr["init_tilt_max"], init_omega_max=dr["init_omega_max"],
        init_pos_jitter=dr["init_pos_jitter"], dr_prob=dr["dr_prob"],
        dr_mixture_enabled=dr["dr_prob"] < 1.0,
        progress_rate_randomized=dr["progress_rate_min"] != dr["progress_rate_max"],
        progress_rate_min=dr["progress_rate_min"], progress_rate_max=dr["progress_rate_max"],
        actuator_delay=dr["actuator_delay"],
        sensor_dropout_enabled=dr["sensor_dropout_prob"] > 0.0,
        sensor_dropout_prob=dr["sensor_dropout_prob"], feasible_only=dr["feasible_only"],
        feasible_tries=dr["feasible_tries"], feasible_tilt_limit=ms["max_tilt_angle"])
    rnd.needs_uniform = rnd.enabled or rnd.sensor_noise_uniform or rnd.progress_rate_randomized
    success = _ns(**{k: ms[k] for k in (
        "max_tilt_angle", "max_angular_velocity", "max_horizontal_velocity",
        "max_vertical_velocity", "min_altitude", "max_altitude", "success_duration")})
    reward = _ns(**{k: r[k] for k in (
        "mission_completion_weight", "safety_compliance_weight", "fuel_efficiency_weight",
        "stability_bonus_weight", "control_smoothness_weight", "altitude_maintenance_weight",
        "crash_penalty", "gradient_penalty", "diversity_bonus", "clip_min", "clip_max",
        "target_altitude", "survival_normalized_success", "survival_success_scale",
        "equilibrium_relative_shaping")}, **REWARD_FIXED)
    termination = _ns(
        terminate_on_success=ms["terminate_on_success"], crash_altitude=sc["min_altitude"],
        max_tilt=sc["max_tilt"], max_altitude=sc["max_altitude"],
        max_horizontal_distance=MAX_HORIZONTAL_DISTANCE)
    trim, drift = e["trim_observation"], e["drift_observation"]
    obs_dim = (10 + (4 if trim["enabled"] else 0) + (4 if drift["enabled"] else 0)
               + (2 if e["action_observation"]["enabled"] else 0))
    p = _ns(
        max_episode_steps=e["max_episode_steps"], init_pos=INIT_POS,
        trim_obs_enabled=trim["enabled"], trim_obs_decay=trim["decay"],
        trim_obs_tilt_scale=trim["tilt_scale"], trim_obs_integral=trim["mode"] == "integral",
        trim_obs_clip=trim["integral_clip"], drift_obs_enabled=drift["enabled"],
        drift_obs_vel_scale=drift["vel_scale"], drift_obs_pos_scale=drift["pos_scale"],
        action_obs_enabled=e["action_observation"]["enabled"])
    p.rocket, p.randomization, p.success, p.reward, p.termination = (
        rocket, rnd, success, reward, termination)
    p.obs_dim, p.dtype = obs_dim, dtype
    # the policy: the SAC actor (ReLU stack, mean and log-std heads) and the
    # safety projection, applied when the config turns the safety layer on
    p.hidden_dims = tuple(cfg["algorithms"]["sac"]["hidden_dims"])
    p.safety = (_ns(**{k: sc[k] for k in ("max_tilt", "max_angular_velocity",
                                          "max_control_effort")})
                if cfg["safety"]["enabled"] else None)
    return p
