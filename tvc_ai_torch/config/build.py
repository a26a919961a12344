"""Bridge: typed config tree → the port's runtime types.

Counterpart of ``tvc_ai_tpu/config/build.py``. ``build_env_params`` gives an
``env.types.EnvParams`` of Python scalars holding the float32 values the
reference's arrays hold (as ``convert.env_params_from_numpy`` gives them:
every float field rounded to float32 except ``rocket.dt``, which the
reference keeps as a Python float). ``build_sac_config`` and
``build_loop_config`` give ``agents.sac.SACConfig`` and
``training.loop.TrainLoopConfig``.

An option the port cannot honour raises ``NotImplementedError`` here, when
the config is built, never later and never silently: bfloat16
(``SACConfig``).
"""

from __future__ import annotations

import math

from tvc_ai_torch.agents.physics_informed import PhysicsInformedConfig
from tvc_ai_torch.agents.sac import SACConfig
from tvc_ai_torch.config.schema import CurriculumStage, FrameworkConfig
from tvc_ai_torch.env.types import (
    ACTION_OBS_DIM,
    DRIFT_OBS_DIM,
    OBS_DIM,
    TRIM_OBS_DIM,
    EnvParams,
    RandomizationConfig,
    RewardConfig,
    SuccessConfig,
    TerminationConfig,
    as_float32,
)
from tvc_ai_torch.models.curiosity import CuriosityConfig
from tvc_ai_torch.models.hierarchical import HierarchicalConfig
from tvc_ai_torch.models.rnd import RNDConfig
from tvc_ai_torch.models.safety import SafetyConstraints
from tvc_ai_torch.physics.types import RocketParams
from tvc_ai_torch.training.loop import TrainLoopConfig


def build_env_params(
    cfg: FrameworkConfig, stage: CurriculumStage | None = None
) -> EnvParams:
    """EnvParams from config; a curriculum stage overlays its conditions
    (wind, mass variation, initial tilt and spin, sensor noise, gimbal limit,
    and the optional thrust / CG / dr_prob axes)."""
    e = cfg.env
    dr = e.domain_randomization
    gimbal_scale = stage.gimbal_limit_scale if stage else 1.0
    rocket = RocketParams(
        mass=e.mass,
        length=e.length,
        radius=e.radius,
        thrust=e.thrust,
        max_gimbal=math.radians(e.max_gimbal_deg) * gimbal_scale,
        fuel_burn_rate=e.fuel_burn_rate,
        double_gravity=e.double_gravity,
        gyroscopic=e.gyroscopic,
        magnus_effect=e.magnus_effect,
        ground_effect=e.ground_effect,
        dt=e.physics_timestep,
        substeps=e.substeps,
    )

    def optional(name: str, default):
        """The stage's optional axis ``name`` when it sets one, else ``default``."""
        value = getattr(stage, name) if stage else None
        return default if value is None else value

    dr_prob = optional("dr_prob", dr.dr_prob)
    rnd = RandomizationConfig(
        enabled=dr.enabled,
        sensor_noise_enabled=dr.sensor_noise_enabled,
        sensor_noise_uniform=dr.sensor_noise_uniform,
        mass_variation=stage.mass_variation if stage else dr.mass_variation,
        thrust_variation=optional("thrust_variation", dr.thrust_variation),
        cg_offset_max=optional("cg_offset_max", dr.cg_offset_max),
        wind_max=stage.wind_force if stage else dr.wind_max,
        sensor_noise_std=stage.sensor_noise if stage else dr.sensor_noise_std,
        init_tilt_max=stage.initial_tilt_max if stage else dr.init_tilt_max,
        init_omega_max=optional("initial_omega_max", dr.init_omega_max),
        init_pos_jitter=dr.init_pos_jitter,
        dr_prob=dr_prob,
        dr_mixture_enabled=dr_prob < 1.0,
        progress_rate_randomized=dr.progress_rate_min != dr.progress_rate_max,
        progress_rate_min=dr.progress_rate_min,
        progress_rate_max=dr.progress_rate_max,
        actuator_delay=dr.actuator_delay,
        sensor_dropout_enabled=dr.sensor_dropout_prob > 0.0,
        sensor_dropout_prob=dr.sensor_dropout_prob,
        feasible_only=dr.feasible_only,
        feasible_tries=dr.feasible_tries,
        # the filter tests against the run's own success tilt limit
        feasible_tilt_limit=cfg.mission_success.max_tilt_angle,
    )
    ms = cfg.mission_success
    success = SuccessConfig(
        max_tilt_angle=ms.max_tilt_angle,
        max_angular_velocity=ms.max_angular_velocity,
        max_horizontal_velocity=ms.max_horizontal_velocity,
        max_vertical_velocity=ms.max_vertical_velocity,
        min_altitude=ms.min_altitude,
        max_altitude=ms.max_altitude,
        success_duration=ms.success_duration,
    )
    r = cfg.reward_function
    reward = RewardConfig(
        mission_completion_weight=r.mission_completion_weight,
        safety_compliance_weight=r.safety_compliance_weight,
        fuel_efficiency_weight=r.fuel_efficiency_weight,
        stability_bonus_weight=r.stability_bonus_weight,
        control_smoothness_weight=r.control_smoothness_weight,
        altitude_maintenance_weight=r.altitude_maintenance_weight,
        crash_penalty=r.crash_penalty,
        gradient_penalty=r.gradient_penalty,
        diversity_bonus=r.diversity_bonus,
        clip_min=r.clip_min,
        clip_max=r.clip_max,
        target_altitude=r.target_altitude,
        survival_normalized_success=r.survival_normalized_success,
        survival_success_scale=r.survival_success_scale,
        equilibrium_relative_shaping=r.equilibrium_relative_shaping,
    )
    sc = cfg.safety.constraints
    termination = TerminationConfig(
        terminate_on_success=cfg.mission_success.terminate_on_success,
        crash_altitude=sc.min_altitude,
        max_tilt=sc.max_tilt,
        max_altitude=sc.max_altitude,
    )
    trim = e.trim_observation
    if trim.mode not in ("ema", "integral"):
        raise ValueError(
            f"env.trim_observation.mode={trim.mode!r} (want 'ema'|'integral')"
        )
    drift = e.drift_observation
    return as_float32(EnvParams(
        rocket=rocket,
        randomization=rnd,
        success=success,
        reward=reward,
        termination=termination,
        max_episode_steps=e.max_episode_steps,
        trim_obs_enabled=trim.enabled,
        trim_obs_decay=trim.decay,
        trim_obs_tilt_scale=trim.tilt_scale,
        trim_obs_integral=trim.mode == "integral",
        trim_obs_clip=trim.integral_clip,
        drift_obs_enabled=drift.enabled,
        drift_obs_vel_scale=drift.vel_scale,
        drift_obs_pos_scale=drift.pos_scale,
        action_obs_enabled=e.action_observation.enabled,
    ))


def build_sac_config(cfg: FrameworkConfig) -> SACConfig:
    s = cfg.algorithms.sac
    st = cfg.stability
    auto_ent = isinstance(s.ent_coef, str) and s.ent_coef == "auto"
    return SACConfig(
        hidden_dims=tuple(s.hidden_dims),
        lr_actor=s.lr_actor,
        lr_critic=s.lr_critic,
        lr_alpha=s.lr_alpha,
        ema_decay=s.ema_decay,
        compute_dtype=s.compute_dtype,
        gamma=s.gamma,
        tau=s.tau,
        alpha=0.2 if auto_ent else float(s.ent_coef),
        automatic_entropy_tuning=auto_ent,
        batch_size=s.batch_size,
        buffer_size=s.buffer_size,
        learning_starts=s.learning_starts,
        gradient_clip_norm=s.grad_clip_norm,
        reward_scale=s.reward_scale,
        # Q-filtered BC toward demo actions; only meaningful when the loop
        # mixes demo batches (training.demo_seeding.fraction > 0)
        bc_weight=(
            cfg.training.demo_seeding.bc_weight
            if cfg.training.demo_seeding.enabled
            else 0.0
        ),
        architecture=cfg.network.architecture_type,
        transformer_d_model=cfg.network.transformer.d_model,
        transformer_layers=cfg.network.transformer.num_layers,
        transformer_heads=cfg.network.transformer.num_heads,
        lr_schedule=(
            st.scheduler_type if st.enable_lr_scheduling else "constant"
        ),
        # decay horizon in gradient updates: (env steps / envs) ×
        # updates_per_step / update_interval (the Trainer replaces it with
        # its own horizon, which leaves update_interval out)
        schedule_total_steps=max(
            int(
                cfg.training.total_timesteps
                / max(cfg.training.num_envs, 1)
                * cfg.training.updates_per_step
                / max(cfg.training.update_interval, 1)
            ),
            1,
        ),
        adaptive_tau=st.adaptive_tau,
    )


def build_loop_config(cfg: FrameworkConfig) -> TrainLoopConfig:
    """Fused-loop config: the shape and cadence, the history window, the
    demo fraction, the safety layer and the extension stack (ICM with the
    physics-informed loss, RND, hierarchical RL)."""
    t = cfg.training
    h = cfg.hierarchical_rl
    icm = cfg.exploration.curiosity
    rnd = cfg.exploration.random_network_distillation
    pi = cfg.physics_informed
    sc = cfg.safety.constraints
    return TrainLoopConfig(
        num_envs=t.num_envs,
        rollout_steps=t.rollout_steps,
        updates_per_step=t.updates_per_step,
        update_interval=t.update_interval,
        obs_dim=OBS_DIM
        + (TRIM_OBS_DIM if cfg.env.trim_observation.enabled else 0)
        + (DRIFT_OBS_DIM if cfg.env.drift_observation.enabled else 0)
        + (ACTION_OBS_DIM if cfg.env.action_observation.enabled else 0),
        demo_fraction=(
            t.demo_seeding.fraction if t.demo_seeding.enabled else 0.0
        ),
        history_len=cfg.network.history_len,
        use_pallas_physics=t.use_pallas_physics,
        use_safety_layer=cfg.safety.enabled,
        safety=SafetyConstraints(
            max_tilt=sc.max_tilt,
            max_angular_velocity=sc.max_angular_velocity,
            min_altitude=sc.min_altitude,
            max_altitude=sc.max_altitude,
            max_control_effort=sc.max_control_effort,
            fuel_reserve=sc.fuel_reserve,
        ),
        use_curiosity=icm.enabled,
        curiosity=CuriosityConfig(
            hidden_dim=icm.hidden_dim,
            lr=icm.lr,
            reward_scale=icm.reward_scale,
        ),
        use_rnd=rnd.enabled,
        rnd=RNDConfig(
            hidden_dims=tuple(rnd.network_size),
            lr=rnd.lr,
            reward_scale=rnd.reward_scale,
            update_frequency=rnd.update_frequency,
        ),
        use_physics_informed=pi.enabled,
        physics_informed=PhysicsInformedConfig(physics_weight=pi.physics_loss_weight),
        use_hierarchical=h.enabled,
        hierarchical=HierarchicalConfig(
            num_goals=h.num_goals,
            high_level_lr=h.high_level_lr,
            low_level_lr=h.low_level_lr,
        ),
    )
