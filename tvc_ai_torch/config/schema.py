"""Typed configuration tree (the reference's 452-line YAML, validated).

Counterpart of ``tvc_ai_tpu/config/schema.py``, kept as a copy so the port
imports nothing of the JAX package: the same dataclass tree, defaults and
``from_dict`` / ``to_dict``. Each section is a dataclass with defaults
matching the reference's config/config.yaml values; ``from_dict``
recursively builds the tree and REJECTS unknown keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, get_args, get_origin, get_type_hints


def _build(cls, data: dict[str, Any], path: str = ""):
    """Recursively build dataclass ``cls`` from a plain dict, strictly."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"config section '{path}' must be a mapping, got {type(data)}")
    hints = get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys at '{path or cls.__name__}': {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        target = hints[name]
        sub_path = f"{path}.{name}" if path else name
        if dataclasses.is_dataclass(target) and isinstance(value, dict):
            kwargs[name] = _build(target, value, sub_path)
        elif get_origin(target) is dict and value is not None:
            val_type = get_args(target)[1] if get_args(target) else Any
            if dataclasses.is_dataclass(val_type):
                kwargs[name] = {
                    k: _build(val_type, v, f"{sub_path}.{k}") for k, v in value.items()
                }
            else:
                kwargs[name] = dict(value)
        elif get_origin(target) in (list, tuple) and value is not None:
            kwargs[name] = target.__origin__(value)
        else:
            kwargs[name] = _coerce(target, value, sub_path)
    return cls(**kwargs)


def _coerce(target, value, path: str):
    """Coerce YAML scalars to the annotated primitive type.

    YAML 1.1 parses ``3e-4`` (no decimal point) as a STRING; without coercion
    that string would flow into optimizers as a learning rate. Strings that
    cannot convert raise with the config path.
    """
    if value is None:
        return None
    try:
        if target is float and not isinstance(value, float):
            return float(value)
        if target is int and not isinstance(value, int):
            as_float = float(value)
            if as_float != int(as_float):
                raise ValueError(f"non-integer value {value!r}")
            return int(as_float)
        if target is bool and not isinstance(value, bool):
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in ("true", "1", "yes", "on"):
                    return True
                if lowered in ("false", "0", "no", "off"):
                    return False
                raise ValueError(f"not a boolean: {value!r}")
            return bool(value)
    except (TypeError, ValueError) as exc:
        raise TypeError(f"config '{path}': cannot coerce {value!r} to {target}") from exc
    return value


# --------------------------------------------------------------- sections


@dataclass
class GlobalsConfig:
    project_name: str = "TVC-AI-TPU"
    experiment_name: str = "rocket_tvc_tpu"
    output_dir: str = "./outputs/tpu"
    seed: int = 42
    debug: bool = False
    device: str = "auto"


@dataclass
class EnsembleConfig:
    enabled: bool = True
    algorithms: list[str] = field(default_factory=lambda: ["ppo", "sac", "td3"])
    selection_strategy: str = "dynamic"  # dynamic | best | voting
    performance_window: int = 100
    # exploration floor on the dynamic/best selection: with this probability
    # pick a member uniformly instead of the argmax. The reference's
    # selection is pure greedy (multi_algorithm_agent.py:693-733) — default
    # 0.0 keeps parity — but greedy STARVES trailing members: once one
    # leads, the others never act again, their performance windows freeze
    # at stale values, and their replay data degenerates to another
    # policy's trajectories (measured r3: the ensemble's SAC member evaled
    # 0% with 36-step episodes at a 40M budget while standalone SAC masters
    # the task at 1M — the member saw almost no self-generated data).
    selection_epsilon: float = 0.0


@dataclass
class PPOSection:
    enabled: bool = True
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    gae_lambda: float = 0.95
    n_steps: int = 2048
    n_epochs: int = 10
    batch_size: int = 64
    learning_rate: float = 2.5e-4
    lr_schedule: str = "linear"


@dataclass
class SACSection:
    enabled: bool = True
    lr_actor: float = 5e-5
    lr_critic: float = 1.5e-4
    lr_alpha: float = 3e-4
    buffer_size: int = 1_000_000
    learning_starts: int = 1000
    batch_size: int = 256
    tau: float = 0.005
    gamma: float = 0.99
    train_freq: int = 1
    gradient_steps: int = 1
    ent_coef: str = "auto"  # "auto" or float-as-string
    grad_clip_norm: float = 5.0
    reward_scale: float = 0.05  # TD-target scaling (returns reach thousands)
    hidden_dims: list[int] = field(default_factory=lambda: [256, 256])
    # Polyak-averaged (EMA) actor for evaluation/deployment: per-update
    # decay of the shadow copy (0 = off). At training LR the live policy
    # oscillates across the |ω|<0.1 success knife edge between adjacent
    # evals (RESULTS.md r2 item 9); the EMA actor is the stable estimator
    # that replaces "capture the best lucky eval". 0.999 ≈ 1000-update
    # averaging window.
    ema_decay: float = 0.0
    # hidden-stack compute dtype: float32 | bfloat16 (MXU-native matmuls;
    # params and output heads stay fp32)
    compute_dtype: str = "float32"


@dataclass
class TD3Section:
    enabled: bool = True
    learning_rate: float = 3e-4
    buffer_size: int = 1_000_000
    learning_starts: int = 100
    batch_size: int = 256
    tau: float = 0.005
    gamma: float = 0.99
    policy_delay: int = 2
    target_policy_noise: float = 0.2
    target_noise_clip: float = 0.5
    exploration_noise: float = 0.1
    hidden_dims: list[int] = field(default_factory=lambda: [256, 256])


@dataclass
class AlgorithmsConfig:
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    ppo: PPOSection = field(default_factory=PPOSection)
    sac: SACSection = field(default_factory=SACSection)
    td3: TD3Section = field(default_factory=TD3Section)


@dataclass
class TransformerConfig:
    d_model: int = 256
    num_heads: int = 8
    num_layers: int = 4
    dim_feedforward: int = 512
    dropout: float = 0.1
    max_seq_length: int = 5000


@dataclass
class NetworkConfig:
    architecture_type: str = "mlp"  # mlp | transformer
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    hidden_dims: list[int] = field(default_factory=lambda: [512, 512])
    use_se_block: bool = True
    # history conditioning: the policy consumes the last N observations
    # (the reference's unused PositionalEncoding/sequence_length hook,
    # agent/multi_algorithm_agent.py:93,197-210, made real); 1 = memoryless
    history_len: int = 1


@dataclass
class HierarchicalConfig:
    enabled: bool = False
    num_goals: int = 4
    goals: list[str] = field(
        default_factory=lambda: ["hover", "land", "recover", "maintain_altitude"]
    )
    high_level_lr: float = 1e-4
    low_level_lr: float = 3e-4


@dataclass
class CuriosityConfig:
    enabled: bool = False
    hidden_dim: int = 256
    lr: float = 1e-4
    reward_scale: float = 0.01


@dataclass
class RNDSection:
    """Random Network Distillation (the reference configures it at
    config/config.yaml ``random_network_distillation`` but never implements
    it — implemented here, models/rnd.py)."""

    enabled: bool = False
    network_size: list[int] = field(default_factory=lambda: [256, 128])
    lr: float = 1e-4
    reward_scale: float = 0.01
    update_frequency: int = 100


@dataclass
class ExplorationConfig:
    curiosity: CuriosityConfig = field(default_factory=CuriosityConfig)
    random_network_distillation: RNDSection = field(default_factory=RNDSection)
    action_noise: float = 0.1


@dataclass
class PhysicsInformedSection:
    enabled: bool = False
    physics_loss_weight: float = 0.1
    conservation_laws: list[str] = field(
        default_factory=lambda: ["momentum", "energy", "angular_momentum"]
    )


@dataclass
class MissionSuccessSection:
    max_tilt_angle: float = 0.087
    max_angular_velocity: float = 0.1
    max_horizontal_velocity: float = 0.5
    max_vertical_velocity: float = 2.0
    min_altitude: float = 0.2
    max_altitude: float = 2.0
    success_duration: int = 100
    # end the episode on mission success (env/types.py TerminationConfig.
    # terminate_on_success; default True = reference parity, False is the
    # training-incentive mode where the success payout is purely additive)
    terminate_on_success: bool = True


@dataclass
class RewardSection:
    mission_completion_weight: float = 100.0
    safety_compliance_weight: float = 50.0
    fuel_efficiency_weight: float = 20.0
    stability_bonus_weight: float = 10.0
    control_smoothness_weight: float = 5.0
    altitude_maintenance_weight: float = 5.0
    crash_penalty: float = -1000.0
    gradient_penalty: float = 0.1
    diversity_bonus: float = 0.05
    clip_min: float = -1000.0
    clip_max: float = 200.0
    target_altitude: float = 3.0
    # opt-in fix for the inherited success-disincentive flaw (see
    # env/types.py RewardConfig.survival_normalized_success); off = parity
    survival_normalized_success: bool = False
    # payout multiplier (env/types.py RewardConfig.survival_success_scale):
    # the payout window covers the descent phase whose step rewards are
    # depressed, so >1 keeps success strictly dominant over edge-hovering
    survival_success_scale: float = 1.0
    # privileged training-only shaping: dense tilt terms measured against
    # the per-episode hover equilibrium (see env/types.py RewardConfig)
    equilibrium_relative_shaping: bool = False


@dataclass
class CurriculumStage:
    name: str = "stage"
    episodes: int = 200
    wind_force: float = 0.0
    mass_variation: float = 0.05
    initial_tilt_max: float = 0.05
    sensor_noise: float = 0.0
    gimbal_limit_scale: float = 1.0
    success_threshold: float = 0.7
    # optional overlays for the axes the reference's stage schema omits
    # (None = inherit env.domain_randomization). CG offset is the dominant
    # failure axis for this task (scripts/ablate_dr.py finding), so a
    # curriculum that can't ramp it ramps around the real difficulty.
    thrust_variation: float | None = None
    cg_offset_max: float | None = None
    dr_prob: float | None = None
    # initial angular-rate randomization (rad/s). Distinct from tilt: a CG
    # offset spins the rocket up within ~2 control steps of an upright
    # start, so surviving it requires the instant omega-counter skill that
    # upright-start training never teaches (diagnose_cg.py r3 finding:
    # tip-over in 10 steps at cg 0.025).
    initial_omega_max: float | None = None


def default_stages() -> list[CurriculumStage]:
    """The reference's 6-stage schedule (config/config.yaml:236-286)."""
    return [
        CurriculumStage("hover_training", 200, 0.0, 0.05, 0.05, 0.0, 1.0, 0.7),
        CurriculumStage("disturbance_rejection", 300, 0.5, 0.1, 0.1, 0.0, 1.0, 0.75),
        CurriculumStage("moderate_control", 400, 1.0, 0.15, 0.2, 0.01, 1.0, 0.8),
        CurriculumStage("advanced_control", 500, 2.0, 0.2, 0.4, 0.02, 1.0, 0.85),
        CurriculumStage("extreme_robustness", 600, 3.0, 0.3, 0.7, 0.02, 1.0, 0.9),
    ]


@dataclass
class CurriculumConfig:
    enabled: bool = True
    type: str = "adaptive"
    success_threshold: float = 0.8
    stability_window: int = 100
    min_stage_fraction: float = 0.5  # must run ≥50% of stage before advancing
    # minimum env steps per stage before eval-driven promotion may fire —
    # without a dwell, a policy whose NOMINAL evals lag the new difficulty
    # sails through every stage in a few evals and lands on full difficulty
    # unprepared (measured: all stages promoted in 90 s, then collapse)
    min_stage_steps: int = 0
    # optional per-stage step budget (0 = disabled): when a stage has
    # consumed this many env steps without clearing its promotion gate, the
    # curriculum force-promotes with a prominent log line. Two campaigns
    # (r3's gamed gate, r4c's unreachable calm threshold) silently burned
    # their entire budget pinned at one stage; a bounded stage budget makes
    # the failure mode "trained the later stages anyway" instead of "never
    # saw them".
    max_stage_steps: int = 0
    # promotion-gate watchdog: warn when `watchdog_evals` consecutive stage
    # evals leave the stage-eval max below `watchdog_fraction` of the
    # stage's success threshold — the unreachable-threshold signature.
    watchdog_evals: int = 8
    watchdog_fraction: float = 0.5
    stages: list[CurriculumStage] = field(default_factory=default_stages)


@dataclass
class SafetyConstraints:
    max_tilt: float = 0.52
    max_angular_velocity: float = 5.0
    min_altitude: float = 0.1
    max_altitude: float = 20.0
    max_control_effort: float = 1.0
    fuel_reserve: float = 0.1


@dataclass
class SafetyConfig:
    enabled: bool = True
    layer_type: str = "cbf"
    intervention_threshold: float = 0.9
    constraints: SafetyConstraints = field(default_factory=SafetyConstraints)


@dataclass
class EarlyStoppingConfig:
    enabled: bool = True
    patience: int = 40         # eval rounds without improvement (~ref 200k steps at eval_freq 5000, scripts/train.py:485-488)
    min_improvement: float = 0.05
    metric: str = "eval_success_rate"


@dataclass
class CheckpointConfig:
    save_best: bool = True
    save_last: bool = True
    save_periodic: bool = True
    period: int = 25_000


@dataclass
class DemoSeedingConfig:
    """Seed the SAC replay buffer with LQR ground-balance demonstrations
    before training (training/demos.py). The r3/r4 forensics chain: five RL
    campaigns never discovered the CG-trim skill; the blind LQR synthesized
    from the true step map passes the strict window at any single-axis
    |cg| <= 0.045 with position feedback supplying the integral action.
    Seeding puts those success trajectories (incl. the sparse completion
    bonus) into replay so the critic sees the skill's value landscape from
    step one. Demos run in the learner's own observation space — enable
    env.drift_observation so the policy can *represent* the teacher."""

    enabled: bool = False
    # env steps per demo env (scan length): total transitions = steps × envs
    steps: int = 600
    # demo env count; 0 = training num_envs. Must divide num_envs so the
    # ring-buffer batch-write invariant holds.
    envs: int = 512
    # fraction of every SAC batch drawn from a PERSISTENT demo buffer
    # (DQfD-style mixed sampling; training/loop.py demo_fraction). 0 = demos
    # only seed the online ring, where they are overwritten within ~1M env
    # steps once the ring wraps — fine for a short warm start, useless for
    # a 100M+ campaign. With fraction > 0 the demos also live in
    # TrainCarry.demo_buffer and stay in the batch distribution forever.
    fraction: float = 0.0
    # Q-filtered behavior-cloning weight on demo samples in the actor loss
    # (agents/sac.py SACConfig.bc_weight; needs fraction > 0). Measured r4:
    # demo transitions in replay moved the critic but NOT the actor — at
    # 34M steps the policy was 100% nominal yet ~2% on the cg distribution
    # its demo buffer demonstrates at ~50%; BC is the actor-side coupling.
    bc_weight: float = 0.0
    # demo DR distribution overrides (None = inherit the corresponding
    # env.domain_randomization value). The default demo distribution should
    # concentrate where the teacher is competent (cg feasible range, modest
    # other axes) rather than copying a hard training stage.
    cg_offset_max: float | None = None
    mass_variation: float | None = None
    thrust_variation: float | None = None
    wind_max: float | None = None
    sensor_noise_std: float | None = None
    dr_prob: float | None = None
    # initial-condition overrides: match the curriculum stage the demos
    # must cover (e.g. cg_feasible starts tilted 0.05 rad with 0.2 rad/s
    # spin — demos from nominal starts never show the recovery-into-balance
    # the learner needs there)
    init_tilt_max: float | None = None
    init_omega_max: float | None = None
    # tell the controller each episode's true cg offset (measured WORSE
    # than blind — probes only)
    privileged: bool = False


@dataclass
class TrainingConfig:
    total_timesteps: int = 2_000_000
    eval_freq: int = 5000
    eval_episodes: int = 20
    save_freq: int = 10_000
    num_envs: int = 4096
    rollout_steps: int = 128   # env steps per fused iteration
    updates_per_step: int = 1
    # SAC updates fire every K env steps (1 = reference cadence). Raise it
    # with batch_size scaled by the same factor to trade many small matmuls
    # for few MXU-sized ones at equal sample budget (see loop.py)
    update_interval: int = 1
    algorithm: str = "sac"     # sac | ppo | td3 | ensemble
    # physics backend for the batched env step: null/None = auto (SoA Pallas
    # kernel on TPU when no extended physics term is enabled, vmapped XLA
    # otherwise); true/false force it (see env.rocket_env.batched_step_autoreset)
    use_pallas_physics: bool | None = None
    # keep IMU noise in evaluation episodes: without any randomization a
    # deterministic policy makes all eval episodes identical, so the success
    # rate degenerates to a 0/1 coin on threshold-edge behavior; σ=0.02
    # noise diversifies episodes into a meaningful statistic. False matches
    # the reference's sterile make_evaluation_env default.
    eval_sensor_noise: bool = False
    # keep domain randomization ON in the trainer's eval env (default off =
    # the reference's make_evaluation_env(domain_randomization=False)); turn
    # on to make best-checkpoint capture track ROBUST success — under DR the
    # nominal-eval metric and the robustness-suite score diverge sharply
    eval_domain_randomization: bool = False
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    checkpointing: CheckpointConfig = field(default_factory=CheckpointConfig)
    demo_seeding: DemoSeedingConfig = field(default_factory=DemoSeedingConfig)
    # warm-start the actor (and its EMA shadow) from a distilled student:
    # the port's student.pt or the JAX package's student.msgpack
    # (scripts/dagger_distill.py artifact: SACState with the student as
    # actor). RL fine-tuning ON TOP of the distilled student —
    # the student starts at the blind fixed-strategy bound (~3.9% strict on
    # the robustness suite, RESULTS r4) and RL adapts past it, instead of
    # spending most of the budget rediscovering ground balance. Critic and
    # optimizers start fresh. Empty string = disabled.
    warm_start_actor: str = ""


@dataclass
class DomainRandomizationConfig:
    enabled: bool = True
    sensor_noise_enabled: bool = True
    # per-episode σ ~ U[0, sensor_noise_std] (see env/types.py)
    sensor_noise_uniform: bool = False
    mass_variation: float = 0.3
    thrust_variation: float = 0.2
    cg_offset_max: float = 0.1
    wind_max: float = 3.0
    sensor_noise_std: float = 0.02
    # easy/hard episode mixture: probability the hard physical axes (mass/
    # thrust/CG/wind) are randomized per episode (env/types.py dr_prob)
    dr_prob: float = 1.0
    # per-episode progress-slope randomization (1.0/1.0 = off); see
    # env/types.py RandomizationConfig.progress_rate_*
    progress_rate_min: float = 1.0
    progress_rate_max: float = 1.0
    init_tilt_max: float = 0.0
    init_omega_max: float = 0.0
    init_pos_jitter: float = 0.0
    # one-control-step actuator delay (DR spec, ref config.yaml:340-349)
    actuator_delay: bool = False
    # per-step IMU hold-last fault rate (ref GUIDE/Config-guide/
    # CONFIG_GUIDE.md:93-96 sensor_dropout_prob, unimplemented there)
    sensor_dropout_prob: float = 0.0
    # feasibility-filtered sampling: reject draws on which no controller
    # can satisfy the strict success window (climb-away / friction-pinned /
    # equilibrium-tilt classes — env/types.py RandomizationConfig and
    # env/randomization.py::feasible_draw_mask). Training-distribution
    # engineering only; the eval suites stay official.
    feasible_only: bool = False
    feasible_tries: int = 8


@dataclass
class TrimObservationConfig:
    """Opt-in trim channels appended to the observation (10 → 14 dims):
    slow EMAs of the presented tilt reading (qx, qy) and of the commanded
    gimbal action. Makes a constant unknown thrust-torque bias (CG offset —
    the dominant robustness failure axis, RESULTS.md r2) directly readable
    by a memoryless policy; see env/types.py EnvParams.trim_obs_*."""

    enabled: bool = False
    decay: float = 0.99        # EMA decay per control step (~100-step window)
    tilt_scale: float = 10.0   # observation scaling on the tilt-EMA pair
    # "ema" (decaying average) or "integral" (clipped integrator on the tilt
    # pair — PI-style trim memory; holds the accumulated error instead of
    # decaying it away once the policy trims out)
    mode: str = "ema"
    integral_clip: float = 0.5  # anti-windup bound on the raw tilt integral


@dataclass
class DriftObservationConfig:
    """Opt-in drift channels appended to the observation (+4 dims): scaled
    horizontal velocity [vx, vy] and position drift [x, y] — an idealized
    INS estimate. The r4 LQR forensics (scripts/lqr_balance.py) showed the
    strict success window under CG offset is a ground-balance task whose
    stabilizing controller is linear feedback on (tilt, omega, v, x);
    position feedback supplies the integral action that absorbs the unknown
    trim, and neither v nor x is recoverable from the 10-D obs or a short
    history. See env/types.py EnvParams.drift_obs_*."""

    enabled: bool = False
    vel_scale: float = 2.0  # observation scaling on the velocity pair
    pos_scale: float = 0.5  # observation scaling on the position pair


@dataclass
class ActionObservationConfig:
    """Opt-in previous-action channels appended to the observation (+2
    dims, already [-1, 1]). With history stacking the policy input becomes
    (obs, action) pairs — the system-identification window a blind policy
    needs to infer the episode's mass/thrust draw from the response it
    provokes. Measured motivation (RESULTS.md r4): the nominal-plant LQR
    scores ~77 % under mass ±30 % or thrust ±20 % alone but 3 % on the
    full robustness suite; the gain-SCHEDULED (param-aware) LQR is the
    teacher, and these channels are what make the blind student's
    identification problem well-posed. See env/types.py ACTION_OBS_DIM."""

    enabled: bool = False


@dataclass
class EnvSection:
    max_episode_steps: int = 1000
    physics_timestep: float = 0.02
    substeps: int = 4
    double_gravity: bool = True  # reference parity quirk (SURVEY §2.1)
    # Euler gyroscopic term (physics/types.py RocketParams.gyroscopic);
    # off = Bullet-default parity, on = physically-correct precession
    gyroscopic: bool = False
    # Magnus lift / ground-effect thrust augmentation (the reference's
    # config.yaml:356-357 declares both true but never implements either;
    # implemented here opt-in, physics/types.py RocketParams)
    magnus_effect: bool = False
    ground_effect: bool = False
    mass: float = 2.0
    length: float = 1.0
    radius: float = 0.05
    thrust: float = 35.0
    max_gimbal_deg: float = 18.0
    fuel_burn_rate: float = 0.001
    domain_randomization: DomainRandomizationConfig = field(
        default_factory=DomainRandomizationConfig
    )
    trim_observation: TrimObservationConfig = field(
        default_factory=TrimObservationConfig
    )
    drift_observation: DriftObservationConfig = field(
        default_factory=DriftObservationConfig
    )
    action_observation: ActionObservationConfig = field(
        default_factory=ActionObservationConfig
    )


@dataclass
class StabilitySection:
    """Training-stability knobs (utils/training_stability.py's StabilityConfig)."""

    enable_lr_scheduling: bool = False
    scheduler_type: str = "warmup_cosine"
    enable_plasticity_preservation: bool = True
    dormant_check_interval: int = 5000
    # Default OFF = behavioral parity: the reference's stability manager is
    # initialized but never stepped (SURVEY §2.5). Measured when on at the
    # reference's 50k interval: the counter is gradient updates, so at 512
    # envs × 16 updates/step the 5% random weight re-mix fires every ~1.6M
    # env steps (~every 30 s of training) and repeatedly knocks a
    # knife-edge policy into the hover-farming basin — the root cause of a
    # whole campaign of mysterious mid-training collapses (RESULTS.md r2).
    enable_primacy_mitigation: bool = False
    reset_interval: int = 2_000_000
    reset_ratio: float = 0.05
    adaptive_tau: bool = False
    hacking_stop_threshold: float = 0.9


@dataclass
class LoggingConfig:
    level: str = "INFO"
    tensorboard: bool = True
    csv: bool = True
    log_freq_iterations: int = 1
    wandb_enabled: bool = False
    wandb_mode: str = "offline"


@dataclass
class HardwareConfig:
    device: str = "auto"        # auto | tpu | cpu
    mesh_devices: int = 0       # 0 = all available
    donate_buffers: bool = True


@dataclass
class DecisionTransformerConfig:
    """Disabled stub for parity with config/config.yaml:429-433."""

    enabled: bool = False
    context_length: int = 20


@dataclass
class MetaLearningConfig:
    """MAML stub (ref agent _setup_meta_learning :683-691, never used)."""

    enabled: bool = False
    inner_lr: float = 1e-2
    meta_lr: float = 1e-3
    inner_steps: int = 5


@dataclass
class MultiAgentConfig:
    """Population stub (config/config.yaml:442-446). Trivially realizable
    here by vmapping per-env agent params; kept disabled for parity."""

    enabled: bool = False
    num_agents: int = 4


@dataclass
class ExperimentalConfig:
    decision_transformer: DecisionTransformerConfig = field(
        default_factory=DecisionTransformerConfig
    )
    meta_learning: MetaLearningConfig = field(default_factory=MetaLearningConfig)
    multi_agent: MultiAgentConfig = field(default_factory=MultiAgentConfig)
    offline_rl_enabled: bool = False


@dataclass
class FrameworkConfig:
    """Root config — sections mirror config/config.yaml's layout."""

    globals: GlobalsConfig = field(default_factory=GlobalsConfig)
    algorithms: AlgorithmsConfig = field(default_factory=AlgorithmsConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    hierarchical_rl: HierarchicalConfig = field(default_factory=HierarchicalConfig)
    exploration: ExplorationConfig = field(default_factory=ExplorationConfig)
    physics_informed: PhysicsInformedSection = field(
        default_factory=PhysicsInformedSection
    )
    mission_success: MissionSuccessSection = field(
        default_factory=MissionSuccessSection
    )
    reward_function: RewardSection = field(default_factory=RewardSection)
    curriculum: CurriculumConfig = field(default_factory=CurriculumConfig)
    safety: SafetyConfig = field(default_factory=SafetyConfig)
    stability: StabilitySection = field(default_factory=StabilitySection)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    env: EnvSection = field(default_factory=EnvSection)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)
    experimental: ExperimentalConfig = field(default_factory=ExperimentalConfig)

    @staticmethod
    def from_dict(data: dict[str, Any]) -> "FrameworkConfig":
        data = dict(data or {})
        stages = None
        cur = data.get("curriculum")
        if isinstance(cur, dict) and isinstance(cur.get("stages"), (list, dict)):
            raw = cur.pop("stages")
            if isinstance(raw, dict):  # reference uses stage_1..stage_5 keys
                raw = [raw[k] for k in sorted(raw)]
            stages = [_build(CurriculumStage, s, "curriculum.stages") for s in raw]
        cfg = _build(FrameworkConfig, data)
        if stages is not None:
            cfg.curriculum.stages = stages
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
