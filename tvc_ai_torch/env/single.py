"""One environment at a time: the core under the Gymnasium classes and the
single-env diagnostics.

``SingleEnv`` holds one env as an N = 1 batch on an explicit device with its
own ``torch.Generator``. ``reset`` goes through ``rocket_env.reset`` and
``step`` through ``rocket_env.batched_step``, so on CUDA tensors the physics
is K1 at N = 1 (the reference's gym env steps the plain unbatched
``rocket_env.step``). Each call ends in ONE device-to-host read: the
observation, the reward, the flags, the reference's ``_info`` fields
(``tvc_ai_tpu/env/wrappers.py:126-147``) and whatever the caller's ``extra``
hook asks for are packed into one float32 tensor and copied at once.

Randomness is explicit, as everywhere in the port: ``reset`` takes a
one-env ``ResetDraws`` and ``step`` the new observation's IMU noise and
sensor-dropout draw; each is drawn from the generator where not given.

``EnhancedRocketTVC`` and ``RocketTVC`` are the Gymnasium classes
(``tvc_ai_tpu/env/wrappers.py:107-308``) without gymnasium: the reference's
constructors, ``reset(seed=, options=)`` and ``step`` over a ``SingleEnv``,
the obs width (10 or the legacy 8), the enhanced env's curiosity bonus and
the ``step_draws`` hook. ``tvc_ai_torch.env.wrappers`` adds to each only
``gym.Env``, its spaces and ``metadata``, so a host without gymnasium flies
the same code.

``RocketConfig`` is the legacy physical configuration (the counterpart of
``tvc_ai_tpu/env/wrappers.py::RocketConfig``). It lives here, free of
gymnasium, because the evaluation suites build on it;
``tvc_ai_torch.env.wrappers`` re-exports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import (
    ACTION_DIM,
    OBS_DIM_LEGACY,
    PHASE_NAMES,
    EnvParams,
    EnvState,
    RandomizationConfig,
    StepOutput,
    as_float32,
)
from tvc_ai_torch.physics.types import RocketParams
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device
from tvc_ai_torch.utils.tree import tree_map


@dataclasses.dataclass
class RocketConfig:
    """Legacy physical configuration (mutable, like the original); the
    reference's defaults (mass 1.5 kg, CG offset 0.05 m)."""

    mass: float = 1.5                 # kg
    radius: float = 0.05              # m
    length: float = 1.0               # m
    thrust_mean: float = 35.0         # N
    burn_time: float = 20.0           # s (→ 0.001 fuel/step at 50 Hz)
    max_gimbal_angle: float = math.radians(18.0)
    mass_variation: float = 0.3       # ± fraction
    thrust_variation: float = 0.2     # σ fraction
    cg_offset_max: float = 0.05       # m
    wind_max: float = 3.0             # N
    sensor_noise_std: float = 0.02

    def to_env_params(
        self,
        *,
        domain_randomization: bool,
        sensor_noise: bool,
        max_episode_steps: int,
    ) -> EnvParams:
        dt = 0.02
        rocket = RocketParams(
            mass=self.mass,
            radius=self.radius,
            length=self.length,
            thrust=self.thrust_mean,
            max_gimbal=self.max_gimbal_angle,
            fuel_burn_rate=dt / self.burn_time,
        )
        rnd = RandomizationConfig(
            enabled=bool(domain_randomization),
            sensor_noise_enabled=bool(sensor_noise),
            mass_variation=self.mass_variation,
            thrust_variation=self.thrust_variation,
            cg_offset_max=self.cg_offset_max,
            wind_max=self.wind_max,
            sensor_noise_std=self.sensor_noise_std,
        )
        return as_float32(EnvParams(
            rocket=rocket, randomization=rnd, max_episode_steps=max_episode_steps
        ))


@dataclasses.dataclass
class SingleStep:
    """What one ``reset`` or ``step`` read back: the raw observation, the
    reward and flags (0 and False after a reset), the reference's info dict
    and the ``extra`` hook's values (numpy, each in its tensor's shape)."""

    obs: np.ndarray
    reward: float
    terminated: bool
    truncated: bool
    info: dict[str, Any]
    extra: dict[str, np.ndarray]


Extra = Callable[[EnvState, StepOutput | None], dict[str, torch.Tensor]]


class SingleEnv:
    """One env as an N = 1 batch on ``device`` (CUDA by default)."""

    def __init__(self, params: EnvParams, device: str | torch.device = DEFAULT_DEVICE,
                 seed: int = 0):
        self.params = params
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state: EnvState | None = None
        self.obs: torch.Tensor | None = None   # (1, obs_dim) on the device
        self.reads = 0                         # device-to-host reads so far
        self._mass: float | None = None        # the episode's mass, from the last read

    def reset(self, draws: ResetDraws | None = None, extra: Extra | None = None) -> SingleStep:
        """A fresh episode from ``draws`` (one env's ``ResetDraws``, on any
        device) or from the generator."""
        if draws is not None:
            draws = tree_map(lambda t: t.to(self.device), draws)
        self.state, self.obs = rocket_env.reset(self.params, 1, self.device,
                                                generator=self.generator, draws=draws)
        return self._read(None, extra)

    def step(self, action, n_imu=None, u_drop=None, extra: Extra | None = None) -> SingleStep:
        """One step, then its one packed read: ``action`` (2,) or (1, 2);
        ``n_imu`` (7,) and ``u_drop`` () as the config needs them, else drawn."""
        if self.state is None:
            raise RuntimeError("reset the env before stepping it")
        act = torch.as_tensor(action, dtype=torch.float32, device=self.device).reshape(1, -1)
        if n_imu is not None:
            n_imu = torch.as_tensor(n_imu, dtype=torch.float32, device=self.device).reshape(1, 7)
        if u_drop is not None:
            u_drop = torch.as_tensor(u_drop, dtype=torch.float32, device=self.device).reshape(1)
        self.state, out = rocket_env.batched_step(self.state, act, self.params,
                                                  generator=self.generator, n_imu=n_imu,
                                                  u_drop=u_drop)
        self.obs = out.obs
        return self._read(out, extra)

    def replace_dr(self, **fields) -> None:
        """Overwrite fields of the episode's domain draw (e.g. ``cg_offset``)
        with fresh contiguous (1, k) tensors: K1 takes only dense,
        16-byte-aligned rows, never a view."""
        new = {k: torch.tensor(np.asarray(v, np.float32).reshape(1, -1), device=self.device)
               .reshape(getattr(self.state.dr, k).shape) for k, v in fields.items()}
        self.state = dataclasses.replace(self.state, dr=dataclasses.replace(self.state.dr, **new))

    def close(self) -> None:
        """Drop the episode (``current_mass`` is the nominal mass again)."""
        self.state, self.obs, self._mass = None, None, None

    @property
    def current_mass(self) -> float:
        """The episode's (randomized) mass; the nominal mass before a reset."""
        return float(self.params.rocket.mass) if self._mass is None else self._mass

    def _read(self, out: StepOutput | None, extra: Extra | None) -> SingleStep:
        s = self.state
        parts = {"obs": self.obs, "pos": s.body.pos, "fuel": s.fuel, "phase": s.phase,
                 "success": s.mission_success, "step": s.step_count, "mass": s.dr.mass}
        if out is not None:
            parts.update(reward=out.reward, terminated=out.terminated,
                         truncated=out.truncated, tilt=out.tilt,
                         ang=out.angular_velocity_mag, crashed=out.crashed)
            parts.update({f"rc.{k}": v for k, v in out.reward_components.items()})
        extras = extra(s, out) if extra is not None else {}
        parts.update({f"x.{k}": v for k, v in extras.items()})
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts.values()]).cpu().numpy()
        self.reads += 1
        host, at = {}, 0
        for name, t in parts.items():
            host[name] = flat[at:at + t.numel()]
            at += t.numel()
        pos = host["pos"]
        self._mass = float(host["mass"][0])
        info = {
            "position": tuple(float(x) for x in pos),
            "altitude": float(pos[2]),
            "fuel_remaining": float(host["fuel"][0]),
            "mission_phase": PHASE_NAMES[int(host["phase"][0])],
            "mission_successful": bool(host["success"][0]),
            "step": int(host["step"][0]),
            "current_mass": self._mass,
        }
        if out is not None:
            info.update(
                tilt_angle_deg=float(np.degrees(float(host["tilt"][0]))),
                angular_velocity_mag=float(host["ang"][0]),
                reward_components={k: float(host[f"rc.{k}"][0])
                                   for k in out.reward_components},
                crashed=bool(host["crashed"][0]),
            )
        return SingleStep(
            obs=host["obs"].copy(),
            reward=float(host["reward"][0]) if out is not None else 0.0,
            terminated=bool(host["terminated"][0]) if out is not None else False,
            truncated=bool(host["truncated"][0]) if out is not None else False,
            info=info,
            extra={k: host[f"x.{k}"].reshape(tuple(v.shape)) for k, v in extras.items()},
        )


class EnvShell:
    """The gym envs' reset / step over a ``SingleEnv``, free of gymnasium.

    ``reset(seed=...)`` reseeds the generator (the reference re-keys);
    ``reset(options={"reset_draws": ResetDraws})`` replays given reset
    draws; ``step_draws`` (a callable returning the step's ``(n_imu,
    u_drop)``, either None to draw it) replays the step's IMU and dropout
    draws. Subclasses set ``obs_low`` / ``obs_high`` and may shape the
    reward through ``_extra_fn`` / ``_augment_reward``.
    """

    obs_low: np.ndarray
    obs_high: np.ndarray
    render_mode: Optional[str] = None

    def __init__(self, params: EnvParams, seed: int = 0,
                 device: str | torch.device = DEFAULT_DEVICE):
        self._params = params
        self._core = SingleEnv(params, device, seed)
        self.max_episode_steps = params.max_episode_steps
        self.step_draws: Optional[Callable[[], tuple]] = None

    @property
    def core(self) -> SingleEnv:
        return self._core

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._core.generator.manual_seed(seed)
        read = self._core.reset((options or {}).get("reset_draws"))
        return self._project_obs(read.obs), read.info

    def step(self, action):
        """``action`` (2,): numpy, a list or a tensor on any device."""
        n_imu, u_drop = self.step_draws() if self.step_draws is not None else (None, None)
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=self._core.device).reshape(1, ACTION_DIM)
        prev_obs = self._core.obs
        read = self._core.step(action, n_imu, u_drop, extra=self._extra_fn(prev_obs, action))
        reward, info = self._augment_reward(read.reward, read.extra, read.info)
        return self._project_obs(read.obs), reward, read.terminated, read.truncated, info

    def _extra_fn(self, prev_obs: torch.Tensor, action: torch.Tensor) -> Extra | None:
        """Hook: the device values a subclass needs in the step's read."""
        return None

    def _augment_reward(self, reward: float, extra: dict, info: dict):
        """Hook for subclass reward shaping (e.g. curiosity bonus)."""
        return reward, info

    def _project_obs(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def render(self):  # pragma: no cover - no GUI in this build
        return None

    def close(self):
        self._core.close()

    @property
    def current_mass(self) -> float:
        """Randomized episode mass (legacy contract, tests/test_environment.py:115)."""
        return self._core.current_mass


class EnhancedRocketTVC(EnvShell):
    """Current-generation env: 10-D obs, mission phases, multi-objective reward.

    The reference's constructor signature plus ``device``. ``enable_curiosity``
    adds the ICM's intrinsic bonus (forward-model MSE x 0.01 on obs[:8]) to the
    step reward and to ``info["intrinsic_reward"]``; its ICM is seeded
    ``seed ^ 0x1C4`` and never trained here. ``enable_hierarchical`` and
    ``enable_physics_informed`` are stored without effect, as in the reference.
    """

    obs_low = np.array([-1, -1, -1, -1, -10, -10, -10, 0, 0, 0], dtype=np.float32)
    obs_high = np.array([1, 1, 1, 1, 10, 10, 10, 1, 1, 1], dtype=np.float32)

    def __init__(
        self,
        config: Optional[dict] = None,
        max_episode_steps: int = 1000,
        render_mode: Optional[str] = None,
        enable_hierarchical: bool = True,
        enable_curiosity: bool = True,
        enable_physics_informed: bool = True,
        debug: bool = False,
        domain_randomization: bool = False,
        sensor_noise: bool = False,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.config = config or {}
        self.render_mode = render_mode
        self.enable_hierarchical = enable_hierarchical
        self.enable_curiosity = enable_curiosity
        self.enable_physics_informed = enable_physics_informed
        self.debug = debug
        self.domain_randomization = domain_randomization
        rc = RocketConfig(mass=2.0)  # enhanced-gen nominal mass
        params = rc.to_env_params(
            domain_randomization=domain_randomization,
            sensor_noise=sensor_noise,
            max_episode_steps=max_episode_steps,
        )
        super().__init__(params, seed=seed, device=device)
        self._icm = None
        if enable_curiosity:
            from tvc_ai_torch.models import curiosity as icm_mod

            self._icm_mod = icm_mod
            self._icm_cfg = icm_mod.CuriosityConfig()
            self._icm = icm_mod.init(self._icm_cfg, self._core.device, seed=seed ^ 0x1C4)

    def _extra_fn(self, prev_obs: torch.Tensor, action: torch.Tensor) -> Extra | None:
        if self._icm is None:
            return None
        return lambda state, out: {"intrinsic": self._icm_mod.intrinsic_reward(
            self._icm, prev_obs, action, out.obs, self._icm_cfg)}

    def _augment_reward(self, reward: float, extra: dict, info: dict):
        if self._icm is not None:
            intrinsic = float(extra["intrinsic"][0])
            info["intrinsic_reward"] = intrinsic
            reward = reward + intrinsic
        return reward, info


class RocketTVC(EnvShell):
    """Legacy-generation env: 8-D obs [quat, ω, fuel]."""

    obs_low = np.array([-1, -1, -1, -1, -10, -10, -10, 0], dtype=np.float32)
    obs_high = np.array([1, 1, 1, 1, 10, 10, 10, 1], dtype=np.float32)

    def __init__(
        self,
        config: Optional[RocketConfig] = None,
        domain_randomization: bool = False,
        sensor_noise: bool = False,
        max_episode_steps: int = 1000,
        debug: bool = False,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.config = config or RocketConfig()
        self.domain_randomization = domain_randomization
        self.sensor_noise = sensor_noise
        self.debug = debug
        params = self.config.to_env_params(
            domain_randomization=domain_randomization,
            sensor_noise=sensor_noise,
            max_episode_steps=max_episode_steps,
        )
        super().__init__(params, seed=seed, device=device)

    def _project_obs(self, obs: np.ndarray) -> np.ndarray:
        return obs[:OBS_DIM_LEGACY]
