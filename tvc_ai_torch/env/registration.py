"""Gymnasium registration and the environment factories.

Counterpart of ``tvc_ai_tpu/env/registration.py``: three registered ids and
four factories, which accept the UNION of both API generations' kwargs (the
current generation's ``config``, ``enable_hierarchical``,
``enable_curiosity``, ``enable_physics_informed``; the legacy generation's
``domain_randomization``, ``sensor_noise``, ``max_episode_steps``,
``debug``), plus ``device`` (CUDA by default).

The ids live under the ``tvc_ai_torch`` namespace
(``tvc_ai_torch/EnhancedRocketTVC-v0``, ``-Eval-v0``, ``-Debug-v0``), so the
reference's bare ids keep naming the reference's env in a process that
imports both packages.
"""

from __future__ import annotations

import torch
from gymnasium.envs.registration import register, registry

from tvc_ai_torch.env.wrappers import EnhancedRocketTVCEnv, RocketConfig, RocketTVCEnv
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE

NAMESPACE = "tvc_ai_torch"
ENV_IDS = {
    f"{NAMESPACE}/EnhancedRocketTVC-v0": {},
    f"{NAMESPACE}/EnhancedRocketTVC-Eval-v0": {"domain_randomization": False},
    f"{NAMESPACE}/EnhancedRocketTVC-Debug-v0": {"debug": True, "max_episode_steps": 200},
}


def register_envs() -> None:
    """Register the namespaced ids (idempotent)."""
    for env_id, kwargs in ENV_IDS.items():
        if env_id not in registry:
            register(
                id=env_id,
                entry_point="tvc_ai_torch.env.wrappers:EnhancedRocketTVCEnv",
                kwargs=kwargs,
            )


def make_training_env(
    config=None,
    domain_randomization: bool = True,
    sensor_noise: bool = True,
    max_episode_steps: int = 1000,
    debug: bool = False,
    enable_hierarchical: bool = True,
    enable_curiosity: bool = True,
    enable_physics_informed: bool = True,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> EnhancedRocketTVCEnv:
    """Training env: randomization and sensor noise on by default."""
    return EnhancedRocketTVCEnv(
        config=config if isinstance(config, dict) else None,
        max_episode_steps=max_episode_steps,
        enable_hierarchical=enable_hierarchical,
        enable_curiosity=enable_curiosity,
        enable_physics_informed=enable_physics_informed,
        debug=debug,
        domain_randomization=domain_randomization,
        sensor_noise=sensor_noise,
        seed=seed,
        device=device,
    )


def make_evaluation_env(
    config=None,
    domain_randomization: bool = False,
    sensor_noise: bool = False,
    max_episode_steps: int = 1000,
    debug: bool = False,
    enable_hierarchical: bool = True,
    enable_curiosity: bool = False,
    enable_physics_informed: bool = True,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> EnhancedRocketTVCEnv:
    """Evaluation env: deterministic physics by default."""
    return EnhancedRocketTVCEnv(
        config=config if isinstance(config, dict) else None,
        max_episode_steps=max_episode_steps,
        enable_hierarchical=enable_hierarchical,
        enable_curiosity=enable_curiosity,
        enable_physics_informed=enable_physics_informed,
        debug=debug,
        domain_randomization=domain_randomization,
        sensor_noise=sensor_noise,
        seed=seed,
        device=device,
    )


def make_debug_env(max_episode_steps: int = 200, seed: int = 0, **kwargs):
    return make_evaluation_env(
        max_episode_steps=max_episode_steps, debug=True, seed=seed, **kwargs
    )


def make_legacy_env(
    config: RocketConfig | None = None,
    domain_randomization: bool = False,
    sensor_noise: bool = False,
    max_episode_steps: int = 1000,
    debug: bool = False,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> RocketTVCEnv:
    """Legacy 8-D-obs env factory (for the evaluate/export/HPO contract)."""
    return RocketTVCEnv(
        config=config,
        domain_randomization=domain_randomization,
        sensor_noise=sensor_noise,
        max_episode_steps=max_episode_steps,
        debug=debug,
        seed=seed,
        device=device,
    )
