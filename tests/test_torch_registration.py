"""The Gymnasium surface of tvc_ai_torch: the reference's own tests of it
(``tests/test_legacy_api.py:49-120``, ``tests/test_integration.py:17-112,
141-150``, ``tests/test_config_wiring.py:259-276``) re-run with the port's
classes on the CPU, and the registry: the port registers its ids under the
``tvc_ai_torch`` namespace and leaves the reference's bare ids alone.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch

from tvc_ai_torch import env as t_env_pkg
from tvc_ai_torch.agents.legacy import SACAgent, SACConfig
from tvc_ai_torch.env import registration
from tvc_ai_torch.env.wrappers import EnhancedRocketTVCEnv, RocketConfig, RocketTVCEnv

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
BARE_IDS = ("EnhancedRocketTVC-v0", "EnhancedRocketTVC-Eval-v0", "EnhancedRocketTVC-Debug-v0")


@pytest.fixture
def env():
    e = RocketTVCEnv(device="cpu")
    yield e
    e.close()


def test_legacy_observation_space(env):
    assert env.observation_space.shape == (8,)
    assert env.action_space.shape == (2,)
    assert np.all(env.action_space.low == -1.0)
    assert np.all(env.action_space.high == 1.0)


def test_legacy_reset(env):
    obs, info = env.reset()
    assert obs.shape == (8,)
    assert np.all(np.isfinite(obs))
    assert np.isclose(np.linalg.norm(obs[:4]), 1.0, atol=1e-3)
    assert "position" in info and "altitude" in info


def test_legacy_step(env):
    env.reset()
    next_obs, reward, terminated, truncated, info = env.step(np.zeros(2))
    assert next_obs.shape == (8,)
    assert np.all(np.isfinite(next_obs))
    assert isinstance(reward, float)
    assert isinstance(terminated, bool)
    assert isinstance(truncated, bool)
    assert isinstance(info, dict)


def test_legacy_domain_randomization_varies_mass():
    env1 = RocketTVCEnv(domain_randomization=True, seed=1, device="cpu")
    env2 = RocketTVCEnv(domain_randomization=True, seed=2, device="cpu")
    masses1, masses2 = [], []
    for _ in range(5):
        env1.reset()
        env2.reset()
        masses1.append(env1.current_mass)
        masses2.append(env2.current_mass)
    assert np.std(masses1) > 0 or np.std(masses2) > 0
    env1.close()
    env2.close()


def test_rocket_config_defaults():
    config = RocketConfig()
    assert config.mass > 0
    assert config.radius > 0
    assert config.length > 0
    assert config.thrust_mean > 0
    assert config.burn_time > 0
    assert config.max_gimbal_angle > 0


def test_rocket_config_modification():
    config = RocketConfig()
    original_mass = config.mass
    config.mass = 2.0
    assert config.mass != original_mass
    assert config.mass == 2.0


def test_factories():
    env = registration.make_training_env(device="cpu")
    assert hasattr(env, "domain_randomization")
    env.close()
    env = registration.make_evaluation_env(device="cpu")
    assert env is not None
    env.close()
    env = registration.make_training_env(
        domain_randomization=False, sensor_noise=False, max_episode_steps=500, device="cpu"
    )
    assert env.max_episode_steps == 500
    env.close()
    debug = registration.make_debug_env(device="cpu")
    assert debug.debug and debug.max_episode_steps == 200 and debug._icm is None
    legacy = registration.make_legacy_env(domain_randomization=True, device="cpu")
    assert isinstance(legacy, RocketTVCEnv) and legacy.observation_space.shape == (8,)


def simple_training_run(num_episodes=3, max_steps=60, seed=0):
    """Mini train loop via the legacy single-env API."""
    env = RocketTVCEnv(max_episode_steps=max_steps, seed=seed, device="cpu")
    agent = SACAgent(
        obs_dim=env.observation_space.shape[0],
        action_dim=env.action_space.shape[0],
        config=SACConfig(
            hidden_dims=[32, 32], batch_size=16, buffer_size=4096,
            learning_starts=32,
        ),
        seed=seed,
        device="cpu",
    )
    episode_rewards = []
    for _ in range(num_episodes):
        obs, _ = env.reset()
        total = 0.0
        for _ in range(max_steps):
            action = agent.select_action(obs)
            next_obs, reward, terminated, truncated, _ = env.step(action)
            agent.store_transition(
                obs, action, reward, next_obs, terminated or truncated
            )
            agent.train()
            total += reward
            obs = next_obs
            if terminated or truncated:
                break
        episode_rewards.append(total)
    env.close()
    return agent, episode_rewards


def test_mini_training_completes():
    agent, rewards = simple_training_run()
    assert len(rewards) == 3
    assert all(np.isfinite(r) for r in rewards)
    assert agent.total_steps > 0


def test_seeded_env_consistency():
    """Same seed → identical trajectories; without DR the reset is
    deterministic, and a randomized env parts across seeds."""
    def rollout(seed, dr=False):
        env = RocketTVCEnv(seed=seed, domain_randomization=dr, device="cpu")
        obs, _ = env.reset(seed=seed)
        traj = [obs]
        for _ in range(10):
            obs, r, term, trunc, _ = env.step(np.array([0.1, -0.1]))
            traj.append(obs)
            if term or trunc:
                break
        env.close()
        return np.stack(traj)

    t1, t2 = rollout(123), rollout(123)
    np.testing.assert_allclose(t1, t2, atol=1e-6)
    r1, r3 = rollout(123, dr=True), rollout(456, dr=True)
    assert r3.shape != r1.shape or not np.allclose(r1, r3)


def test_env_observation_sanity_bounds():
    env = RocketTVCEnv(seed=3, device="cpu")
    env.reset()
    for _ in range(30):
        obs, r, term, trunc, info = env.step(
            np.random.default_rng(0).uniform(-1, 1, 2).astype(np.float32)
        )
        assert np.linalg.norm(obs[:4]) == pytest.approx(1.0, abs=1e-3)
        assert np.all(np.abs(obs[4:7]) < 100.0)
        assert 0.0 <= obs[7] <= 1.0
        if term or trunc:
            break
    env.close()


def test_gym_registration():
    t_env_pkg.register_envs()
    t_env_pkg.register_envs()  # idempotent
    for env_id in registration.ENV_IDS:
        assert gym.spec(env_id).entry_point == "tvc_ai_torch.env.wrappers:EnhancedRocketTVCEnv"
    env = gym.make("tvc_ai_torch/EnhancedRocketTVC-v0", device="cpu")
    obs, info = env.reset()
    assert obs.shape == (10,)
    obs, r, term, trunc, info = env.step(np.zeros(2, np.float32))
    assert np.isfinite(r)
    env.close()
    debug = gym.make("tvc_ai_torch/EnhancedRocketTVC-Debug-v0", device="cpu")
    assert debug.unwrapped.debug and debug.unwrapped.max_episode_steps == 200
    debug.close()


def test_register_envs_leaves_the_bare_ids_alone():
    """In a process that registers only the port's ids the reference's bare
    ids stay unregistered; where the reference registered them first, they
    keep naming the reference's env."""
    code = (
        "from gymnasium.envs.registration import registry\n"
        "from tvc_ai_torch.env import register_envs\n"
        "register_envs()\n"
        f"assert not [i for i in {BARE_IDS!r} if i in registry]\n"
        "assert 'tvc_ai_torch/EnhancedRocketTVC-v0' in registry\n"
        "import sys\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'tvc_ai_tpu')]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from tvc_ai_tpu.env import register_envs as j_register_envs

    j_register_envs()
    before = {i: gym.spec(i).entry_point for i in BARE_IDS}
    t_env_pkg.register_envs()
    assert {i: gym.spec(i).entry_point for i in BARE_IDS} == before
    assert all(v.startswith("tvc_ai_tpu.") for v in before.values())


def test_enhanced_env_curiosity_flag_honored():
    """enable_curiosity adds the in-env intrinsic bonus; its ICM is seeded
    ``seed ^ 0x1C4``."""
    env_on = EnhancedRocketTVCEnv(enable_curiosity=True, seed=3, device="cpu")
    env_off = EnhancedRocketTVCEnv(enable_curiosity=False, seed=3, device="cpu")
    env_on.reset(seed=5)
    env_off.reset(seed=5)
    a = np.array([0.1, -0.1], np.float32)
    _, r_on, _, _, info_on = env_on.step(a)
    _, r_off, _, _, info_off = env_off.step(a)
    assert "intrinsic_reward" in info_on
    assert "intrinsic_reward" not in info_off
    assert r_on == pytest.approx(r_off + info_on["intrinsic_reward"], rel=1e-5)
    assert info_on["intrinsic_reward"] > 0.0
    from tvc_ai_torch.models import curiosity

    fresh = curiosity.init(curiosity.CuriosityConfig(), "cpu", seed=3 ^ 0x1C4)
    for a_, b_ in zip(fresh.nets.parameters(), env_on._icm.nets.parameters()):
        assert torch.equal(a_, b_)

