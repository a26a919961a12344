"""The Gymnasium envs of tvc_ai_torch against ``tvc_ai_tpu/env/wrappers.py`` (CPU).

Both packages' ``EnhancedRocketTVCEnv`` and ``RocketTVCEnv`` run reset plus
60 steps of the same seeded small actions, with DR and sensor noise both off
and on. The reference's key chain is replayed: the reset's draws come from
the key ``reset(seed=...)`` splits off (handed to the port through
``reset(options={"reset_draws": ...})``) and each step's IMU noise from the
key the reference's state carries (handed through the ``step_draws`` hook).
The enhanced env's ICM is carried across with ``convert``. Bars: obs and the
info's float fields 5e-5 / 5e-4, reward and reward components 1e-3,
``intrinsic_reward`` 1e-5, the flags, phase, step and info keys exact, the
episode's mass 1e-6. The port steps ``rocket_env.batched_step`` at N = 1
(K1's wrapper; its plain version on these CPU tensors) where the reference
steps the plain unbatched ``rocket_env.step``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, np_tree, step_obs_draws, to_torch
from tvc_ai_torch.convert import curiosity_state_from_numpy
from tvc_ai_torch.env import wrappers as t_wrappers
from tvc_ai_tpu.env import wrappers as j_wrappers

torch.set_num_threads(1)
STEPS, SEED, RESET_SEED = 60, 3, 11
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
FLOAT_INFO = ("altitude", "fuel_remaining", "tilt_angle_deg", "angular_velocity_mag")
EXACT_INFO = ("mission_phase", "mission_successful", "step", "crashed")


def make_pair(kind: str, randomized: bool):
    kwargs = dict(domain_randomization=randomized, sensor_noise=randomized, seed=SEED)
    if kind == "enhanced":
        j_env = j_wrappers.EnhancedRocketTVCEnv(**kwargs)
        t_env = t_wrappers.EnhancedRocketTVCEnv(**kwargs, device="cpu")
        t_env._icm = curiosity_state_from_numpy(np_tree(j_env._icm), t_env._icm_cfg, "cpu")
    else:
        j_env = j_wrappers.RocketTVCEnv(**kwargs)
        t_env = t_wrappers.RocketTVCEnv(**kwargs, device="cpu")
    return j_env, t_env


def assert_info_close(got: dict, want: dict, at: str) -> None:
    assert got.keys() == want.keys(), at
    np.testing.assert_allclose(got["position"], want["position"], err_msg=at, **OBS)
    for k in FLOAT_INFO:
        if k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{at} {k}", **OBS)
    for k in EXACT_INFO:
        if k in want:
            assert got[k] == want[k], (at, k)
    np.testing.assert_allclose(got["current_mass"], want["current_mass"], atol=1e-6, rtol=1e-6)
    if "reward_components" in want:
        assert got["reward_components"].keys() == want["reward_components"].keys()
        for k, v in want["reward_components"].items():
            np.testing.assert_allclose(got["reward_components"][k], v, err_msg=f"{at} {k}",
                                       **REWARD)
    if "intrinsic_reward" in want:
        np.testing.assert_allclose(got["intrinsic_reward"], want["intrinsic_reward"],
                                   atol=1e-5, rtol=1e-5, err_msg=at)


@pytest.mark.parametrize("randomized", [False, True], ids=["plain", "dr_noise"])
@pytest.mark.parametrize("kind", ["enhanced", "legacy"])
def test_gym_env_matches_jax(kind, randomized):
    j_env, t_env = make_pair(kind, randomized)
    chain = KeyChain(j_env._params)
    sub = jax.random.split(jax.random.PRNGKey(RESET_SEED))[1]   # reset(seed=..) re-keys, splits
    j_obs, j_info = j_env.reset(seed=RESET_SEED)
    t_obs, t_info = t_env.reset(seed=RESET_SEED, options={"reset_draws": chain.reset(sub[None])})
    assert t_obs.dtype == np.float32 and t_obs.shape == j_obs.shape
    np.testing.assert_allclose(t_obs, j_obs, **OBS)
    assert_info_close(t_info, j_info, "reset")

    def step_draws():
        _, d = step_obs_draws(j_env._state.key, j_env._params)
        return (to_torch(d["n_imu"]) if "n_imu" in d else None, None)

    t_env.step_draws = step_draws
    rng = np.random.default_rng(SEED)
    ends = 0   # steps flagged terminated or truncated (the envs step on past the end)
    for t in range(STEPS):
        action = rng.uniform(-0.15, 0.15, size=2).astype(np.float32)
        t_out = t_env.step(action)        # reads the key the reference carries into this step
        j_out = j_env.step(action)
        at = f"{kind} step {t}"
        np.testing.assert_allclose(t_out[0], j_out[0], err_msg=at, **OBS)
        np.testing.assert_allclose(t_out[1], j_out[1], err_msg=at, **REWARD)
        assert type(t_out[1]) is float and t_out[2:4] == j_out[2:4], at
        assert_info_close(t_out[4], j_out[4], at)
        ends += t_out[2] or t_out[3]
    assert (ends > 0) == randomized   # with DR the episode ends inside the 60 steps
    assert t_env.current_mass == pytest.approx(j_env.current_mass, rel=1e-6)
    if kind == "enhanced":
        assert t_out[4]["intrinsic_reward"] > 0.0
    t_env.close()
    assert t_env.current_mass == pytest.approx(float(j_env._params.rocket.mass), rel=1e-6)


def test_one_read_per_call():
    """Each reset and each step copies from the device once."""
    env = t_wrappers.EnhancedRocketTVCEnv(domain_randomization=True, sensor_noise=True,
                                          device="cpu")
    env.reset(seed=0)
    for _ in range(5):
        env.step(np.zeros(2, np.float32))
    assert env.core.reads == 6
