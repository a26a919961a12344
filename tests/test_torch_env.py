"""Environment of tvc_ai_torch against the JAX reference (CPU).

Both packages start from the same reset (the port is fed the draws JAX's key
chain produced, see ``test_torch_parity_utils``) and then run free, 16 steps
with ``max_episode_steps=8`` so truncation autoresets fire, under full domain
randomization with sensor noise. Bars as the JAX package's own full-path
test (``tests/test_pallas_step.py``): obs and next_policy_obs 5e-5 / 5e-4,
reward 1e-3 / 1e-3, terminated and truncated exactly equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, assert_state_close, np_tree, run_env_parity
from tvc_ai_torch.convert import env_params_from_numpy, env_state_from_numpy
from tvc_ai_torch.env import mission as t_mission
from tvc_ai_torch.env import reward as t_reward
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.env import types as t_types
from tvc_ai_torch.ops.step_kernel import step_kernel
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_tpu.env import mission as j_mission
from tvc_ai_tpu.env import reward as j_reward
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig, RewardConfig, SuccessConfig

torch.set_num_threads(1)
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
N = 64
STEPS = 16

CASES = {
    "dr_noise": dict(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True)),
    "obs_channels": dict(
        randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True,
                                          init_tilt_max=jnp.float32(0.3),
                                          init_omega_max=jnp.float32(0.5)),
        trim_obs_enabled=True, trim_obs_integral=True, drift_obs_enabled=True,
        action_obs_enabled=True,
    ),
}


def run_parity(case: str, batched: bool, seed: int) -> None:
    counts = run_env_parity(EnvParams(max_episode_steps=8, **CASES[case]), batched, seed,
                            n=N, steps=STEPS, what=case)
    assert counts["dones"] >= N  # autoresets fired (truncation at step 8 at the latest)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_step_autoreset_matches_jax(case):
    """The production route (K1's wrapper) vs the JAX Pallas route."""
    run_parity(case, batched=True, seed=21)


def test_step_autoreset_matches_jax():
    """The plain route vs ``vmap(step_autoreset)``."""
    run_parity("dr_noise", batched=False, seed=22)


def test_env_state_from_numpy_resumes_jax_state():
    """A JAX state carried across steps identically from there on."""
    jp = EnvParams(max_episode_steps=8, **CASES["dr_noise"])
    tp = env_params_from_numpy(jp)
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    j_state, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    actions = jnp.full((16, 2), 0.3)
    j_step = jax.jit(jax.vmap(lambda s, a: j_env.step_autoreset(s, a, jp)))
    j_state, _, _ = j_step(j_state, actions)
    t_state = env_state_from_numpy(np_tree(j_state), device="cpu")
    assert_state_close(t_state, j_state, atol=0.0, rtol=0.0)
    d = KeyChain(jp).step(j_state.key)
    j_state, j_out, _ = j_step(j_state, actions)
    t_state, t_out, _ = t_env.step_autoreset(
        t_state, torch.full((16, 2), 0.3), tp, n_imu=d.n_imu, reset_draws=d.reset
    )
    np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), **OBS)


def test_batched_step_autoreset_rejects_extra_physics():
    """K1 rejects an opt-in physics term; ``batched_step_autoreset`` routes
    such a config to the plain integrator instead."""
    tp = t_types.EnvParams(rocket=t_types.RocketParams(magnus_effect=True))
    assert not t_env.pallas_physics_ok(tp)
    g = torch.Generator().manual_seed(0)
    states, _ = t_env.reset(tp, 4, device="cpu", generator=g)
    ctrl = ThrustControl(gimbal=torch.zeros(4, 2), thrust_active=torch.ones(4, dtype=torch.bool))
    dr = states.dr
    with pytest.raises(ValueError):
        step_kernel(states.body, ctrl, tp.rocket, dr.mass, dr.thrust_scale, dr.cg_offset, dr.wind)
    _, out, _ = t_env.batched_step_autoreset(states, torch.zeros(4, 2), tp, generator=g)
    assert out.obs.shape == (4, 10)


# ------------------------------------------------------------- env parts


def test_mission_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    phase = rng.integers(0, 7, size=n).astype(np.int32)
    alt = rng.uniform(0.0, 6.0, size=n).astype(np.float32)
    tilt = rng.uniform(0.0, 0.2, size=n).astype(np.float32)
    fuel = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    ang = rng.uniform(0.0, 0.2, size=n).astype(np.float32)
    count = rng.integers(90, 110, size=n).astype(np.int32)
    hv = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    vv = rng.uniform(0.0, 3.0, size=n).astype(np.float32)
    js, ts = SuccessConfig(), t_types.SuccessConfig()
    T = torch.from_numpy
    for a, b in zip(
        j_mission.update_phase(phase, alt, tilt, fuel, ang, js),
        t_mission.update_phase(T(phase), T(alt), T(tilt), T(fuel), T(ang), ts),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(
        j_mission.update_success_window(count, alt, tilt, ang, hv, vv, js),
        t_mission.update_success_window(T(count), T(alt), T(tilt), T(ang), T(hv), T(vv), ts),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_reward_matches_jax():
    """Random inputs covering every branch, including the variance penalty
    (window values large enough that the masked variance exceeds 1e4)."""
    rng = np.random.default_rng(2)
    n, w = 512, 10
    kw = dict(
        altitude=rng.uniform(-0.5, 25.0, size=n).astype(np.float32),
        tilt=rng.uniform(0.0, 1.0, size=n).astype(np.float32),
        angular_velocity_mag=rng.uniform(0.0, 0.5, size=n).astype(np.float32),
        fuel=rng.uniform(0.0, 1.0, size=n).astype(np.float32),
        crashed=rng.uniform(size=n) < 0.2,
        mission_successful=rng.uniform(size=n) < 0.2,
        phase=rng.integers(0, 7, size=n).astype(np.int32),
        action=rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32),
        prev_action=rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32),
        has_prev_action=rng.uniform(size=n) < 0.8,
        reward_window=(rng.normal(size=(n, w)) * rng.choice([1.0, 300.0], size=(n, 1)))
        .astype(np.float32),
        reward_window_len=rng.integers(0, 20, size=n).astype(np.int32),
    )
    j = j_reward.compute_reward(RewardConfig(), **{k: jnp.asarray(v) for k, v in kw.items()})
    t = t_reward.compute_reward(t_types.RewardConfig(),
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **REWARD)
    assert set(j[3]) == set(t[3])
    for name in j[3]:
        np.testing.assert_allclose(t[3][name].numpy(), np.asarray(j[3][name]),
                                   err_msg=name, **REWARD)
    assert (np.asarray(j[3]["anti_hacking"]) < -1.0).any()  # the penalty branch ran
