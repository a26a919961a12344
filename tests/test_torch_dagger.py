"""DAgger distillation (``tvc_ai_torch/training/dagger.py``) against the JAX
package (CPU), every draw replayed from the JAX key chain: the β mixing
draws (``bernoulli`` is ``uniform < β``), each step's env draws (the env
keys recorded as the JAX scan runs), the CEM's noise, the recycling draw
(``choice`` by weight) and the minibatch rows.

- The scheduled-teacher iteration three times (β 1, 0.6, 0.36) on 8 envs of
  4-step episodes (autoresets fire), history 2, a ring of two iterations'
  rows (the third write wraps): the ring's rows (views and labels) at the env bars, ``ptr`` and
  ``size`` exact, the student's parameters at 1e-5 after each iteration's
  3 Adam minibatches, the losses at 1e-5, the episode counts exact.
- The CEM-teacher iteration once on 4 envs from tilted starts on the
  nominal plant (the CEM, 150-step scoring, solves them) over a 40-step
  rollout at β 0.5 (a student pushing near full gimbal ends some episodes,
  after which the rows weigh 0): the same holds, plus ``data_w`` exact and the
  teacher-solved share.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity_utils import (
    KeyChain,
    cem_draws,
    jax_schedule,
    recording_batched_keys,
    sample_idx,
)
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import actor_from_flax, env_params_from_numpy
from tvc_ai_torch.training import cem as t_cem
from tvc_ai_torch.training import dagger as t_dagger
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env.types import obs_dim as j_obs_dim
from tvc_ai_tpu.eval.evaluate import _suite_env_params as j_suite
from tvc_ai_tpu.training import cem as j_cem
from tvc_ai_tpu.training import dagger as j_dagger
from tvc_ai_tpu.training import demos as j_demos

torch.set_num_threads(1)
OBS = dict(atol=5e-5, rtol=5e-4)
PARAM = dict(atol=1e-5, rtol=1e-5)
OBS_OVERRIDES = dict(drift_obs_enabled=True, action_obs_enabled=True)
HIDDEN = (16, 16)
LR = 3e-4
BETA = 0.5   # the CEM variant's: the student drives half the steps and crashes


@pytest.fixture(scope="module")
def sched():
    return t_demos.design_lqr_schedule(env_params_from_numpy(j_suite("robustness")), 3, 3,
                                       verify_rollouts=2, verify_horizon=250, device="cpu")


def students(view_dim: int, push: float = 0.0):
    """The JAX student's config and params and the port's copy; ``push``
    biases the mean head (tanh(2) ≈ 0.96 of full gimbal: a student that
    tips the vehicle over)."""
    cfg = j_sac.SACConfig(hidden_dims=HIDDEN)
    params = j_sac.init(jax.random.PRNGKey(1), view_dim, 2, cfg).actor_params
    if push:
        params = jax.tree.map(lambda x: x, params)
        head = params["params"]["mean_head"]
        params["params"]["mean_head"] = {**head, "bias": jnp.full_like(head["bias"], push)}
    actor = t_sac.make_actor(view_dim, 2, t_sac.SACConfig(hidden_dims=HIDDEN), "cpu")
    actor.load_state_dict(actor_from_flax(params))
    return cfg, params, actor


def assert_actor_close(actor, params, what):
    want = actor_from_flax(params)
    got = actor.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{what} {k}",
                                   **PARAM)


def mix_draws(k_roll, steps: int, n: int) -> torch.Tensor:
    """The β draws of a rollout: per step ``k_mix = split(keys[t])[0]``,
    ``uniform(k_mix, (n, 1))``."""
    keys = jax.random.split(k_roll, steps)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.split(k)[0], (n, 1))) for k in keys]))


def minibatch_rows(k_train, train_steps: int, batch: int, size: int) -> torch.Tensor:
    return torch.stack([sample_idx(k, batch, size)
                        for k in jax.random.split(k_train, train_steps)])


def test_scheduled_dagger_iteration_matches_jax(sched):
    jp = j_suite("robustness", obs_overrides=OBS_OVERRIDES).replace(max_episode_steps=4)
    tp = env_params_from_numpy(jp)
    obs_dim = j_obs_dim(jp)
    n, steps, hist = 8, 6, 2
    j_cfg = j_dagger.DaggerConfig(num_envs=n, rollout_steps=steps, capacity=2 * n * steps,
                                  batch_size=16, train_steps=3, lr=LR, history_len=hist)
    t_cfg = t_dagger.DaggerConfig(**vars(j_cfg))
    sac_cfg, params, actor = students(obs_dim * hist)
    j_sched = jax_schedule(sched)
    rp_j, rp_t = jp.rocket, tp.rocket

    def j_teacher(s):
        return j_demos.lqr_action_scheduled(s.body, j_sched, s.dr.mass, s.dr.thrust_scale,
                                            jnp.zeros_like(s.dr.cg_offset), rp_j)

    def t_teacher(s):
        return t_demos.lqr_action_scheduled(s.body, sched, s.dr.mass, s.dr.thrust_scale,
                                            torch.zeros_like(s.dr.cg_offset), rp_t)

    k_env = jax.random.PRNGKey(2)
    opt = optax.adam(LR)
    j_state = j_dagger.init_state(k_env, jp, params, opt, j_cfg, obs_dim, 2)
    t_state = t_dagger.init_state(tp, actor, t_cfg, obs_dim, 2, "cpu",
                                  reset_draws=KeyChain(jp).reset(jax.random.split(k_env, n)))
    j_it = j_dagger.make_dagger_iteration(jp, j_teacher, sac_cfg, j_cfg, obs_dim, 2, opt=opt)
    t_it = t_dagger.make_dagger_iteration(tp, t_teacher, None, t_cfg, obs_dim, 2)
    chain = KeyChain(jp)
    recorder = recording_batched_keys()
    env_keys = recorder.__enter__()
    for i, beta in enumerate((1.0, 0.6, 0.36)):
        key = jax.random.PRNGKey(10 + i)
        env_keys.clear()
        j_state, j_metrics = j_it(j_state, key, jnp.float32(beta))
        jax.effects_barrier()
        assert len(env_keys) == steps
        k_collect, k_train = jax.random.split(key)
        draws = t_dagger.DaggerDraws(
            u_mix=mix_draws(k_collect, steps, n), steps=[chain.step(k) for k in env_keys],
            idx=minibatch_rows(k_train, 3, 16, int(j_state.size)))
        t_state, t_metrics = t_it(t_state, beta, draws)
        what = f"iteration {i}"
        assert (t_state.ptr, t_state.size) == (int(j_state.ptr), int(j_state.size)), what
        np.testing.assert_allclose(t_state.data_obs.numpy(), np.asarray(j_state.data_obs),
                                   err_msg=what, **OBS)
        np.testing.assert_allclose(t_state.data_act.numpy(), np.asarray(j_state.data_act),
                                   err_msg=what, **OBS)
        assert_actor_close(t_state.actor, j_state.actor_params, what)
        assert sorted(t_metrics) == sorted(j_metrics)
        for k in ("rollout_episodes", "rollout_success"):
            assert int(t_metrics[k]) == int(j_metrics[k]), (what, k)
        for k in ("bc_loss_first", "bc_loss_last"):
            np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), **PARAM)
    recorder.__exit__(None, None, None)
    assert int(j_metrics["rollout_episodes"]) > 0 and t_state.ptr == n * steps   # wrapped


def test_cem_dagger_iteration_matches_jax(sched):
    base = j_suite("robustness", obs_overrides=OBS_OVERRIDES)
    jp = base.replace(randomization=base.randomization.replace(
        mass_variation=jnp.float32(0.0), thrust_variation=jnp.float32(0.0),
        cg_offset_max=jnp.float32(0.0), wind_max=jnp.float32(0.0),
        init_tilt_max=jnp.float32(0.02)))
    tp = env_params_from_numpy(jp)
    obs_dim = j_obs_dim(jp)
    n, steps, hist = 4, 40, 2
    j_cfg = j_dagger.DaggerConfig(num_envs=n, rollout_steps=steps, capacity=2 * n * steps,
                                  batch_size=16, train_steps=3, lr=LR, history_len=hist)
    t_cfg = t_dagger.DaggerConfig(**vars(j_cfg))
    ccfg = j_cem.CEMConfig(pop=4, elites=2, generations=2, horizon=150)
    sac_cfg, params, actor = students(obs_dim * hist, push=2.0)
    opt = optax.adam(LR)
    j_state = j_dagger.init_cem_state(params, opt, j_cfg, obs_dim, 2)
    t_state = t_dagger.init_cem_state(actor, t_cfg, obs_dim, 2, "cpu")
    j_it = j_dagger.make_cem_dagger_iteration(jp, jax_schedule(sched), sac_cfg, j_cfg, obs_dim,
                                              2, ccfg, opt=opt)
    t_it = t_dagger.make_cem_dagger_iteration(tp, sched, None, t_cfg, obs_dim, 2,
                                              t_cem.CEMConfig(*ccfg))
    key = jax.random.PRNGKey(5)
    with recording_batched_keys() as env_keys:
        j_state, j_metrics = j_it(j_state, key, jnp.float32(BETA))
    k_collect, k_train = jax.random.split(key)
    k_reset, k_cem, k_recycle, k_roll = jax.random.split(k_collect, 4)
    chain = KeyChain(jp)
    draws = t_dagger.DaggerDraws(
        reset=chain.reset(jax.random.split(k_reset, n)), cem=cem_draws(k_cem, ccfg, n),
        u_choice=torch.from_numpy(np.asarray(jax.random.uniform(k_recycle, (n,)))),
        u_mix=mix_draws(k_roll, steps, n),
        steps=[chain.step(k) for k in env_keys if k.shape[0] == n],   # the rollout's calls
        idx=minibatch_rows(k_train, 3, 16, int(j_state.size)))
    assert len(draws.steps) == steps
    t_state, t_metrics = t_it(t_state, BETA, draws)
    np.testing.assert_allclose(t_state.data_obs.numpy(), np.asarray(j_state.data_obs), **OBS)
    np.testing.assert_allclose(t_state.data_act.numpy(), np.asarray(j_state.data_act), **OBS)
    np.testing.assert_array_equal(t_state.data_w.numpy(), np.asarray(j_state.data_w))
    assert (t_state.ptr, t_state.size) == (int(j_state.ptr), int(j_state.size))
    assert_actor_close(t_state.actor, j_state.actor_params, "cem iteration")
    assert sorted(t_metrics) == sorted(j_metrics)
    for k in ("rollout_episodes", "rollout_success", "labeled_rows", "teacher_solved"):
        assert float(t_metrics[k]) == pytest.approx(float(j_metrics[k]), abs=1e-6), k
    for k in ("bc_loss_first", "bc_loss_last"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), **PARAM)
    w = t_state.data_w.numpy()[: n * steps]
    assert float(t_metrics["teacher_solved"]) > 0 and 0 < w.sum() < n * steps   # ends freeze


def test_ring_write_never_straddles_the_wrap():
    cfg = t_dagger.DaggerConfig(num_envs=4, rollout_steps=3, capacity=20)
    with pytest.raises(AssertionError, match="straddle"):
        t_dagger.init_cem_state(t_sac.make_actor(8, 2, t_sac.SACConfig((8,)), "cpu"), cfg, 8, 2,
                                "cpu")
