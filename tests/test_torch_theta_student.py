"""The θ-student (``tvc_ai_torch/training/theta_student.py``) against the JAX
package (CPU).

- ``pack_student_theta`` / ``unpack_student_theta`` round trip and the
  student-view mask, exact; ``theta_scale`` at 1e-6 (ddof 0 on both sides;
  the unbiased estimator would differ by ~7 % on the 3 × 3 grid).
- ``theta_hat_action`` at 1e-5 on the env's own frames and random θ̂.
- ``ThetaNet`` carried across with ``convert.theta_net_from_flax``: the
  forward at 1e-5; ``make_theta_policy_fn`` at 1e-5 on stacked views.
- The θ-DAgger iteration once (4 envs from tilted starts on the nominal
  plant, the student-view CEM solving them, a 40-step rollout at β 0.5 with
  a student whose trims push near full gimbal, every draw replayed from the
  JAX key chain): the ring's views at the env bars, θ labels at 1e-5,
  weights exact, the net's parameters at 1e-5 after 3 Adam minibatches, the
  metrics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_dagger import OBS, OBS_OVERRIDES, minibatch_rows, mix_draws
from test_torch_parity_utils import KeyChain, cem_draws, jax_schedule, recording_batched_keys
from tvc_ai_torch.convert import env_params_from_numpy, theta_net_from_flax
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.training import cem as t_cem
from tvc_ai_torch.training import dagger as t_dagger
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_torch.training import theta_student as t_ts
from tvc_ai_tpu.env.types import obs_dim as j_obs_dim
from tvc_ai_tpu.eval.evaluate import _suite_env_params as j_suite
from tvc_ai_tpu.training import cem as j_cem
from tvc_ai_tpu.training import theta_student as j_ts

torch.set_num_threads(1)
PARAM = dict(atol=1e-5, rtol=1e-5)
JP = j_suite("robustness", obs_overrides=OBS_OVERRIDES)
TP = env_params_from_numpy(JP)


@pytest.fixture(scope="module")
def sched():
    return t_demos.design_lqr_schedule(env_params_from_numpy(j_suite("robustness")), 3, 3,
                                       verify_rollouts=2, verify_horizon=250, device="cpu")


def test_pack_unpack_and_mask():
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.normal(size=(5, 15)).astype(np.float32))
    t10 = t_ts.pack_student_theta(full)
    np.testing.assert_array_equal(t10.numpy(), np.asarray(j_ts.pack_student_theta(
        jnp.asarray(full.numpy()))))
    back = t_ts.unpack_student_theta(t10)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_ts.unpack_student_theta(
        jnp.asarray(t10.numpy()))))
    mask = t_ts.student_view_mask()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_ts.student_view_mask()))
    torch.testing.assert_close(back, full * mask)
    torch.testing.assert_close(t_ts.pack_student_theta(back), t10)


def test_theta_scale_is_ddof_zero(sched):
    got = t_ts.theta_scale(sched)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ts.theta_scale(jax_schedule(sched))),
                               atol=1e-6, rtol=1e-6)
    assert got.shape == (t_ts.STUDENT_THETA_DIM,) and bool((got >= 0.05).all())


def test_theta_hat_action_and_net_match_jax():
    rng = np.random.default_rng(1)
    n = 32
    _, obs = t_env.reset(TP, n, "cpu", generator=torch.Generator().manual_seed(0))
    frame = obs + torch.from_numpy(rng.normal(0.0, 0.1, obs.shape).astype(np.float32))
    theta10 = torch.from_numpy(rng.normal(0.0, 2.0, (n, 10)).astype(np.float32))
    want = j_ts.theta_hat_action(jnp.asarray(theta10.numpy()), jnp.asarray(frame.numpy()), JP)
    got = t_ts.theta_hat_action(theta10, frame, TP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PARAM)
    assert 0 < int((got.abs() == 1.0).sum()) < got.numel()
    # the net, carried across from flax, and the policy on stacked views
    cfg = t_ts.ThetaDaggerConfig(history_len=3, hidden_dims=(32, 16))
    view = torch.from_numpy(rng.normal(0.0, 0.5, (n, 16 * 3)).astype(np.float32))
    j_net = j_ts.ThetaNet(hidden_dims=cfg.hidden_dims)
    params = j_net.init(jax.random.PRNGKey(3), jnp.zeros((1, 48)))
    net = t_ts.ThetaNet(48, cfg.hidden_dims, device="cpu")
    net.load_state_dict(theta_net_from_flax(params))
    assert [name for name, _ in net.named_children()] == ["Dense_0", "Dense_1", "Dense_2"]
    np.testing.assert_allclose(net(view).detach().numpy(),
                               np.asarray(j_net.apply(params, jnp.asarray(view.numpy()))),
                               **PARAM)
    j_policy = j_ts.make_theta_policy_fn(JP, j_ts.ThetaDaggerConfig(**vars(cfg)))
    t_policy = t_ts.make_theta_policy_fn(TP, cfg)
    np.testing.assert_allclose(t_policy(net, view).numpy(),
                               np.asarray(j_policy(params, jnp.asarray(view.numpy()), None)),
                               **PARAM)


def test_theta_dagger_iteration_matches_jax(sched):
    jp = JP.replace(randomization=JP.randomization.replace(
        mass_variation=jnp.float32(0.0), thrust_variation=jnp.float32(0.0),
        cg_offset_max=jnp.float32(0.0), wind_max=jnp.float32(0.0),
        init_tilt_max=jnp.float32(0.02)))
    tp = env_params_from_numpy(jp)
    obs_dim = j_obs_dim(jp)
    n, steps, beta = 4, 40, 0.5
    j_cfg = j_ts.ThetaDaggerConfig(num_envs=n, rollout_steps=steps, capacity=2 * n * steps,
                                   batch_size=16, train_steps=3, history_len=2,
                                   hidden_dims=(16, 16))
    t_cfg = t_ts.ThetaDaggerConfig(**vars(j_cfg))
    ccfg = j_cem.CEMConfig(pop=4, elites=2, generations=2, horizon=150)
    opt = optax.adam(j_cfg.lr)
    j_state = j_ts.init_theta_state(jax.random.PRNGKey(4), opt, j_cfg, obs_dim)
    # trims pushing near full gimbal: the student ends episodes
    params = jax.tree.map(lambda x: x, j_state.net_params)
    head = params["params"]["Dense_2"]
    params["params"]["Dense_2"] = {**head, "bias": head["bias"].at[8:].set(2.0)}
    j_state = j_state._replace(net_params=params, opt_state=opt.init(params))
    net = t_ts.ThetaNet(obs_dim * 2, j_cfg.hidden_dims, device="cpu")
    net.load_state_dict(theta_net_from_flax(params))
    t_state = t_ts.init_theta_state(t_cfg, obs_dim, "cpu", net=net)
    j_it = j_ts.make_theta_dagger_iteration(jp, jax_schedule(sched), j_cfg, obs_dim, ccfg,
                                            opt=opt)
    t_it = t_ts.make_theta_dagger_iteration(tp, sched, t_cfg, obs_dim, t_cem.CEMConfig(*ccfg))
    key = jax.random.PRNGKey(6)
    with recording_batched_keys() as env_keys:
        j_state, j_metrics = j_it(j_state, key, jnp.float32(beta))
    k_collect, k_train = jax.random.split(key)
    k_reset, k_cem, k_recycle, k_roll = jax.random.split(k_collect, 4)
    chain = KeyChain(jp)
    draws = t_dagger.DaggerDraws(
        reset=chain.reset(jax.random.split(k_reset, n)), cem=cem_draws(k_cem, ccfg, n),
        u_choice=torch.from_numpy(np.asarray(jax.random.uniform(k_recycle, (n,)))),
        u_mix=mix_draws(k_roll, steps, n),
        steps=[chain.step(k) for k in env_keys if k.shape[0] == n],
        idx=minibatch_rows(k_train, 3, 16, int(j_state.size)))
    t_state, t_metrics = t_it(t_state, beta, draws)
    np.testing.assert_allclose(t_state.data_obs.numpy(), np.asarray(j_state.data_obs), **OBS)
    np.testing.assert_allclose(t_state.data_theta.numpy(), np.asarray(j_state.data_theta),
                               **PARAM)
    np.testing.assert_array_equal(t_state.data_w.numpy(), np.asarray(j_state.data_w))
    want = theta_net_from_flax(j_state.net_params)
    for k, v in t_state.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **PARAM)
    assert sorted(t_metrics) == sorted(j_metrics)
    for k in ("rollout_episodes", "rollout_success", "labeled_rows", "teacher_solved"):
        assert float(t_metrics[k]) == pytest.approx(float(j_metrics[k]), abs=1e-6), k
    for k in ("theta_loss_first", "theta_loss_last"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), **PARAM)
    w = t_state.data_w.numpy()[: n * steps]
    assert float(t_metrics["teacher_solved"]) > 0 and 0 < w.sum() < n * steps
