"""The identification pilot (``tvc_ai_torch/training/pilot.py``) against the
JAX package (CPU). The reference's per-env functions run under ``vmap``
over N envs; the port's take the (N, P) swarms whole. Every draw is
replayed from the JAX keys: the prior draws of ``init_filter``, each
resampling's uniform and jitter normals (``split(fs.key, 3)``), the
selection's ``categorical`` as the argmax of the log weights plus
``gumbel(k_i, (S, P))``.

- ``init_filter`` exact-ish (1e-6); ``_predict`` through K1's wrapper (its
  plain version on the CPU) against the JAX integrator at the contact bars
  (5e-5 / 5e-4); ``_loglik`` at rtol 1e-5; ``_observer_correct`` at 1e-6.
- ``_resample`` with a degenerate and a healthy swarm: the systematic
  indices equal JAX's except where a point lies within float32 rounding of
  a cumulative weight (counted: none here), the resampled and jittered
  swarm at 1e-5, the log weights at 1e-5.
- ``select_from_library`` on the port's copy of the 19-controller library:
  the committed members equal.
- A 12-step pilot episode (act, env step, observe) at the env bars.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    KeyChain,
    _domain_draws_one,
    jax_schedule,
    np_tree,
)
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.training import cem as t_cem
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_torch.training import pilot as t_pilot
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.eval.evaluate import _suite_env_params as j_suite
from tvc_ai_tpu.training import cem as j_cem
from tvc_ai_tpu.training import pilot as j_pilot

torch.set_num_threads(1)
JP = j_suite("robustness", obs_overrides={"drift_obs_enabled": True})
TP = env_params_from_numpy(JP)
N, P = 3, 8
J_CFG = j_pilot.PilotConfig(particles=P)
T_CFG = t_pilot.PilotConfig(particles=P)
CONTACT = dict(atol=5e-5, rtol=5e-4)
OBS = dict(atol=5e-5, rtol=5e-4)
LIBRARY = "tvc_ai_torch/data/ctrl_library_robustness.npz"


def init_draws(keys):
    """The prior draws of ``vmap(init_filter)(keys, ..)``: (N, P, 7), (N, P, 3)."""
    rnd = JP.randomization
    k_dr = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    d = jax.vmap(jax.vmap(lambda k: _domain_draws_one(k, rnd)))(
        jax.vmap(lambda k: jax.random.split(k, P))(k_dr))
    return torch.from_numpy(np.array(d["u_dr"])), torch.from_numpy(np.array(d["n_dr"]))


def resample_draws(fs_key) -> t_pilot.ResampleDraws:
    """The draws of ``vmap(_resample)`` of filters carrying ``fs_key`` (N, 2)."""
    def one(k):
        _, k_u, k_j = jax.random.split(k, 3)
        return jax.random.uniform(k_u), jax.random.normal(k_j, (P, 8))
    u, n8 = jax.vmap(one)(fs_key)
    return t_pilot.ResampleDraws(u=torch.from_numpy(np.array(u)),
                                 n_jit=torch.from_numpy(np.array(n8)))


def assert_filter_close(got: t_pilot.FilterState, want, tol: dict, what: str):
    w = np_tree(want)
    for k in ("pos", "quat", "vel", "omega"):
        np.testing.assert_allclose(getattr(got.bodies, k).numpy(), getattr(w.bodies, k),
                                   err_msg=f"{what} {k}", **tol)
    for k in ("mass", "thrust_scale", "cg_offset", "wind"):
        np.testing.assert_allclose(getattr(got.dr, k).numpy(), getattr(w.dr, k),
                                   err_msg=f"{what} dr.{k}", atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.fuel.numpy(), w.fuel, err_msg=f"{what} fuel", atol=1e-6)


@pytest.fixture(scope="module")
def start():
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    j_states, j_obs = jax.vmap(j_env.reset, in_axes=(0, None))(keys, JP)
    t_states, t_obs = t_env.reset(TP, N, "cpu", draws=KeyChain(JP).reset(keys))
    pkeys = jax.random.split(jax.random.PRNGKey(1), N)
    j_fs = jax.vmap(j_pilot.init_filter, in_axes=(0, 0, None, None))(pkeys, j_obs, JP, J_CFG)
    u_dr, n_dr = init_draws(pkeys)
    t_fs = t_pilot.init_filter(t_obs, TP, T_CFG, u_dr, n_dr)
    return dict(j_states=j_states, j_obs=j_obs, t_states=t_states, t_obs=t_obs, pkeys=pkeys,
                j_fs=j_fs, t_fs=t_fs, u_dr=u_dr, n_dr=n_dr)


def test_filter_steps_match_jax(start):
    j_fs, t_fs = start["j_fs"], start["t_fs"]
    assert_filter_close(t_fs, j_fs, dict(atol=1e-6, rtol=1e-6), "init")
    assert t_fs.bodies.pos.shape == (N, P, 3)
    rng = np.random.default_rng(0)
    action = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    j_fs = jax.vmap(j_pilot._predict, in_axes=(0, 0, None))(j_fs, jnp.asarray(action), JP)
    t_fs = t_pilot._predict(t_fs, torch.from_numpy(action), TP)
    assert_filter_close(t_fs, j_fs, CONTACT, "predict")
    obs = np.asarray(start["j_obs"]) + rng.normal(0, 0.01, start["j_obs"].shape).astype(np.float32)
    j_ll = jax.vmap(j_pilot._loglik, in_axes=(0, 0, None, None))(j_fs, jnp.asarray(obs), JP,
                                                                  J_CFG)
    t_ll = t_pilot._loglik(t_fs, torch.from_numpy(obs), TP, T_CFG)
    np.testing.assert_allclose(t_ll.numpy(), np.asarray(j_ll), rtol=1e-4, atol=1e-3)
    j_fs = jax.vmap(j_pilot._observer_correct, in_axes=(0, 0, None, None))(
        j_fs, jnp.asarray(obs), JP, J_CFG)
    t_fs = t_pilot._observer_correct(t_fs, torch.from_numpy(obs), TP, T_CFG)
    assert_filter_close(t_fs, j_fs, CONTACT, "observer")


@pytest.mark.parametrize("spread", [0.1, 30.0])
def test_resample_matches_jax(start, spread):
    rng = np.random.default_rng(1)
    log_w = (rng.normal(size=(N, P)) * spread).astype(np.float32)
    j_fs = start["j_fs"]._replace(log_w=jnp.asarray(log_w))
    t_fs = dataclasses.replace(start["t_fs"], log_w=torch.from_numpy(log_w))
    draws = resample_draws(j_fs.key)
    # the indices: equal, except within float32 rounding of a boundary
    lw = log_w - jax.scipy.special.logsumexp(log_w, axis=-1, keepdims=True)
    cum = np.cumsum(np.exp(lw), -1)
    pts = (draws.u.numpy()[:, None] + np.arange(P)) / P
    j_idx = np.clip(np.array(jax.vmap(jnp.searchsorted)(jnp.asarray(cum), jnp.asarray(pts))),
                    0, P - 1)
    t_idx = t_pilot.systematic_indices(torch.softmax(torch.from_numpy(log_w), -1),
                                       draws.u).numpy()
    near = np.min(np.abs(pts[:, :, None] - cum[:, None, :]), -1) < 1e-6
    flips = (t_idx != j_idx) & ~near
    assert not flips.any(), (t_idx, j_idx)
    j_out = jax.vmap(j_pilot._resample, in_axes=(0, None, None))(j_fs, JP, J_CFG)
    t_out = t_pilot._resample(t_fs, TP, T_CFG, draws)
    assert_filter_close(t_out, j_out, dict(atol=1e-5, rtol=1e-5), f"resample {spread}")
    np.testing.assert_allclose(t_out.log_w.numpy(), np.asarray(j_out.log_w), atol=1e-5,
                               rtol=1e-5)
    need = (t_out.log_w == 0).all(-1)
    assert bool(need.any()) == (spread > 1.0)   # a degenerate swarm resamples, a healthy one not


def test_select_from_library_matches_jax(start):
    with np.load(LIBRARY) as blob:
        library = torch.from_numpy(blob["theta"])
    assert library.shape == (19, t_cem.THETA_DIM)
    s = 4
    rng = np.random.default_rng(2)
    log_w = (rng.normal(size=(N, P)) * 3.0).astype(np.float32)
    cfg = t_cem.CEMConfig(horizon=40, alive_weight=0.1)
    tkeys = jax.random.split(jax.random.PRNGKey(2), N)
    j_tmpl, _ = jax.vmap(j_env.reset, in_axes=(0, None))(tkeys, JP)
    t_tmpl, _ = t_env.reset(TP, N, "cpu", draws=KeyChain(JP).reset(tkeys))
    j_ps = jax.vmap(j_pilot.init_pilot, in_axes=(0, 0, None, None))(
        start["pkeys"], start["j_obs"], JP, J_CFG)
    j_ps = j_ps._replace(filt=j_ps.filt._replace(log_w=jnp.asarray(log_w)))
    t_ps = t_pilot.init_pilot(start["t_obs"], TP, T_CFG, start["u_dr"], start["n_dr"])
    t_ps = dataclasses.replace(t_ps, filt=dataclasses.replace(t_ps.filt,
                                                              log_w=torch.from_numpy(log_w)))
    key = jax.random.PRNGKey(3)
    k_sel, _ = jax.random.split(key)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (s, P)))(jax.random.split(k_sel, N))
    want = j_pilot.select_from_library(key, j_ps, jnp.asarray(library.numpy()), JP,
                                       j_cem.CEMConfig(*cfg), j_tmpl, n_samples=s)
    got = t_pilot.select_from_library(t_ps, library, TP, cfg, t_tmpl, n_samples=s,
                                      gumbel=torch.from_numpy(np.array(gumbel)),
                                      generator=torch.Generator())
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(want.theta))
    assert bool(got.has_theta.all())


def test_pilot_episode_matches_jax(start):
    sched = t_demos.design_lqr_schedule(env_params_from_numpy(JP), 3, 3, verify=False)
    j_sched = jax_schedule(sched)
    j_ps = jax.vmap(j_pilot.init_pilot, in_axes=(0, 0, None, None))(
        start["pkeys"], start["j_obs"], JP, J_CFG)
    t_ps = t_pilot.init_pilot(start["t_obs"], TP, T_CFG, start["u_dr"], start["n_dr"])
    j_states, t_states = start["j_states"], start["t_states"]
    chain = KeyChain(JP)
    j_act_fn = jax.jit(jax.vmap(lambda p: j_pilot.pilot_act(p, j_sched, JP, J_CFG)))
    j_obs_fn = jax.jit(jax.vmap(lambda p, o: j_pilot.pilot_observe(p, o, JP, J_CFG)))
    j_step = jax.jit(lambda s, a: j_env.batched_step_autoreset(s, a, JP, use_pallas=False))
    for t in range(12):
        j_ps, j_act = j_act_fn(j_ps)
        t_ps, t_act = t_pilot.pilot_act(t_ps, sched, TP, T_CFG)
        np.testing.assert_allclose(t_act.numpy(), np.asarray(j_act), err_msg=f"step {t}", **OBS)
        d = chain.step(j_states.key)
        j_states, j_out, _ = j_step(j_states, j_act)
        t_states, t_out, _ = t_env.batched_step_autoreset(t_states, t_act, TP, n_imu=d.n_imu,
                                                          reset_draws=d.reset)
        np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), **OBS)
        draws = resample_draws(j_ps.filt.key)
        j_ps = j_obs_fn(j_ps, j_out.obs)
        t_ps = t_pilot.pilot_observe(t_ps, t_out.obs, TP, T_CFG, draws)
        assert_filter_close(t_ps.filt, j_ps.filt, CONTACT, f"step {t}")
    est = t_pilot.estimate_dr(t_ps.filt)
    want = jax.vmap(j_pilot.estimate_dr)(j_ps.filt)
    np.testing.assert_allclose(est.mass.numpy(), np.asarray(want.mass), atol=1e-4, rtol=1e-4)
