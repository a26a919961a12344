"""The gain-scheduled LQR teacher (``tvc_ai_torch/training/demos.py``'s
``design_lqr_schedule``, ``_verify_rollouts``, ``interp_design`` and
``lqr_action_scheduled``) against the JAX package (CPU).

- The schedule at a 3 × 3 grid of the default plant's DR box with its
  verification (2 rollouts per cell and variant, 250 steps; the draws
  replayed from the reference's ``PRNGKey(0)``): grids exact; the gains on
  x, θ, vx, ω, ``z_eq`` and the trim slopes at rtol 1e-4; the gains on the
  uncontrollable altitude channel (z, vz; ~0 weight), which are float32
  rounding amplified by the Riccati iteration (measured 1.4e-6 against
  2.6e-6), within 1e-5; ``cell_success`` and ``feasible`` equal.
  The JAX design jits one vmapped Jacobian program per plane: this file's
  ~2 min are that compile.
- ``interp_design`` at 1e-6 on draws inside, at and beyond the box, and on
  a zero-width mass axis; ``lqr_action_scheduled`` at 1e-5.
- The verification's tilted starts and 40 steps of the scheduled LQR on
  them at the env bars (obs 5e-5 / 5e-4, terminations exact), and
  ``_verify_rollouts``' first-episode success over 250 steps equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    assert_state_close,
    jax_body,
    jax_schedule,
    jax_verify_start,
    random_bodies,
    verify_draws,
    verify_params,
)
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams
from tvc_ai_tpu.training import demos as j_demos

torch.set_num_threads(1)
OBS = dict(atol=5e-5, rtol=5e-4)
GRID, ROLLOUTS, HORIZON = 3, 2, 250
VARIANTS = len(t_demos._VERIFY_R_SCALES) + 1
ALTITUDE, CONTROLLED = [1, 4], [0, 2, 3, 5]   # planar state [x, z, θ, vx, vz, ω]


@pytest.fixture(scope="module")
def schedules():
    jp = EnvParams()
    want = j_demos.design_lqr_schedule(jp, GRID, GRID, verify_rollouts=ROLLOUTS,
                                       verify_horizon=HORIZON)
    reset, ang, _ = verify_draws(jp, GRID * GRID * VARIANTS * ROLLOUTS)
    got = t_demos.design_lqr_schedule(env_params_from_numpy(jp), GRID, GRID,
                                      verify_rollouts=ROLLOUTS, verify_horizon=HORIZON,
                                      device="cpu", verify_draws=(reset, ang))
    return got, want


def test_schedule_matches_jax(schedules):
    got, want = schedules
    for name in ("mass_grid", "tscale_grid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for name in ("gain", "gain_pitch", "z_eq", "trim_slope", "trim_slope_pitch"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and g.shape == w.shape, name
        if name.startswith("gain"):
            # the altitude channel (z, vz) is uncontrollable and weighs ~0:
            # its gains are float32 rounding amplified by the Riccati
            # iteration, |k| < 1e-5 on both sides
            np.testing.assert_allclose(g[..., ALTITUDE], w[..., ALTITUDE], rtol=0, atol=1e-5,
                                       err_msg=name)
            g, w = g[..., CONTROLLED], w[..., CONTROLLED]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.cell_success.numpy(), np.asarray(want.cell_success))
    np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible))
    assert 0 < int(got.feasible.sum()) < GRID * GRID   # some cells pass, some are filled


def test_dlqr_batch_equals_the_loop():
    rng = np.random.default_rng(0)
    a = np.eye(4) + 0.05 * rng.normal(size=(5, 4, 4))
    a[2] = np.diag([2.0, 1.5, 1.0, 1.0])     # an uncontrollable unstable mode: diverges
    b = rng.normal(size=(5, 4, 1))
    b[2] = 0.0
    q, r = np.diag([1.0, 2.0, 3.0, 4.0]), np.array([[0.5]])
    got = t_demos._dlqr_batch(a, b, q, r)
    for i in range(5):
        np.testing.assert_array_equal(got[i], j_demos._dlqr(a[i], b[i], q, r))
    assert np.all(got[2] == 0.0) and np.abs(got[0]).max() > 0.0


def _draws(rng, n, lo, hi):
    """Masses or thrust scales inside the box, at its edges and beyond."""
    x = rng.uniform(lo, hi, size=n)
    x[:4] = [lo, hi, lo - 0.3, hi + 0.3]
    return x.astype(np.float32)


def test_interp_design_matches_jax(schedules):
    got_sched = schedules[0]
    rng = np.random.default_rng(1)
    m = _draws(rng, 64, 1.4, 2.6)
    t = _draws(rng, 64, 0.6, 1.4)
    want = j_demos.interp_design(jax_schedule(got_sched), jnp.asarray(m), jnp.asarray(t))
    got = t_demos.interp_design(got_sched, torch.from_numpy(m), torch.from_numpy(t))
    for name in t_demos.LQRDesign._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    # a zero-width mass axis (mass_variation 0): pinned to cell 0 with weight 0
    flat = got_sched._replace(mass_grid=torch.full((GRID,), 2.0),
                              gain=torch.from_numpy(rng.normal(size=(GRID, GRID, 6)).astype(
                                  np.float32)))
    want = j_demos.interp_design(jax_schedule(flat), jnp.asarray(m), jnp.asarray(t))
    got = t_demos.interp_design(flat, torch.from_numpy(m), torch.from_numpy(t))
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain), atol=1e-6, rtol=1e-6)
    assert torch.isfinite(got.gain).all()


def test_lqr_action_scheduled_matches_jax(schedules):
    sched = schedules[0]
    rng = np.random.default_rng(2)
    n = 64
    body_np, body = random_bodies(rng, n)
    m = _draws(rng, n, 1.4, 2.6)
    t = _draws(rng, n, 0.6, 1.4)
    rp_j = EnvParams().rocket
    want = j_demos.lqr_action_scheduled(jax_body(body), jax_schedule(sched), jnp.asarray(m),
                                        jnp.asarray(t), jnp.zeros((n, 3)), rp_j)
    got = t_demos.lqr_action_scheduled(body, sched, torch.from_numpy(m), torch.from_numpy(t),
                                       torch.zeros((n, 3)), env_params_from_numpy(EnvParams()).rocket)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert 0 < int((got.abs() == 1.0).sum()) < got.numel()


def test_verify_rollouts_match_jax(schedules):
    sched = schedules[0]
    jp = verify_params(EnvParams())
    tp = env_params_from_numpy(jp)
    rng = np.random.default_rng(3)
    n = 24
    m = rng.uniform(1.4, 2.6, size=n).astype(np.float32)
    t = rng.uniform(0.8, 1.2, size=n).astype(np.float32)
    reset, ang, keys = verify_draws(EnvParams(), n, jax.random.PRNGKey(5))
    design = t_demos.interp_design(sched, torch.from_numpy(m), torch.from_numpy(t))
    j_design = j_demos.LQRDesign(*(jnp.asarray(x.numpy()) for x in design))
    # the starts and 40 steps at the env bars
    j_state = jax_verify_start(jp, jnp.asarray(m), jnp.asarray(t), keys, 0.02)
    t_state = t_demos.verify_start(tp, torch.from_numpy(m), torch.from_numpy(t), 0.02,
                                   reset_draws=reset, ang=ang)
    assert_state_close(t_state, j_state, what="start")
    j_step = jax.jit(lambda s, a: j_env.batched_step_autoreset(s, a, jp, use_pallas=False))
    d0 = torch.zeros((n, 3))
    for step in range(40):
        j_act = j_demos.lqr_action(j_state.body, j_design, jnp.zeros((n, 3)), jp.rocket)
        t_act = t_demos.lqr_action(t_state.body, design, d0, tp.rocket)
        np.testing.assert_allclose(t_act.numpy(), np.asarray(j_act), **OBS)
        j_state, j_out, _ = j_step(j_state, j_act)
        t_state, t_out, _ = t_env.batched_step_autoreset(t_state, t_act, tp,
                                                         generator=torch.Generator())
        np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), **OBS)
        for flag in ("terminated", "mission_success"):
            np.testing.assert_array_equal(getattr(t_out, flag).numpy(),
                                          np.asarray(getattr(j_out, flag)), err_msg=flag)
    # first-episode success over the verification horizon
    want = j_demos._verify_rollouts(jp, jnp.asarray(m), jnp.asarray(t), j_design,
                                    jax.random.PRNGKey(5), HORIZON, 0.02)
    got = t_demos._verify_rollouts(tp, torch.from_numpy(m), torch.from_numpy(t), design,
                                   HORIZON, 0.02, generator=torch.Generator(),
                                   reset_draws=reset, ang=ang)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < n


def test_schedule_design_runs_on_the_cpu_only_when_asked():
    """``design_lqr_schedule`` verifies on CUDA unless told otherwise; the
    unverified design needs no device."""
    params = dataclasses.replace(env_params_from_numpy(EnvParams()))
    sched = t_demos.design_lqr_schedule(params, 2, 2, verify=False)
    assert sched.cell_success is None and sched.gain.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_demos.design_lqr_schedule(params, 2, 2)
