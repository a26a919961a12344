"""The feasibility oracle's verdicts (``python -m tvc_ai_torch.suite_feasibility
--cem``) against the JAX package's on the same robustness draws (CPU).

The oracle counts a suite draw solved when the per-draw CEM refinement of
the gain-scheduled LQR finds a controller whose score reaches half the
success bonus. Here both packages refine the same 8 robustness draws (the
first 8 analytically feasible ones of 256 reset keys, replayed into the
port's explicit draws) from the same initial θ (the port's 3 × 3 schedule)
with the same candidate noise, at the oracle's own sizes (pop 64, horizon
700, no IMU noise), the generations cut from 25 to 2. The bound is
[16b]'s: at most 1 verdict in 8 differs, and the reference solves at least
one draw (else nothing is compared). Measured: 0 of 8 differ, the best
scores within 4e-5 (2.1e-4 at 4 generations; this CPU).

``suite_feasibility.wilson_interval``, which pools several runs' strict
successes, is held against scipy's Wilson interval.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, cem_draws
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.training import cem as t_cem
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.eval.evaluate import _suite_env_params as j_suite
from tvc_ai_tpu.training import cem as j_cem

torch.set_num_threads(1)
JP = j_suite("robustness")
TP = env_params_from_numpy(JP)
DRAWS, POOL, GENERATIONS = 8, 256, 2


def feasible(states) -> np.ndarray:
    """``suite_feasibility._report``'s analytic labels: not climb-away, not
    friction-pinned, equilibrium tilt inside the 5-degree window."""
    rp = TP.rocket
    mass, tscale = states.dr.mass.numpy(), states.dr.thrust_scale.numpy()
    cg = np.linalg.norm(states.dr.cg_offset.numpy()[:, :2], axis=1)
    g_eff, thrust = 2.0 * float(rp.gravity), tscale * float(rp.thrust)
    climb = thrust > mass * g_eff
    pinned = float(rp.contact_friction) * (mass * g_eff - thrust) > thrust * math.sin(
        float(rp.max_gimbal))
    return ~(climb | pinned | (np.arctan(2.0 * thrust * cg / (mass * g_eff)) > 0.087))


def test_oracle_verdicts_match_jax_on_the_same_draws():
    sched = t_demos.design_lqr_schedule(TP, 3, 3, verify_rollouts=2, verify_horizon=250,
                                        device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), POOL)
    pool, _ = t_env.reset(TP, POOL, "cpu", draws=KeyChain(JP).reset(keys))
    keys = keys[np.flatnonzero(feasible(pool))[:DRAWS]]
    j_states, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, JP)
    t_states, _ = t_env.reset(TP, DRAWS, "cpu", draws=KeyChain(JP).reset(keys))
    cfg = t_cem.CEMConfig(pop=64, generations=GENERATIONS, horizon=700)
    theta0 = t_cem.theta_for_states(sched, t_states)
    key = jax.random.PRNGKey(5)
    _, want = jax.jit(lambda s, th: j_cem.refine_per_draw(key, JP, s, th, cfg))(
        j_states, jnp.asarray(theta0.numpy()))
    _, got = t_cem.refine_per_draw(TP, t_states, theta0, cfg,
                                   draws=cem_draws(key, cfg, DRAWS), generator=torch.Generator())
    solved_ref = np.asarray(want) >= 0.5 * cfg.success_bonus
    solved = got.numpy() >= 0.5 * cfg.success_bonus
    assert solved_ref.any(), np.asarray(want)
    assert int((solved != solved_ref).sum()) <= DRAWS // 8, (got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k, n", [(241, 2048), (58, 2048), (0, 20), (20, 20), (3, 7)])
def test_wilson_interval_matches_scipy(k, n):
    from scipy.stats import binomtest

    from tvc_ai_torch.suite_feasibility import wilson_interval

    ci = binomtest(k, n).proportion_ci(method="wilson")
    np.testing.assert_allclose(wilson_interval(k, n), (ci.low, ci.high), atol=1e-12, rtol=0)
