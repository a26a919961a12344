"""Actor, tanh-Gaussian head and safety layer of tvc_ai_torch against JAX (CPU).

Flax actor params are carried across with ``convert.actor_from_flax``; the
same exploration noise is fed to both. Bars: mean, log_std and actions within
1e-5; the safety mask exactly equal and the safe actions within 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import actor_from_flax
from tvc_ai_torch.models import distributions as t_dist
from tvc_ai_torch.models import safety as t_safety
from tvc_ai_torch.models.mlp import GaussianActor as TActor
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.models import distributions as j_dist
from tvc_ai_tpu.models import safety as j_safety
from tvc_ai_tpu.models.mlp import GaussianActor as JActor

torch.set_num_threads(1)
HIDDEN = (64, 64)
TOL = dict(atol=1e-5, rtol=1e-5)


def flax_actor(seed: int = 0, obs_dim: int = 10):
    actor = JActor(action_dim=2, hidden_dims=HIDDEN)
    params = actor.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    return actor, params


def ported_actor(params, obs_dim: int = 10) -> TActor:
    actor = TActor(obs_dim, 2, HIDDEN, device="cpu")
    actor.load_state_dict(actor_from_flax(jax.tree.map(np.asarray, params)))
    return actor


def random_obs(seed: int, n: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 10)).astype(np.float32)
    obs[:, :4] /= np.linalg.norm(obs[:, :4], axis=-1, keepdims=True)
    return obs


def test_actor_matches_flax():
    j_actor, params = flax_actor()
    actor = ported_actor(params)
    obs = random_obs(0)
    j_mean, j_log_std = j_actor.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, log_std = actor(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), **TOL)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(j_log_std), **TOL)


def test_actor_init_orthogonal_sqrt2_zero_bias():
    actor = TActor(10, 2, HIDDEN, device="cpu", seed=3)
    w = actor.hidden_1.weight.detach()  # (64, 64): square, so W Wᵀ = 2 I
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(64), atol=1e-4)
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in actor.named_parameters()
               if n.endswith("bias"))
    again = TActor(10, 2, HIDDEN, device="cpu", seed=3)
    assert torch.equal(actor.mean_head.weight, again.mean_head.weight)  # seeded


@pytest.mark.parametrize("deterministic", [False, True])
def test_select_action_matches_jax(deterministic):
    j_actor, params = flax_actor(seed=1)
    actor = ported_actor(params)
    obs = random_obs(1)
    key = jax.random.PRNGKey(7)
    cfg = j_sac.SACConfig(hidden_dims=HIDDEN)
    state = j_sac.SACState(actor_params=params, critic_params=None, target_critic_params=None,
                           log_alpha=jnp.float32(0.0), actor_opt=None, critic_opt=None,
                           alpha_opt=None, step=jnp.int32(0))
    ref = j_sac.select_action(state, jnp.asarray(obs), key, cfg, 2, deterministic=deterministic)
    # the noise sample_and_log_prob draws from the same key
    n_act = torch.from_numpy(np.array(jax.random.normal(key, (obs.shape[0], 2))))
    out = t_sac.select_action(actor, torch.from_numpy(obs), n_act, deterministic=deterministic)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sample_and_log_prob_matches_jax():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(256, 2)).astype(np.float32) * 2.0
    log_std = rng.uniform(-25.0, 4.0, size=(256, 2)).astype(np.float32)  # both clamps
    key = jax.random.PRNGKey(9)
    j_a, j_lp = j_dist.sample_and_log_prob(key, jnp.asarray(mean), jnp.asarray(log_std))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (256, 2))))
    t_a, t_lp = t_dist.sample_and_log_prob(torch.from_numpy(mean), torch.from_numpy(log_std),
                                           noise)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), **TOL)
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), **TOL)


def test_apply_safety_matches_jax():
    """A batch with each violation kind present (tilt, rate, effort)."""
    rng = np.random.default_rng(5)
    n = 256
    obs = random_obs(5, n)
    obs[:, :4] = np.array([0.0, 0.0, 0.0, 1.0]) + rng.normal(size=(n, 4)) * 0.3
    obs[:, :4] /= np.linalg.norm(obs[:, :4], axis=-1, keepdims=True)
    obs[:, 4:7] *= rng.choice([1.0, 6.0], size=(n, 1))
    action = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
    obs = obs.astype(np.float32)
    j_out, j_mask = j_safety.apply_safety(jnp.asarray(obs), jnp.asarray(action),
                                          j_safety.SafetyConstraints())
    t_out, t_mask = t_safety.apply_safety(torch.from_numpy(obs), torch.from_numpy(action),
                                          t_safety.SafetyConstraints())
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-6, rtol=1e-6)
    tilt, omega_mag, *_ = t_safety.obs_safety_features(torch.from_numpy(obs))
    effort = torch.linalg.vector_norm(torch.from_numpy(action), dim=-1)
    assert bool((tilt > 0.52).any() and (omega_mag > 5.0).any() and (effort > 1.0).any())
    assert 0 < int(t_mask.sum()) < n


def test_bfloat16_compute_is_not_ported():
    with pytest.raises(NotImplementedError):
        t_sac.SACConfig(compute_dtype="bfloat16")
