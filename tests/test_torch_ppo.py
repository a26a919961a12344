"""PPO of tvc_ai_torch against the JAX package (CPU).

``ValueNetwork`` and ``log_prob`` against flax / JAX; ``compute_gae``
within 1e-6 (resets at done included); one ``ppo.update`` from a JAX
``PPOState`` carried across with ``convert.ppo_state_from_numpy`` within
1e-5 (its metrics 1e-4 relative), and the same comparison failing with
advantages normalized by the sample std (ddof 1); a full phase (GAE and 2
epochs × 2 minibatches, the reference's loop of ``agents/ensemble.py``) and
the stand-alone ``make_train_iteration`` within 1e-4, on the permutations
and env keys the JAX key chain draws.
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
    assert_state_close,
    np_tree,
    permutations,
    record_env_keys,
    to_torch,
)
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.convert import (
    env_params_from_numpy,
    env_state_from_numpy,
    ppo_state_from_numpy,
    value_from_flax,
)
from tvc_ai_torch.models import distributions as t_dist
from tvc_ai_torch.models.mlp import ValueNetwork as TValue
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.models import distributions as j_dist
from tvc_ai_tpu.models.mlp import ValueNetwork as JValue

torch.set_num_threads(1)
OBS, ACT, HIDDEN = 10, 2, (32, 32)
T, N, MB = 8, 16, 16
PPO = dict(hidden_dims=HIDDEN, n_epochs=2, num_minibatches=2)
PARAMS_1 = dict(atol=1e-5, rtol=0.0)      # one update
PARAMS_PHASE = dict(atol=1e-4, rtol=0.0)  # a phase of updates, an iteration
METRICS = dict(rtol=1e-4, atol=1e-6)
JAX_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
    max_episode_steps=4,
)


def _assert_ppo_close(port: t_ppo.PPOState, ref: t_ppo.PPOState, tol: dict, what: str):
    for net in ("actor", "value"):
        for (name, p), q in zip(getattr(port, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **tol,
                                       err_msg=f"{what}: {net}.{name}")
    assert port.step == ref.step and port.opt.count == ref.opt.count, what


def _jax_state(seed: int, cfg: j_ppo.PPOConfig):
    return j_ppo.init(jax.random.PRNGKey(seed), OBS, ACT, cfg)


def test_value_network_and_log_prob_match_jax():
    value = JValue(hidden_dims=HIDDEN)
    params = value.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    ported = TValue(OBS, HIDDEN, device="cpu")
    ported.load_state_dict(value_from_flax(np_tree(params)))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, OBS)).astype(np.float32)
    with torch.no_grad():
        v = ported(torch.from_numpy(obs))
    assert v.shape == (64,)
    np.testing.assert_allclose(v.numpy(), np.asarray(value.apply(params, jnp.asarray(obs))),
                               atol=1e-5, rtol=1e-5)
    assert [n for n, _ in ported.named_parameters()][-2:] == ["v_head.weight", "v_head.bias"]
    mean = rng.normal(size=(256, ACT)).astype(np.float32)
    log_std = rng.uniform(-25.0, 4.0, size=(256, ACT)).astype(np.float32)  # both clamps
    pre_tanh = (mean + rng.normal(size=(256, ACT)) * 0.7).astype(np.float32)
    ref = j_dist.log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(pre_tanh))
    got = t_dist.log_prob(torch.from_numpy(mean), torch.from_numpy(log_std),
                          torch.from_numpy(pre_tanh))
    finite = np.isfinite(np.asarray(ref))
    assert finite.sum() > 100
    np.testing.assert_allclose(got.numpy()[finite], np.asarray(ref)[finite], rtol=1e-5, atol=1e-4)


def _gae_inputs(seed: int):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(T, N)).astype(f32), rng.normal(size=(T, N)).astype(f32),
            (rng.uniform(size=(T, N)) < 0.2).astype(f32), rng.normal(size=N).astype(f32))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_gae_matches_jax(seed):
    inputs = _gae_inputs(seed)
    j_adv, j_ret = j_ppo.compute_gae(*map(jnp.asarray, inputs), 0.99, 0.95)
    adv, ret = t_ppo.compute_gae(*map(torch.from_numpy, inputs), 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), atol=1e-6, rtol=1e-6)
    assert inputs[2].sum() > 0
    # the reference's own case: no bootstrap through a termination
    adv, _ = t_ppo.compute_gae(torch.tensor([[1.0], [1.0]]), torch.zeros(2, 1),
                               torch.tensor([[1.0], [0.0]]), torch.tensor([10.0]), 0.99, 0.95)
    assert float(adv[0, 0]) == pytest.approx(1.0, abs=1e-6)


def _policy_batch(state, rng, rows: int, perturb: float) -> dict[str, np.ndarray]:
    """A minibatch whose pre-tanh actions come from the policy, with the
    stored log-probs shifted by ``perturb`` × a normal (so ratio ≠ 1)."""
    obs = rng.normal(size=(rows, OBS)).astype(np.float32)
    actor, _ = j_ppo.make_networks(OBS, ACT, j_ppo.PPOConfig(**PPO))
    mean, log_std = actor.apply(state.actor_params, jnp.asarray(obs))
    log_std = j_dist.clamp_log_std(log_std)
    pre_tanh = mean + jnp.exp(log_std) * rng.normal(size=(rows, ACT)).astype(np.float32)
    logp = j_dist.log_prob(mean, log_std, pre_tanh)
    return {
        "obs": obs,
        "pre_tanh": np.array(pre_tanh),
        "log_prob": np.asarray(logp) + (rng.normal(size=rows) * perturb).astype(np.float32),
        "advantage": (rng.normal(size=rows) * 5.0 + 1.0).astype(np.float32),
        "return": (rng.normal(size=rows) * 3.0).astype(np.float32),
    }


def _compare_updates(updates: int = 3):
    """``updates`` minibatch updates on both sides; asserts the bars."""
    cfg_j, cfg_t = j_ppo.PPOConfig(**PPO), t_ppo.PPOConfig(**PPO)
    j_state = _jax_state(2, cfg_j)
    port = ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT, device="cpu")
    j_update = jax.jit(lambda s, b: j_ppo.update(s, b, cfg_j, jax.random.PRNGKey(0), ACT))
    rng = np.random.default_rng(3)
    for i in range(updates):
        batch = _policy_batch(j_state, rng, MB, perturb=0.3)
        j_state, j_m = j_update(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        port, m = t_ppo.update(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t)
        what = f"after {i + 1} update(s)"
        _assert_ppo_close(port, ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT,
                                                     device="cpu"), PARAMS_1, what)
        assert sorted(m) == sorted(j_m), what
        for k, v in m.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(j_m[k]), **METRICS,
                                       err_msg=f"{what}: {k}")
    return m


def test_update_matches_jax():
    m = _compare_updates()
    assert float(m["clip_fraction"]) > 0.0 and float(m["policy_loss"]) != 0.0


def test_ddof1_normalization_fails_the_bar(monkeypatch):
    """Advantages normalized by the sample std (torch's default, ddof 1)
    would not pass the comparison the port passes with ddof 0."""
    monkeypatch.setattr(t_ppo, "normalize_advantages",
                        lambda adv: (adv - adv.mean()) / (adv.std() + 1e-8))
    with pytest.raises(AssertionError):
        _compare_updates()


def _jax_phase(cfg: j_ppo.PPOConfig):
    """GAE and the epochs exactly as ``tvc_ai_tpu/agents/ensemble.py`` runs
    them after a PPO rollout."""

    def phase(state, traj, last_value, key):
        advantages, returns = j_ppo.compute_gae(traj["reward"], traj["value"], traj["done"],
                                                last_value, cfg.gamma, cfg.gae_lambda)
        rows = T * N
        flat = {"obs": traj["obs"].reshape(rows, OBS),
                "pre_tanh": traj["pre_tanh"].reshape(rows, ACT),
                "log_prob": traj["log_prob"].reshape(rows),
                "advantage": advantages.reshape(rows), "return": returns.reshape(rows)}
        mb_size = max(rows // cfg.num_minibatches, 1)

        def epoch(carry_in, _):
            st, key = carry_in
            key, k_perm, k_up = jax.random.split(key, 3)
            perm = jax.random.permutation(k_perm, rows)
            idx = perm[: mb_size * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_size)

            def minibatch(c, i):
                st, k = c
                st, m = j_ppo.update(st, {k2: v[i] for k2, v in flat.items()}, cfg, k, ACT)
                return (st, k), m

            (st, _), m = jax.lax.scan(minibatch, (st, k_up), idx)
            return (st, key), jax.tree.map(jnp.mean, m)

        (state, _), m = jax.lax.scan(epoch, (state, key), None, length=cfg.n_epochs)
        return state, jax.tree.map(jnp.mean, m)

    return jax.jit(phase)


def test_phase_matches_jax():
    cfg_j, cfg_t = j_ppo.PPOConfig(**PPO), t_ppo.PPOConfig(**PPO)
    j_state = _jax_state(5, cfg_j)
    port = ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT, device="cpu")
    rng = np.random.default_rng(4)
    batch = _policy_batch(j_state, rng, T * N, perturb=0.0)
    traj = {k: batch[k].reshape(T, N, *batch[k].shape[1:]) for k in ("obs", "pre_tanh",
                                                                     "log_prob")}
    traj.update(value=rng.normal(size=(T, N)).astype(np.float32),
                reward=(rng.normal(size=(T, N)) * 4.0).astype(np.float32),
                done=(rng.uniform(size=(T, N)) < 0.15).astype(np.float32))
    last_value = rng.normal(size=N).astype(np.float32)
    key = jax.random.PRNGKey(9)
    j_state, j_m = _jax_phase(cfg_j)(j_state, {k: jnp.asarray(v) for k, v in traj.items()},
                                     jnp.asarray(last_value), key)
    port, m = t_ppo.learn(port, {k: torch.from_numpy(v) for k, v in traj.items()},
                          torch.from_numpy(last_value), cfg_t,
                          perms=permutations(key, T * N, cfg_t.n_epochs))
    _assert_ppo_close(port, ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT,
                                                 device="cpu"), PARAMS_PHASE, "phase")
    assert port.step == 4
    for k, v in m.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_m[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    # drawn from a generator instead: the same number of updates
    port, m = t_ppo.learn(port, {k: torch.from_numpy(v) for k, v in traj.items()},
                          torch.from_numpy(last_value), cfg_t,
                          generator=torch.Generator().manual_seed(0))
    assert port.step == 8 and all(torch.isfinite(v) for v in m.values())
    with pytest.raises(ValueError, match="permutations"):
        t_ppo.learn(port, {k: torch.from_numpy(v) for k, v in traj.items()},
                    torch.from_numpy(last_value), cfg_t, perms=[torch.arange(T * N)])


def test_make_train_iteration_matches_jax():
    cfg_j, cfg_t = j_ppo.PPOConfig(**PPO), t_ppo.PPOConfig(**PPO)
    j_state = _jax_state(6, cfg_j)
    env_states, obs = jax.vmap(j_env.reset, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(7), N), JAX_PARAMS)
    t_state = ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT, device="cpu")
    t_env = env_state_from_numpy(np_tree(env_states), device="cpu")
    key = jax.random.PRNGKey(8)

    def run_jax():
        it = jax.jit(j_ppo.make_train_iteration(cfg_j, N, T, OBS, ACT))
        return it(j_state, env_states, obs, key, JAX_PARAMS)

    (j_out, j_env_out, j_obs, j_key, j_m), env_keys = record_env_keys(run_jax, N)
    assert env_keys.shape[0] == T
    chain, draws = KeyChain(JAX_PARAMS), []
    for t in range(T):
        key, k_act = jax.random.split(key)
        draws.append(dataclasses.replace(chain.step(env_keys[t]),
                                         n_act=to_torch(jax.random.normal(k_act, (N, ACT)))))
    it = t_ppo.make_train_iteration(cfg_t, N, T, OBS, ACT)
    t_out, t_env_out, t_obs, _, m = it(t_state, t_env, to_torch(obs), None,
                                       env_params_from_numpy(JAX_PARAMS), draws,
                                       permutations(key, T * N, cfg_t.n_epochs))
    assert_state_close(t_env_out, j_env_out, what="ppo iteration")
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=5e-5, rtol=5e-4)
    _assert_ppo_close(t_out, ppo_state_from_numpy(np_tree(j_out), cfg_t, OBS, ACT, device="cpu"),
                      PARAMS_PHASE, "iteration")
    assert sorted(m) == sorted(j_m)
    for k, v in m.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_m[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert float(j_m["success_rate"]) >= 0.0 and int(t_env_out.step_count.min()) >= 0
    with pytest.raises(ValueError, match="draws"):
        it(t_out, t_env_out, t_obs, None, env_params_from_numpy(JAX_PARAMS), draws[:2])
