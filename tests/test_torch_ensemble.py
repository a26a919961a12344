"""The PPO+SAC+TD3 ensemble of tvc_ai_torch against the JAX package (CPU).

One JAX ``EnsembleCarry`` (``init_carry``) is carried across with
``convert.ensemble_carry_from_numpy``; the JAX ``make_ensemble_iteration``
runs one iteration of 8 steps under ``jit`` for each acting member, with the
env keys recorded (``record_env_keys``), and the port runs the same
iteration on the draws the JAX key chain gives: the acting member's noise
(three normals split from one key for the blend), the env's own keys, the
replay rows and noise of 2 SAC and 2 TD3 updates per step once the gate
(``max(sac.learning_starts, sac.batch_size)``) opens at the second step, and
PPO's epoch permutations. The replay wraps at the sixth step. Bars: env
state and obs 5e-5 / 5e-4, reward and returns 1e-3, replay rows at the same
bars, flags and counts exact, every member's parameters 1e-4, metrics 1e-3
relative. Then the host side (selection, weights, ``get_action``) and the
checkpoint. The PPO and blended actors' iterations are in
``test_torch_ensemble_ppo.py``, the trainer in ``test_torch_trainer_ensemble.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    KeyChain,
    assert_state_close,
    ensemble_draws,
    np_tree,
    permutations,
    record_env_keys,
)
from tvc_ai_torch.agents import ensemble as t_ens
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.agents import td3 as t_td3
from tvc_ai_torch.convert import env_params_from_numpy, ensemble_carry_from_numpy
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import ensemble as j_ens
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.agents import td3 as j_td3
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig

torch.set_num_threads(1)
N, STEPS, UPDATES, ACT = 16, 8, 2, 2
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
PARAMS = dict(atol=1e-4, rtol=0.0)
SAC = dict(hidden_dims=(32, 32), batch_size=16, buffer_size=96, learning_starts=32,
           gradient_clip_norm=5.0, reward_scale=0.05)
TD3 = dict(hidden_dims=(32, 32), batch_size=8)
PPO = dict(hidden_dims=(32, 32), n_epochs=2, num_minibatches=2)
WEIGHTS = np.array([0.2, 0.5, 0.3], np.float32)
JAX_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
    max_episode_steps=4,
)


def configs(**ens_kw):
    j_cfg = j_ens.EnsembleConfig(sac=j_sac.SACConfig(**SAC), td3=j_td3.TD3Config(**TD3),
                                 ppo=j_ppo.PPOConfig(**PPO), **ens_kw)
    t_cfg = t_ens.EnsembleConfig(sac=t_sac.SACConfig(**SAC), td3=t_td3.TD3Config(**TD3),
                                 ppo=t_ppo.PPOConfig(**PPO), **ens_kw)
    return j_cfg, t_cfg


def make_run(actor: str, params: EnvParams = JAX_PARAMS) -> dict:
    """One iteration of ``actor`` on both sides from the same carry and draws."""
    j_cfg, t_cfg = configs()
    carry0 = jax.jit(lambda k: j_ens.init_carry(k, params, j_cfg, N))(jax.random.PRNGKey(7))
    t_carry0 = ensemble_carry_from_numpy(np_tree(carry0), t_cfg, device="cpu")

    def run_jax():
        it = jax.jit(j_ens.make_ensemble_iteration(actor, j_cfg, N, STEPS, UPDATES))
        return it(carry0, jnp.asarray(WEIGHTS), params)

    (j_carry, j_metrics), env_keys = record_env_keys(run_jax, N)
    assert env_keys.shape[0] == STEPS
    cap = int(carry0.buffer.capacity)
    sizes = [min((t + 1) * N, cap) for t in range(STEPS)]
    draws, key = ensemble_draws(KeyChain(params), carry0.key, env_keys, sizes, actor, t_cfg, N,
                                STEPS, UPDATES)
    perms = (permutations(key, STEPS * N, t_cfg.ppo.n_epochs) if actor == "ppo" else None)
    t_it = t_ens.make_ensemble_iteration(actor, t_cfg, N, STEPS, UPDATES)
    t_carry, t_metrics = t_it(t_carry0, WEIGHTS, env_params_from_numpy(params), draws, perms)
    return dict(actor=actor, j=j_carry, jm=j_metrics, t=t_carry, tm=t_metrics, cfg=t_cfg,
                sizes=sizes)


# the PPO and blended actors' cases are in test_torch_ensemble_ppo.py (each
# case compiles one JAX iteration: ~15 s on the CPU)
@pytest.fixture(scope="module", params=["sac", "td3"])
def run(request):
    return make_run(request.param)


def test_iteration_env_state_and_obs_match(run):
    t, j = run["t"], run["j"]
    assert_state_close(t.env_states, j.env_states, what=run["actor"])
    np.testing.assert_allclose(t.obs.numpy(), np.asarray(j.obs), **OBS)


def test_iteration_replay_rows_match(run):
    t, j = run["t"].buffer, run["j"].buffer
    assert (t.ptr, t.size, t.capacity) == (int(j.ptr), int(j.size), j.capacity)
    assert t.size == t.capacity and t.ptr == (STEPS * N) % t.capacity  # it wrapped
    for k in ("obs", "next_obs", "action"):
        np.testing.assert_allclose(t.data[k].numpy(), np.asarray(j.data[k]), **OBS, err_msg=k)
    np.testing.assert_allclose(t.data["reward"].numpy(), np.asarray(j.data["reward"]), **REWARD)
    np.testing.assert_array_equal(t.data["done"].numpy(), np.asarray(j.data["done"]))


def test_iteration_counters_match(run):
    t, j = run["t"], np_tree(run["j"])
    for name in ("env_steps", "episodes", "successes", "ep_length"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)
        assert getattr(t, name).numpy().dtype == getattr(j, name).dtype, name
    for name in ("ep_return", "return_sum", "length_sum"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name), **REWARD,
                                   err_msg=name)
    assert int(t.episodes.sum()) > N  # autoresets fired


def test_iteration_params_match(run):
    t, j, cfg = run["t"], np_tree(run["j"]), run["cfg"]
    ref = ensemble_carry_from_numpy(j, cfg, device="cpu")
    nets = {"sac": ("actor", "critic", "target_critic"),
            "td3": ("actor", "critic", "target_actor", "target_critic"),
            "ppo": ("actor", "value")}
    for member, names in nets.items():
        for net in names:
            for (name, p), q in zip(getattr(getattr(t, member), net).named_parameters(),
                                    getattr(getattr(ref, member), net).parameters()):
                np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **PARAMS,
                                           err_msg=f"{member}.{net}.{name}")
    np.testing.assert_allclose(t.sac.log_alpha.numpy(), ref.sac.log_alpha.numpy(), **PARAMS)
    learned = UPDATES * sum(size >= max(cfg.sac.learning_starts, cfg.sac.batch_size)
                            for size in run["sizes"])
    assert t.sac.step == ref.sac.step == t.td3.step == ref.td3.step == learned == 14
    ppo_updates = cfg.ppo.n_epochs * cfg.ppo.num_minibatches if run["actor"] == "ppo" else 0
    assert t.ppo.step == ref.ppo.step == ppo_updates
    assert t.td3.actor_opt.count == ref.td3.actor_opt.count == learned // 2


def test_iteration_metrics_match(run):
    tm, jm = run["tm"], run["jm"]
    assert sorted(tm) == sorted(jm)
    assert any(k.startswith("ppo_") for k in tm) == (run["actor"] == "ppo")
    for k, v in tm.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=1e-3, atol=1e-5, err_msg=k)


def test_iteration_from_the_generator_and_options():
    _, cfg = configs()
    params = env_params_from_numpy(JAX_PARAMS)
    carry = t_ens.init_carry(params, cfg, N, device="cpu", seed=3)
    carry, metrics = t_ens.make_ensemble_iteration("ppo", cfg, N, STEPS, UPDATES)(
        carry, WEIGHTS, params)
    assert carry.sac.step == carry.td3.step == 14 and carry.ppo.step == 4
    assert all(torch.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="acting algorithm"):
        t_ens.make_ensemble_iteration("a2c", cfg, N, STEPS)
    with pytest.raises(ValueError, match="draws"):
        t_ens.make_ensemble_iteration("sac", cfg, N, STEPS)(carry, WEIGHTS, params, [])


# ---------------------------------------------------------------- host side
SELECTION = {
    "dynamic": dict(),
    "dynamic_eps": dict(selection_epsilon=0.2),
    "best": dict(selection_strategy="best"),
    "best_eps": dict(selection_strategy="best", selection_epsilon=0.2),
    "voting": dict(selection_strategy="voting", selection_epsilon=0.2),
}


@pytest.mark.parametrize("case", sorted(SELECTION))
def test_selection_and_weights_match_jax(case):
    """A scripted sequence of returns and selections: the picks, the
    windows and the weights equal the reference's exactly."""
    j_cfg, t_cfg = configs(performance_window=12, **SELECTION[case])
    port = t_ens.MultiAlgorithmAgent(config=t_cfg, seed=3, device="cpu")
    ref = j_ens.MultiAlgorithmAgent(config=j_cfg, seed=3)
    rng = np.random.default_rng(len(case))
    assert port.select_algorithm() == ref.select_algorithm()
    picks = []
    for i in range(300):
        if rng.random() < 0.6:
            algo = str(rng.choice(list(t_ens.ALGORITHMS)))
            reward = float(rng.normal({"ppo": 5.0, "sac": 4.0, "td3": 3.0}[algo], 3.0))
            port.update_performance(algo, reward)
            ref.update_performance(algo, reward)
            assert port.algorithm_weights == ref.algorithm_weights, i
        else:
            picks.append(port.select_algorithm())
            assert picks[-1] == ref.select_algorithm(), i
    assert {a: list(h) for a, h in port.performance_history.items()} == {
        a: list(h) for a, h in ref.performance_history.items()}
    np.testing.assert_array_equal(port.weights_array(), np.asarray(ref.weights_array()))
    if case == "voting":
        assert set(picks) == {"ensemble"}
    elif case.endswith("_eps"):   # the floor lets every member act
        assert set(picks) == set(t_ens.ALGORITHMS), set(picks)


def test_get_action_matches_jax():
    j_cfg, t_cfg = configs()
    j_carry = jax.jit(lambda k: j_ens.init_carry(k, JAX_PARAMS, j_cfg, N))(jax.random.PRNGKey(2))
    ref = j_ens.MultiAlgorithmAgent(config=j_cfg)
    port = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    ref.attach_carry(j_carry)
    port.attach_carry(ensemble_carry_from_numpy(np_tree(j_carry), t_cfg, device="cpu"))
    for algo, reward in (("sac", 3.0), ("ppo", -1.0), ("td3", 0.5)):
        ref.update_performance(algo, reward)
        port.update_performance(algo, reward)
    obs = np.asarray(j_carry.obs)
    for algo in t_ens.ACTORS:
        want, info = ref.get_action(obs, deterministic=True, algorithm=algo)
        got, t_info = port.get_action(obs, deterministic=True, algorithm=algo)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=algo)
        assert info == t_info == {"algorithm": algo}
        single, _ = port.get_action(obs[0], deterministic=True, algorithm=algo)
        np.testing.assert_allclose(single, got[0], atol=1e-6, err_msg=algo)
    noisy, info = port.get_action(obs)          # selected: sac leads
    assert info == {"algorithm": "sac"} and noisy.shape == (N, ACT)
    assert np.all(np.abs(noisy) <= 1.0) and not np.allclose(noisy, port.get_action(
        obs, deterministic=True, algorithm="sac")[0])
    with pytest.raises(RuntimeError, match="attach_carry"):
        t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu").get_action(obs)


def test_checkpoint_round_trip(tmp_path):
    j_cfg, t_cfg = configs()
    params = env_params_from_numpy(JAX_PARAMS)
    saved = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    saved.attach_carry(t_ens.init_carry(params, t_cfg, N, device="cpu", seed=1))
    saved.carry, _ = t_ens.make_ensemble_iteration("ppo", t_cfg, N, 4, 1)(
        saved.carry, WEIGHTS, params)
    for algo, reward in (("sac", 3.0), ("ppo", -1.0), ("sac", 2.0)):
        saved.update_performance(algo, reward)
    saved.save_checkpoint(tmp_path / "ens" / "members.pt")
    loaded = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    loaded.attach_carry(t_ens.init_carry(params, t_cfg, N, device="cpu", seed=2))
    members = lambda a: {m: getattr(a.carry, m) for m in t_ens.ALGORITHMS}  # noqa: E731
    assert diff_states(members(saved), members(loaded))  # the comparison can fail
    loaded.load_checkpoint(tmp_path / "ens" / "members.pt")
    assert diff_states(members(saved), members(loaded)) == []
    assert loaded.carry.sac.step == 3 and loaded.carry.ppo.step == PPO["n_epochs"] * 2
    assert loaded.carry.sac.actor_opt.count == loaded.carry.td3.critic_opt.count == 3
    assert loaded.performance_history == saved.performance_history
    assert loaded.algorithm_weights == saved.algorithm_weights
    # the env, obs and replay are not in the file: the loaded carry keeps its own
    assert not torch.equal(loaded.carry.obs, saved.carry.obs)
    # the JAX package's msgpack is read: its members act as the reference's
    ref = j_ens.MultiAlgorithmAgent(config=j_cfg)
    ref.attach_carry(jax.jit(lambda k: j_ens.init_carry(k, JAX_PARAMS, j_cfg, N))(
        jax.random.PRNGKey(0)))
    ref.update_performance("td3", 4.0)
    ref.save_checkpoint(tmp_path / "ens.msgpack")
    loaded.load_checkpoint(tmp_path / "ens.msgpack")
    obs = np.random.default_rng(3).normal(size=(8, 10)).astype(np.float32)
    for algo in t_ens.ALGORITHMS:
        np.testing.assert_allclose(
            loaded.get_action(obs, deterministic=True, algorithm=algo)[0],
            np.asarray(ref.get_action(obs, deterministic=True, algorithm=algo)[0]),
            atol=1e-6, rtol=0, err_msg=algo)
    assert loaded.carry.sac.step == 0 and list(loaded.performance_history["td3"]) == [4.0]
