"""The batched evaluation rollout and the suites of tvc_ai_torch against the
JAX package (CPU).

The JAX ``make_eval_fn`` runs under ``jit`` on the CPU (``vmap(rocket_env.step)``
with the plain integrator); the port's runs ``rocket_env.batched_step``
(K1's wrapper, its plain version on CPU tensors) on the same actor weights
(``convert.sac_state_from_numpy``) and the same draws: the reset's from the
replayed per-env keys, and each step's IMU noise from the key each env
carries (``(key, k_noise) = split(key)`` per step, sensor noise on). Bars:
returns 1e-3, the other per-episode stats 5e-5 / 5e-4, lengths, success and
crash exact.
"""

from __future__ import annotations

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    EVERY_OPTION,
    KeyChain,
    np_tree,
    option_params,
    reset_key_left,
    step_obs_draws,
)
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import env_params_from_numpy, sac_state_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.eval import evaluate as t_evaluate
from tvc_ai_torch.eval import rollout as t_rollout
from tvc_ai_torch.eval.rollout import EvalDraws
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.config import loader as j_loader
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.eval import evaluate as j_evaluate
from tvc_ai_tpu.eval import rollout as j_rollout

torch.set_num_threads(1)
E, HORIZON = 5, 60
# a well-conditioned draw: with key 7 one truncated-obs episode's action
# drifts from 1e-5 to 0.9 between steps 20 and 31 (float32 rounding grown by
# the tumbling dynamics) and its tilt termination moves by 4 steps
EVAL_KEY = 8
REWARD = dict(atol=1e-3, rtol=1e-3)
OBS = dict(atol=5e-5, rtol=5e-4)
SAC = dict(hidden_dims=(32, 32))
# name: (randomization on, history_len, obs_dim truncation)
CASES = {
    "dr_noise": (True, 1, None),
    "nominal": (False, 1, None),
    "dr_noise_history2": (True, 2, None),
    "truncate8_history2": (True, 2, 8),
}


def jax_params(randomized: bool, horizon: int = HORIZON) -> EnvParams:
    return EnvParams(
        randomization=RandomizationConfig(enabled=randomized, sensor_noise_enabled=randomized,
                                          init_tilt_max=0.05),
        max_episode_steps=horizon,
    )


def replay_draws(key, params: EnvParams, episodes: int) -> EvalDraws:
    """The draws JAX's ``eval_fn(agent, key, params)`` consumes: each
    step's IMU noise and dropout draw from the key each env carries."""
    k_reset, _ = jax.random.split(key)
    keys = jax.random.split(k_reset, episodes)
    reset = KeyChain(params).reset(keys)
    rnd = params.randomization
    if not (rnd.sensor_noise_enabled or rnd.sensor_dropout_enabled):
        return EvalDraws(reset=reset)

    def per_env(k):
        return jax.lax.scan(lambda c, _: step_obs_draws(c, params), reset_key_left(k, params),
                            None, length=params.max_episode_steps)[1]

    d = jax.jit(jax.vmap(per_env))(keys)                       # (E, T, ...)
    steps = {k: torch.from_numpy(np.array(v)).transpose(0, 1) for k, v in d.items()}
    return EvalDraws(reset=reset, **steps)


def agents(policy_obs: int, seed: int = 0):
    cfg_j, cfg_t = j_sac.SACConfig(**SAC), t_sac.SACConfig(**SAC)
    j_state = j_sac.init(jax.random.PRNGKey(seed), policy_obs, 2, cfg_j)
    return j_state, sac_state_from_numpy(np_tree(j_state), cfg_t, policy_obs, 2, device="cpu")


def assert_stats_close(port: t_rollout.EpisodeStats, ref) -> None:
    ref = np_tree(ref)
    for name in ("lengths", "success", "crashed"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), getattr(ref, name), name)
    np.testing.assert_allclose(port.returns.numpy(), ref.returns, **REWARD)
    for name in ("max_tilt", "max_angular_velocity", "mean_effort", "final_altitude",
                 "fuel_used"):
        np.testing.assert_allclose(getattr(port, name).numpy(), getattr(ref, name), **OBS,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_matches_jax(case):
    randomized, history, obs_dim = CASES[case]
    jp = jax_params(randomized)
    policy_obs = (obs_dim or 10) * history
    j_agent, t_agent = agents(policy_obs)
    key = jax.random.PRNGKey(EVAL_KEY)
    j_fn = jax.jit(j_rollout.make_eval_fn(j_sac.SACConfig(**SAC), E, obs_dim=obs_dim,
                                          history_len=history))
    t_fn = t_rollout.make_eval_fn(t_sac.SACConfig(**SAC), E, obs_dim=obs_dim,
                                  history_len=history)
    ref = j_fn(j_agent, key, jp)
    port = t_fn(t_agent, None, env_params_from_numpy(jp), replay_draws(key, jp, E))
    assert_stats_close(port, ref)
    assert int(port.lengths.min()) < HORIZON  # some episode ended inside the horizon
    assert t_rollout.summarize_stats(port).keys() == j_rollout.summarize_stats(ref).keys()


def test_eval_matches_jax_with_robust_options():
    """Every robust-training env option on (the eval rollout steps without
    autoreset, so the reset's feasible and mixture draws and every step's
    noise and dropout draw come from the replayed chain); the survival
    payout and the loose success window make successes count."""
    jp = option_params({k: v for k, v in EVERY_OPTION.items() if k != "drift_obs_enabled"},
                       max_episode_steps=HORIZON)
    j_agent, t_agent = agents(10)
    key = jax.random.PRNGKey(EVAL_KEY)
    ref = jax.jit(j_rollout.make_eval_fn(j_sac.SACConfig(**SAC), E))(j_agent, key, jp)
    draws = replay_draws(key, jp, E)
    assert draws.u_drop.shape == (HORIZON, E) and draws.reset.u_feas.shape == (E, 8, 4)
    port = t_rollout.make_eval_fn(t_sac.SACConfig(**SAC), E)(
        t_agent, None, env_params_from_numpy(jp), draws)
    assert_stats_close(port, ref)
    assert bool(port.success.any())


def test_trajectory_matches_jax():
    jp = jax_params(True)
    j_agent, t_agent = agents(10)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(j_rollout.make_trajectory_fn(j_sac.SACConfig(**SAC), E))(j_agent, key, jp)
    port = t_rollout.make_trajectory_fn(t_sac.SACConfig(**SAC), E)(
        t_agent, None, env_params_from_numpy(jp), replay_draws(key, jp, E))
    ref = np_tree(ref)
    assert port.keys() == ref.keys()
    assert port["action"].shape == (HORIZON, E, 2) and port["live"].shape == (HORIZON, E)
    live = ref["live"] > 0.5
    np.testing.assert_array_equal(port["live"].numpy(), ref["live"])
    assert live[0].all() and not live[-1].all()  # every episode starts; some end
    # the live mask is a prefix in time: once an episode ends it stays ended
    assert (np.diff(ref["live"], axis=0) <= 0).all()
    for name in ("altitude", "tilt", "angular_velocity"):
        np.testing.assert_allclose(port[name].numpy()[live], ref[name][live], **OBS, err_msg=name)
    np.testing.assert_allclose(port["reward"].numpy()[live], ref["reward"][live], **REWARD)
    np.testing.assert_allclose(port["action"].numpy()[live], ref["action"][live], **OBS)


def _port_eval(params, check_every, seed=3, episodes=E, history=1):
    _, t_agent = agents(10 * history)
    fn = t_rollout.make_eval_fn(t_sac.SACConfig(**SAC), episodes, history_len=history,
                                check_every=check_every)
    return fn(t_agent, torch.Generator().manual_seed(seed), params)


def test_early_exit_equals_full_horizon(monkeypatch):
    """Stopping once every episode has ended gives the stats of the whole horizon."""
    params = env_params_from_numpy(jax_params(True, horizon=400))
    calls = []
    real = t_env.batched_step
    monkeypatch.setattr(t_rollout.rocket_env, "batched_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    early = _port_eval(params, check_every=32)
    ran = len(calls)
    full = _port_eval(params, check_every=10**9)
    assert ran == t_rollout.steps_run(early.lengths, 400) < 400
    assert len(calls) == ran + 400
    for name, a, b in zip(early._fields, early, full):
        assert torch.equal(a, b), name


def test_finished_episodes_freeze():
    """An episode adds nothing after its end: the stats equal the trajectory's
    series summed, maxed or taken at the last step while the episode lived,
    and a frozen episode burns no more fuel."""
    params = env_params_from_numpy(jax_params(True, horizon=80))
    stats = _port_eval(params, check_every=10**9)
    _, t_agent = agents(10)
    series = t_rollout.make_trajectory_fn(t_sac.SACConfig(**SAC), E)(
        t_agent, torch.Generator().manual_seed(3), params)
    live = series["live"] > 0.5
    assert (stats.lengths < 80).any() and torch.equal(stats.lengths, live.sum(0).int())
    torch.testing.assert_close(stats.returns, (series["reward"] * live).sum(0), rtol=1e-6,
                               atol=1e-3)
    assert torch.equal(stats.max_tilt, torch.where(live, series["tilt"], 0.0).amax(0))
    last = (stats.lengths - 1).long()
    assert torch.equal(stats.final_altitude, series["altitude"][last, torch.arange(E)])
    torch.testing.assert_close(stats.fuel_used, stats.lengths * params.rocket.fuel_burn_rate,
                               rtol=1e-4, atol=1e-6)


def test_summarize_stats_matches_jax():
    rng = np.random.default_rng(0)
    n = 37
    arrays = dict(
        returns=rng.normal(300.0, 200.0, n).astype(np.float32),
        lengths=rng.integers(1, 1000, n).astype(np.int32),
        success=rng.random(n) < 0.3,
        crashed=rng.random(n) < 0.2,
        max_tilt=rng.uniform(0.0, 0.6, n).astype(np.float32),
        max_angular_velocity=rng.uniform(0.0, 5.0, n).astype(np.float32),
        mean_effort=rng.uniform(0.0, 1.4, n).astype(np.float32),
        final_altitude=rng.uniform(0.0, 3.0, n).astype(np.float32),
        fuel_used=rng.uniform(0.0, 1.0, n).astype(np.float32),
    )
    port = t_rollout.summarize_stats(
        t_rollout.EpisodeStats(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    ref = j_rollout.summarize_stats(
        j_rollout.EpisodeStats(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    assert port == ref


def test_episode_csv_matches_jax(tmp_path):
    jp = jax_params(True)
    j_agent, t_agent = agents(10)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(j_rollout.make_eval_fn(j_sac.SACConfig(**SAC), E))(j_agent, key, jp)
    port = t_rollout.EpisodeStats(*(torch.from_numpy(np.array(x)) for x in ref))
    j_evaluate.write_episode_csv(j_evaluate.SuiteResult("s", ref, {}), tmp_path / "j.csv")
    t_evaluate.write_episode_csv(t_evaluate.SuiteResult("s", port, {}), tmp_path / "t.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    rows = list(csv.reader(open(tmp_path / "t.csv")))
    assert rows[0] == ["episode", *t_rollout.EpisodeStats._fields] and len(rows) == E + 1


SUITE_KNOBS = {
    "plain": dict(),
    "legacy_mass": dict(rocket_mass=1.5),
    "cg0_no_noise": dict(cg_offset_max=0.0, sensor_noise=False),
}


@pytest.mark.parametrize("knobs", sorted(SUITE_KNOBS))
@pytest.mark.parametrize("name", ["standard", "robustness", "stress"])
def test_suite_env_params_match_jax(name, knobs):
    kw = SUITE_KNOBS[knobs]
    port = t_evaluate._suite_env_params(name, **kw)
    ref = env_params_from_numpy(jax.tree.map(np.asarray, j_evaluate._suite_env_params(name, **kw)))
    assert port == ref


def test_obs_overrides_match_jax():
    from tvc_ai_torch.config import loader as t_loader

    overrides = ["env.trim_observation.enabled=true", "env.trim_observation.mode=integral",
                 "env.drift_observation.enabled=true", "env.action_observation.enabled=true",
                 "env.drift_observation.vel_scale=1.5"]
    port = t_evaluate.obs_overrides_from_config(t_loader.load_config(None, overrides))
    ref = j_evaluate.obs_overrides_from_config(j_loader.load_config(None, overrides))
    assert port.keys() == ref.keys()
    for k in port:
        assert np.float32(port[k]) == np.float32(ref[k]), k
    p = t_evaluate._suite_env_params("robustness", obs_overrides=port)
    r = env_params_from_numpy(jax.tree.map(
        np.asarray, j_evaluate._suite_env_params("robustness", obs_overrides=ref)))
    assert p == r


def test_run_all_suites_writes_outputs(tmp_path):
    _, t_agent = agents(10)
    results = t_evaluate.run_all_suites(t_agent, t_sac.SACConfig(**SAC), tmp_path,
                                        episodes_scale=0.02, seed=1, device="cpu")
    assert set(results) == {"standard", "robustness", "stress"}
    for name, r in results.items():
        assert r.stats.returns.shape == (max(int(t_evaluate.SUITE_EPISODES[name] * 0.02), 2),)
        assert (tmp_path / f"{name}_episodes.csv").exists()
        assert r.steps == t_rollout.steps_run(r.stats.lengths, 1500 if name == "stress" else 2000)
        assert r.seconds > 0
    assert (tmp_path / "evaluation_summary.json").exists()


@pytest.mark.parametrize("history", [1, 2], ids=["history1", "history2"])
def test_hierarchical_eval_matches_jax(history):
    """``make_hier_eval_fn``: each step the high level's argmax goal from the
    newest frame, the SAC actor on [obs ‖ goal one-hot]."""
    from tvc_ai_torch.convert import high_level_state_from_numpy
    from tvc_ai_torch.models import hierarchical as t_hier
    from tvc_ai_tpu.models import hierarchical as j_hier

    jp = jax_params(True)
    j_agent, t_agent = agents(10 * history + 4, seed=history)
    j_high = j_hier.init_high(jax.random.PRNGKey(20 + history), 10, j_hier.HierarchicalConfig())
    t_high = high_level_state_from_numpy(np_tree(j_high), 10, t_hier.HierarchicalConfig(), "cpu")
    key = jax.random.PRNGKey(EVAL_KEY)
    ref = jax.jit(j_rollout.make_hier_eval_fn(j_sac.SACConfig(**SAC), j_hier.HierarchicalConfig(),
                                              E, history_len=history))((j_agent, j_high), key, jp)
    port = t_rollout.make_hier_eval_fn(t_sac.SACConfig(**SAC), t_hier.HierarchicalConfig(), E,
                                       history_len=history)(
        (t_agent, t_high), None, env_params_from_numpy(jp), replay_draws(key, jp, E))
    assert_stats_close(port, ref)
    assert int(port.lengths.min()) < HORIZON


def test_load_agent_state(tmp_path):
    from tvc_ai_torch.utils.checkpoint import CheckpointManager

    cfg = t_sac.SACConfig(**SAC, ema_decay=0.99)
    agent = t_sac.init(10, 2, cfg, device="cpu", seed=4)
    with torch.no_grad():
        for p in agent.ema_actor.parameters():
            p.add_(1.0)
    CheckpointManager(tmp_path / "ck").save(64, {"carry": {"agent": agent}})
    for path in (tmp_path / "ck", tmp_path / "ck" / "64"):
        loaded = t_evaluate.load_agent_state(path, 10, 2, cfg, device="cpu")
        for a, b in zip(loaded.actor.parameters(), agent.ema_actor.parameters()):
            assert torch.equal(a, b)  # the EMA actor is preferred
        for a, b in zip(loaded.critic.parameters(), agent.critic.parameters()):
            assert torch.equal(a, b)
        assert torch.equal(loaded.log_alpha, agent.log_alpha)
    # a flax msgpack file is read (tests/test_torch_jax_artifacts.py); an
    # empty one holds no SACState and is refused
    (tmp_path / "agent.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="no actor_params"):
        t_evaluate.load_agent_state(tmp_path / "agent.msgpack", 10, 2, cfg, device="cpu")
    # an orbax root whose only step was never completed (no
    # _CHECKPOINT_METADATA) holds no checkpoint, as the port's own roots
    (tmp_path / "orbax" / "128" / "carry").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
        t_evaluate.load_agent_state(tmp_path / "orbax", 10, 2, cfg, device="cpu")


def test_rocket_config_matches_jax():
    from tvc_ai_torch.env.wrappers import RocketConfig as TRocketConfig
    from tvc_ai_tpu.env.wrappers import RocketConfig as JRocketConfig

    for kw in (dict(), dict(mass=2.0, cg_offset_max=0.1, burn_time=10.0)):
        for dr in (False, True):
            port = TRocketConfig(**kw).to_env_params(domain_randomization=dr, sensor_noise=dr,
                                                     max_episode_steps=77)
            ref = JRocketConfig(**kw).to_env_params(domain_randomization=dr, sensor_noise=dr,
                                                    max_episode_steps=77)
            assert port == env_params_from_numpy(jax.tree.map(np.asarray, ref))
            assert dataclasses.asdict(port)["rocket"]["dt"] == 0.02
