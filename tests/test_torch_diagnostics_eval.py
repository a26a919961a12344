"""The batched research diagnostics of tvc_ai_torch against the reference's
scripts (CPU): ``policy_breakdown`` (a student and a θ-student) and
``ablate_dr``; and ``--cpu`` on ``python -m tvc_ai_torch.train`` /
``.evaluate``.

The reference scripts run through their ``main`` with ``sys.argv`` patched
and the horizon cut (the suite's, or ``ablate_dr``'s 1000 steps, to 64 by
patching the env constructor they call); the port's factored functions get
the same weights (carried across with ``convert``) and the eval draws JAX's
``eval_fn(agent, PRNGKey(seed), params)`` consumes
(``test_torch_eval.replay_draws``). The printed lines must agree as in
``test_torch_diagnostics.py``; the bin counts (``n=``), which depend on the
draws alone, are equal, and so are the success rates: no episode's outcome
is decided within a bar of its threshold over 64 steps of these policies, so
the bound on differing outcomes is 0.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from test_torch_diagnostics import HIDDEN, assert_lines_agree, captured, run_script
from test_torch_eval import replay_draws
from test_torch_parity_utils import np_tree
from tvc_ai_torch import ablate_dr, evaluate, policy_breakdown, train
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import sac_state_from_numpy, theta_net_from_flax
from tvc_ai_torch.training import dagger
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env import wrappers as j_wrappers
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.eval import evaluate as j_evaluate
from tvc_ai_tpu.training import theta_student as j_ts

torch.set_num_threads(1)
HORIZON, EPISODES, HISTORY = 64, 16, 2
VIEW = 16 * HISTORY   # the suite frame with the drift and action channels


@pytest.fixture
def cut_suite(monkeypatch):
    """The reference's suite env at HORIZON steps."""
    full = j_evaluate._suite_env_params
    monkeypatch.setattr(j_evaluate, "_suite_env_params",
                        lambda *a, **k: full(*a, **k).replace(max_episode_steps=HORIZON))


@pytest.mark.parametrize("kind", ["student", "theta"])
def test_policy_breakdown_matches_script(kind, cut_suite, tmp_path, monkeypatch):
    ref = tmp_path / "ref.msgpack"
    port = tmp_path / "port.pt"
    if kind == "student":
        cfg = j_sac.SACConfig(hidden_dims=HIDDEN)
        j_state = j_sac.init(jax.random.PRNGKey(4), VIEW, 2, cfg)
        ref.write_bytes(serialization.msgpack_serialize(
            {"state": serialization.to_state_dict(j_state)}))
        t_cfg = t_sac.SACConfig(hidden_dims=HIDDEN)
        actor = sac_state_from_numpy(np_tree(j_state), t_cfg, VIEW, 2, device="cpu").actor
        dagger.save_student(port, actor, t_cfg, VIEW, 2)
    else:
        net_params = j_ts.ThetaNet(hidden_dims=HIDDEN).init(jax.random.PRNGKey(4),
                                                            jnp.zeros((1, VIEW)))
        ref.write_bytes(serialization.msgpack_serialize({
            "kind": "theta_student", "hidden_dims": list(HIDDEN), "history_len": HISTORY,
            "params": serialization.to_state_dict(net_params)}))
        torch.save({"kind": "theta_student", "hidden_dims": list(HIDDEN),
                    "history_len": HISTORY,
                    "params": theta_net_from_flax(np_tree(net_params))}, port)
    argv = ["--model", str(ref), "--episodes", str(EPISODES), "--history", str(HISTORY),
            "--hidden", *map(str, HIDDEN), "--seed", "5", "--cpu"]
    rc, want = run_script("policy_breakdown", argv, monkeypatch)
    jp = j_evaluate._suite_env_params(
        "robustness", obs_overrides=dict(drift_obs_enabled=True, action_obs_enabled=True))
    draws = replay_draws(jax.random.PRNGKey(5), jp, EPISODES)
    params = dataclasses.replace(policy_breakdown.suite_params("robustness", False, "ema"),
                                 max_episode_steps=HORIZON)
    policy_fn, agent = policy_breakdown.load_policy(port, params, HISTORY, HIDDEN, "cpu")
    ok, dr = policy_breakdown.breakdown(policy_fn, agent, params, EPISODES, HISTORY, draws)
    _, got = captured(policy_breakdown.report, "robustness", params, ok, dr)
    assert rc == 0
    assert assert_lines_agree(got, want) >= 8


def test_ablate_dr_matches_script(tmp_path, monkeypatch):
    j_state = j_sac.init(jax.random.PRNGKey(6), 10, 2, j_sac.SACConfig(hidden_dims=HIDDEN))
    ref = tmp_path / "agent.msgpack"
    ref.write_bytes(serialization.msgpack_serialize(
        {"state": serialization.to_state_dict(j_state)}))
    to_params = j_wrappers.RocketConfig.to_env_params
    monkeypatch.setattr(j_wrappers.RocketConfig, "to_env_params", lambda self, **k: to_params(
        self, **{**k, "max_episode_steps": HORIZON}))
    argv = ["--model_path", str(ref), "--episodes", str(EPISODES), "--hidden", *map(str, HIDDEN),
            "--seed", "2", "--cpu"]
    rc, want = run_script("ablate_dr", argv, monkeypatch)
    axes = ablate_dr.axes(HORIZON)
    # the draws depend on the randomization's switches alone: every axis has
    # DR on, two have sensor noise as well
    by_noise = {noise: replay_draws(jax.random.PRNGKey(2), EnvParams(
        randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=noise),
        max_episode_steps=HORIZON), EPISODES) for noise in (False, True)}
    draws = {name: by_noise[p.randomization.sensor_noise_enabled] for name, p in axes.items()}
    cfg = t_sac.SACConfig(hidden_dims=HIDDEN)
    state = sac_state_from_numpy(np_tree(j_state), cfg, 10, 2, device="cpu")
    _, got = captured(ablate_dr.ablate, state, cfg, EPISODES, 1, 2, HORIZON, draws)
    assert rc == 0
    assert assert_lines_agree(got, want, atol=1e-3, rtol=1e-3) == len(axes)


# a tiny trainer run (tests/test_torch_hygiene.py's)
TINY = ["training.total_timesteps=128", "training.num_envs=8", "training.rollout_steps=16",
        "training.eval_episodes=2", "algorithms.sac.hidden_dims=[16,16]",
        "algorithms.sac.buffer_size=2048", "algorithms.sac.learning_starts=64",
        "algorithms.sac.batch_size=16", "curriculum.enabled=false", "logging.tensorboard=false"]


def test_train_and_evaluate_take_cpu_flag(tmp_path):
    """The reference's ``--cpu`` on ``train`` and ``evaluate``; ``--cpu``
    beside another ``--device`` is an argparse error."""
    out = tmp_path / "run"
    assert train.main(["--cpu", "--debug", "--output-dir", str(out), *TINY]) == 0
    assert (out / "checkpoints").is_dir()
    assert evaluate.main(["--model_path", str(out / "checkpoints"), "--hidden", "16", "16",
                          "--episodes_scale", "0.01", "--suite", "standard",
                          "--output_dir", str(tmp_path / "eval"), "--cpu"]) == 0
    for main, argv in ((train.main, ["--cpu", "--device", "cuda", *TINY]),
                       (evaluate.main, ["--model_path", "x", "--cpu", "--device", "cuda"])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
