"""The JAX package's flax msgpack artifacts through the port's entry points (CPU).

Each artifact is written by the JAX package at test time, at narrow widths:
the legacy ``SACAgent.save`` file (trained a few steps, with and without the
EMA actor), a DAgger ``student.msgpack`` (``scripts/dagger_distill.py``'s
``{"state": template.replace(actor_params=student)}``), a θ-student
(``scripts/theta_distill.py``'s payload) and the ensemble's
``save_checkpoint``. The port reads them through ``SACAgent.load``,
``eval.evaluate.load_agent_state``, the ``Trainer``'s warm start,
``policy_breakdown.load_policy`` and ``MultiAlgorithmAgent.load_checkpoint``;
the evaluate, export and select_student CLIs run on JAX students. The bars:
deterministic actions and twin Q 1e-6; Adam ``mu``/``nu`` and counts,
``log_alpha`` and ``step`` exact; the warm-started actor exact and the
critic fresh; the θ-net 1e-6; each ensemble member's actions 1e-6, the
windows and weights equal. An orbax checkpoint is read (its own tests are
``tests/test_torch_orbax.py``); a truncated file raises ``ValueError``.

The checked-in fixtures (``tests/fixtures/jax_msgpack/``: a default-width
256×256 legacy agent, a narrow student, a θ-student, an ensemble checkpoint
and ``expected.npz``, the JAX package's outputs on 64 fixed observations each;
``manifest.json`` names their widths) are what ``chip_smoke.py`` [20] reads on
the card. Here the port's decoder is held against
``flax.serialization.msgpack_restore`` on each, and the JAX package's and
the port's outputs against ``expected.npz``. Rewrite them with

    python tests/test_torch_jax_artifacts.py
"""

from __future__ import annotations

import functools
import json
import sys
from collections import deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_flax_msgpack import assert_trees_equal
from test_torch_parity_utils import np_tree
from tvc_ai_torch import policy_breakdown
from tvc_ai_torch.agents import ensemble as t_ens
from tvc_ai_torch.agents import legacy as t_legacy
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.agents import td3 as t_td3
from tvc_ai_torch.config import load_config
from tvc_ai_torch.convert import ensemble_carry_from_numpy, env_params_from_numpy
from tvc_ai_torch.eval.evaluate import load_agent_state
from tvc_ai_torch.evaluate import main as evaluate_main
from tvc_ai_torch.training import theta_student as t_ts
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils import flax_msgpack
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import ensemble as j_ens
from tvc_ai_tpu.agents import legacy as j_legacy
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.agents import td3 as j_td3
from tvc_ai_tpu.env.types import EnvParams
from tvc_ai_tpu.training import theta_student as j_ts

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jax_msgpack"
OBS, ACT, NARROW, ROWS = 10, 2, (32, 32), 64
ACTIONS = dict(atol=1e-6, rtol=0.0)
# the tiny trainer of tests/test_torch_trainer.py, at the student's widths
TINY = ["training.total_timesteps=32", "training.num_envs=8", "training.rollout_steps=2",
        "training.eval_episodes=2", f"algorithms.sac.hidden_dims=[{NARROW[0]},{NARROW[1]}]",
        "algorithms.sac.buffer_size=256", "algorithms.sac.learning_starts=16",
        "algorithms.sac.batch_size=8", "curriculum.enabled=false", "logging.tensorboard=false"]


# ---------------------------------------------------------------- the writers
def jax_legacy_agent(hidden, ema_decay: float = 0.0, updates: int = 3, seed: int = 1):
    """A JAX ``SACAgent`` trained ``updates`` steps on seeded transitions."""
    batch = 16 if hidden == NARROW else 256
    cfg = j_sac.SACConfig(hidden_dims=tuple(hidden), batch_size=batch, learning_starts=batch,
                          buffer_size=4 * batch, ema_decay=ema_decay)
    agent = j_legacy.SACAgent(OBS, ACT, cfg, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(batch):
        agent.store_transition(rng.normal(size=OBS), rng.uniform(-1, 1, ACT),
                               float(rng.normal()), rng.normal(size=OBS), rng.random() < 0.1)
    for _ in range(updates):
        agent.train()
    return agent


def jax_student(view_dim: int, hidden, seed: int = 2):
    """``scripts/dagger_distill.py``'s artifact: a fresh SAC template whose
    actor is the student (here another seed's actor)."""
    cfg = j_sac.SACConfig(hidden_dims=tuple(hidden))
    template = j_sac.init(jax.random.PRNGKey(seed), view_dim, ACT, cfg)
    student = j_sac.init(jax.random.PRNGKey(seed + 100), view_dim, ACT, cfg).actor_params
    state = template.replace(actor_params=student)
    return state, serialization.msgpack_serialize(
        {"state": serialization.to_state_dict(state)})


def jax_theta_student(view_dim: int, hidden, history: int, seed: int = 3):
    """``scripts/theta_distill.py``'s payload around a seeded θ-net."""
    params = j_ts.ThetaNet(hidden_dims=tuple(hidden)).init(jax.random.PRNGKey(seed),
                                                           jnp.zeros((1, view_dim)))
    return params, serialization.msgpack_serialize({
        "kind": "theta_student", "hidden_dims": list(hidden), "history_len": history,
        "params": serialization.to_state_dict(params)})


def ensemble_configs(hidden):
    return (j_ens.EnsembleConfig(sac=j_sac.SACConfig(hidden_dims=tuple(hidden)),
                                 td3=j_td3.TD3Config(hidden_dims=tuple(hidden)),
                                 ppo=j_ppo.PPOConfig(hidden_dims=tuple(hidden))),
            t_ens.EnsembleConfig(sac=t_sac.SACConfig(hidden_dims=tuple(hidden)),
                                 td3=t_td3.TD3Config(hidden_dims=tuple(hidden)),
                                 ppo=t_ppo.PPOConfig(hidden_dims=tuple(hidden))))


def _perturbed(tree, key):
    """Every float leaf moved by seeded noise and every integer leaf (Adam
    counts, steps) raised by 3, so that no value of a fresh state (zero
    moments, zero counts) hides a mapping error."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = [x + 3 if jnp.issubdtype(x.dtype, jnp.integer)
           else x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
           for x, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, out)


@functools.cache
def jax_ensemble(hidden: tuple, n_envs: int = 4, seed: int = 4):
    """A JAX ``MultiAlgorithmAgent`` with a perturbed carry and some
    performance history, as ``save_checkpoint`` sees it (built once: its
    ``init_carry`` compiles for seconds)."""
    j_cfg, _ = ensemble_configs(hidden)
    carry = jax.jit(lambda k: j_ens.init_carry(k, EnvParams(), j_cfg, n_envs))(
        jax.random.PRNGKey(seed))
    members = {m: _perturbed(getattr(carry, m), jax.random.PRNGKey(seed + i))
               for i, m in enumerate(("sac", "td3", "ppo"))}
    agent = j_ens.MultiAlgorithmAgent(config=j_cfg, seed=seed)
    agent.attach_carry(carry.replace(**members))
    for algo, reward in (("sac", 3.0), ("ppo", -1.0), ("td3", 0.5), ("sac", 2.0)):
        agent.update_performance(algo, reward)
    return agent


def jax_actions(agent, obs: np.ndarray) -> np.ndarray:
    return np.stack([agent.select_action(o, deterministic=True) for o in obs])


def jax_state_actions(state, cfg, obs: np.ndarray) -> np.ndarray:
    mean, _ = j_sac.make_networks(obs.shape[-1], ACT, cfg)[0].apply(state.actor_params, obs)
    return np.asarray(jnp.tanh(mean))


def jax_member_actions(agent, obs: np.ndarray) -> dict[str, np.ndarray]:
    return {a: np.asarray(agent.get_action(obs, deterministic=True, algorithm=a)[0])
            for a in ("sac", "td3", "ppo")}


def port_actions(actor, obs: np.ndarray) -> np.ndarray:
    return t_sac.select_action(actor, torch.from_numpy(obs), deterministic=True).numpy()


def theta_view_dim(history: int) -> int:
    from tvc_ai_torch.env.types import obs_dim

    return obs_dim(policy_breakdown.suite_params("robustness", False, "ema")) * history


def write_fixtures(directory: Path = FIXTURES) -> None:
    """Write the fixtures with the JAX package (a few seconds on a CPU)."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    manifest, expected = {}, {}
    legacy = jax_legacy_agent((256, 256), updates=2)
    legacy.save(directory / "legacy_agent.msgpack")
    expected["legacy_obs"] = rng.normal(size=(ROWS, OBS)).astype(np.float32)
    expected["legacy_actions"] = jax_actions(legacy, expected["legacy_obs"])
    manifest["legacy"] = {"file": "legacy_agent.msgpack", "obs_dim": OBS,
                          "hidden_dims": [256, 256], "total_steps": legacy.total_steps}
    state, raw = jax_student(OBS, NARROW)
    (directory / "student.msgpack").write_bytes(raw)
    expected["student_obs"] = rng.normal(size=(ROWS, OBS)).astype(np.float32)
    expected["student_actions"] = jax_state_actions(
        state, j_sac.SACConfig(hidden_dims=NARROW), expected["student_obs"])
    manifest["student"] = {"file": "student.msgpack", "obs_dim": OBS, "history_len": 1,
                           "hidden_dims": list(NARROW)}
    view = theta_view_dim(2)
    params, raw = jax_theta_student(view, NARROW, 2)
    (directory / "theta_student.msgpack").write_bytes(raw)
    expected["theta_obs"] = rng.normal(size=(ROWS, view)).astype(np.float32)
    expected["theta_out"] = np.asarray(
        j_ts.ThetaNet(hidden_dims=NARROW).apply(params, expected["theta_obs"]))
    manifest["theta"] = {"file": "theta_student.msgpack", "view_dim": view, "history_len": 2,
                         "hidden_dims": list(NARROW)}
    ens = jax_ensemble(NARROW)
    ens.save_checkpoint(directory / "ensemble_final.msgpack")
    expected["ensemble_obs"] = rng.normal(size=(ROWS, OBS)).astype(np.float32)
    for a, v in jax_member_actions(ens, expected["ensemble_obs"]).items():
        expected[f"ensemble_{a}"] = v
    manifest["ensemble"] = {"file": "ensemble_final.msgpack", "obs_dim": OBS,
                            "hidden_dims": list(NARROW),
                            "performance_history": {a: list(h) for a, h
                                                    in ens.performance_history.items()},
                            "algorithm_weights": ens.algorithm_weights}
    np.savez(directory / "expected.npz", **expected)
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=2) + "\n")


# ------------------------------------------------------------- helpers
def flax_leaf(tree: dict, name: str) -> np.ndarray:
    """The flax leaf of a torch parameter name (``q1.hidden_0.weight`` →
    ``params/q1/hidden_0/kernel``, transposed)."""
    *path, kind = name.split(".")
    node = tree["params"] if "params" in tree else tree
    for part in path:
        node = node[part]
    return np.asarray(node["kernel"]).T if kind == "weight" else np.asarray(node["bias"])


def assert_adam_equal(opt, module: torch.nn.Module, adam) -> None:
    """A port ``AdamState`` equal to optax's ``ScaleByAdamState``, leaf by leaf."""
    assert opt.count == int(adam.count)
    for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        for got, (name, _) in zip(moments, module.named_parameters(), strict=True):
            np.testing.assert_array_equal(got.numpy(), flax_leaf(tree, name), err_msg=name)


def assert_sac_state_equal(got: t_sac.SACState, want, cfg, obs: np.ndarray) -> None:
    """Actions and twin Q at 1e-6, Adam, ``log_alpha`` and ``step`` exact."""
    np.testing.assert_allclose(port_actions(got.actor, obs),
                               jax_state_actions(want, cfg, obs), **ACTIONS)
    act = np.tanh(obs[:, :ACT])
    _, critic = j_sac.make_networks(obs.shape[-1], ACT, cfg)
    for mine, params in ((got.critic, want.critic_params),
                         (got.target_critic, want.target_critic_params)):
        with torch.no_grad():
            q = mine(torch.from_numpy(obs), torch.from_numpy(act))
        for a, b in zip(q, critic.apply(params, obs, act), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(-1), **ACTIONS)
    adam = lambda opt: opt[1][0]  # noqa: E731 -- chain(clip, adam(schedule))
    assert_adam_equal(got.actor_opt, got.actor, adam(want.actor_opt))
    assert_adam_equal(got.critic_opt, got.critic, adam(want.critic_opt))
    alpha = want.alpha_opt[0]
    assert got.alpha_opt.count == int(alpha.count)
    np.testing.assert_array_equal(got.alpha_opt.mu[0].numpy(), np.asarray(alpha.mu))
    np.testing.assert_array_equal(got.alpha_opt.nu[0].numpy(), np.asarray(alpha.nu))
    np.testing.assert_array_equal(got.log_alpha.numpy(), np.asarray(want.log_alpha))
    assert got.step == int(want.step)
    if want.ema_actor_params is not None:
        np.testing.assert_allclose(
            port_actions(got.ema_actor, obs),
            jax_state_actions(want.replace(actor_params=want.ema_actor_params), cfg, obs),
            **ACTIONS)


# ------------------------------------------------------------ the artifacts
@pytest.mark.parametrize("ema", [0.0, 0.99], ids=["plain", "ema"])
def test_legacy_agent_file_loads_whole(ema, tmp_path):
    ref = jax_legacy_agent(NARROW, ema_decay=ema)
    path = tmp_path / "agent.msgpack"
    ref.save(path)
    cfg = t_sac.SACConfig(hidden_dims=NARROW, ema_decay=ema)
    agent = t_legacy.SACAgent(OBS, ACT, cfg, device="cpu")
    agent.load(path)
    obs = np.random.default_rng(5).normal(size=(ROWS, OBS)).astype(np.float32)
    assert_sac_state_equal(agent.state, ref.state, ref.config, obs)
    assert agent.total_steps == ref.total_steps == 16 and agent.state.step == 3
    np.testing.assert_allclose(np.stack([agent.select_action(o, deterministic=True)
                                         for o in obs]), jax_actions(ref, obs), **ACTIONS)
    loaded = load_agent_state(path, OBS, ACT, cfg, device="cpu")
    assert diff_states(loaded, agent.state) == []
    payload = t_legacy.read_agent_file(path)
    assert (payload["obs_dim"], payload["action_dim"], payload["total_steps"]) == (OBS, ACT, 16)


def test_student_file_through_load_agent_state(tmp_path):
    state, raw = jax_student(OBS, NARROW)
    path = tmp_path / "student.msgpack"
    path.write_bytes(raw)
    cfg = t_sac.SACConfig(hidden_dims=NARROW)
    got = load_agent_state(path, OBS, ACT, cfg, device="cpu")
    obs = np.random.default_rng(6).normal(size=(ROWS, OBS)).astype(np.float32)
    assert_sac_state_equal(got, state, j_sac.SACConfig(hidden_dims=NARROW), obs)
    # no obs_dim / action_dim / total_steps in a student: inferred, and 0
    payload = t_legacy.read_agent_file(path)
    assert (payload["obs_dim"], payload["action_dim"], payload["total_steps"]) == (OBS, ACT, 0)
    # the state alone (no "state" key) reads as the reference reads it
    bare = tmp_path / "bare.msgpack"
    bare.write_bytes(serialization.msgpack_serialize(serialization.to_state_dict(state)))
    assert diff_states(load_agent_state(bare, OBS, ACT, cfg, device="cpu"), got) == []
    # a config of other widths does not fit the file
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_agent_state(path, OBS, ACT, t_sac.SACConfig(hidden_dims=(16, 16)), device="cpu")
    # a truncated file is refused, never read in part
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="truncated"):
        load_agent_state(cut, OBS, ACT, cfg, device="cpu")


def test_warm_start_from_jax_student(tmp_path):
    state, raw = jax_student(OBS, NARROW)
    path = tmp_path / "student.msgpack"
    path.write_bytes(raw)
    cfg = load_config(None, [*TINY, f"training.warm_start_actor={path}",
                             "algorithms.sac.ema_decay=0.99"])
    tr = Trainer(cfg, output_dir=tmp_path / "warm", device="cpu")
    fresh = Trainer(load_config(None, [*TINY, "algorithms.sac.ema_decay=0.99"]),
                    output_dir=tmp_path / "fresh", device="cpu")
    obs = np.random.default_rng(7).normal(size=(ROWS, OBS)).astype(np.float32)
    want = jax_state_actions(state, j_sac.SACConfig(hidden_dims=NARROW), obs)
    agent = tr.carry.agent
    np.testing.assert_allclose(port_actions(agent.actor, obs), want, **ACTIONS)
    assert diff_states(agent.ema_actor, agent.actor) == []
    for name in ("critic", "target_critic", "actor_opt", "critic_opt", "log_alpha"):
        assert diff_states(getattr(agent, name), getattr(fresh.carry.agent, name)) == [], name
    assert diff_states(agent.actor, fresh.carry.agent.actor) != []
    tr.logger.close()
    fresh.logger.close()
    wide, _ = jax_student(OBS, (16, 16))
    (tmp_path / "wide.msgpack").write_bytes(_)
    cfg = load_config(None, [*TINY, f"training.warm_start_actor={tmp_path / 'wide.msgpack'}"])
    with pytest.raises(ValueError, match="actor shape mismatch"):
        Trainer(cfg, output_dir=tmp_path / "x", device="cpu")


def test_theta_student_through_policy_breakdown(tmp_path):
    history = 2
    view = theta_view_dim(history)
    params, raw = jax_theta_student(view, NARROW, history)
    path = tmp_path / "theta_student.msgpack"
    path.write_bytes(raw)
    suite = policy_breakdown.suite_params("robustness", False, "ema")
    _, net = policy_breakdown.load_policy(path, suite, history, [256, 256], "cpu")
    assert isinstance(net, t_ts.ThetaNet) and net.hidden_dims == NARROW
    obs = np.random.default_rng(8).normal(size=(ROWS, view)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(obs)).numpy()
    want = np.asarray(j_ts.ThetaNet(hidden_dims=NARROW).apply(params, obs))
    np.testing.assert_allclose(got, want, **ACTIONS)


def test_ensemble_checkpoint_from_jax(tmp_path):
    ref = jax_ensemble(NARROW)
    path = tmp_path / "ensemble_final.msgpack"
    ref.save_checkpoint(path)
    _, t_cfg = ensemble_configs(NARROW)
    port = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    carry = t_ens.init_carry(env_params_from_numpy(EnvParams()), t_cfg, 4, device="cpu", seed=2)
    port.attach_carry(carry)
    obs_before = carry.obs.clone()
    port.load_checkpoint(path)
    obs = np.random.default_rng(9).normal(size=(ROWS, OBS)).astype(np.float32)
    want = jax_member_actions(ref, obs)
    for algo in ("sac", "td3", "ppo"):
        got, info = port.get_action(obs, deterministic=True, algorithm=algo)
        assert info == {"algorithm": algo}
        np.testing.assert_allclose(got, want[algo], **ACTIONS, err_msg=algo)
    assert port.performance_history == ref.performance_history
    assert port.algorithm_weights == ref.algorithm_weights
    assert port.carry.sac.step == int(ref.carry.sac.step) == 3
    assert port.carry.ppo.opt.count == int(ref.carry.ppo.opt_state[1][0].count)
    assert_adam_equal(port.carry.td3.critic_opt, port.carry.td3.critic,
                      ref.carry.td3.critic_opt[1][0])
    assert torch.equal(port.carry.obs, obs_before)   # the env side is not in the file
    # without a carry only the windows and the weights are restored
    bare = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    bare.load_checkpoint(path)
    assert bare.carry is None and bare.algorithm_weights == ref.algorithm_weights
    assert bare.performance_history == {a: deque(h, maxlen=t_cfg.performance_window)
                                        for a, h in ref.performance_history.items()}


def test_ensemble_carry_takes_the_state_dict_form():
    _, t_cfg = ensemble_configs(NARROW)
    carry = jax_ensemble(NARROW).carry
    attrs = ensemble_carry_from_numpy(np_tree(carry), t_cfg, device="cpu")
    state_dict = serialization.msgpack_restore(serialization.msgpack_serialize(
        serialization.to_state_dict(carry)))
    assert diff_states(ensemble_carry_from_numpy(state_dict, t_cfg, device="cpu"), attrs) == []


def test_evaluate_command_on_a_jax_student(tmp_path, capsys):
    _, raw = jax_student(OBS, NARROW)
    path = tmp_path / "student.msgpack"
    path.write_bytes(raw)
    out = tmp_path / "eval"
    rc = evaluate_main(["--model_path", str(path), "--hidden", *map(str, NARROW), "--cpu",
                        "--suite", "stress", "--episodes_scale", "0.04",
                        "--output_dir", str(out)])
    assert rc == 0
    assert (out / "stress_episodes.csv").exists()
    assert "stress: success" in capsys.readouterr().out


def test_export_command_on_a_jax_student(tmp_path, capsys):
    pytest.importorskip("tensorflow")
    from tvc_ai_torch.export.__main__ import load_actor_params
    from tvc_ai_torch.export.__main__ import main as export_main

    state, raw = jax_student(OBS, NARROW)
    path = tmp_path / "student.msgpack"
    path.write_bytes(raw)
    obs = np.random.default_rng(5).standard_normal((ROWS, OBS)).astype(np.float32)
    actor = load_actor_params(str(path), OBS, ACT, NARROW, device="cpu")
    np.testing.assert_allclose(port_actions(actor, obs), jax_state_actions(
        state, j_sac.SACConfig(hidden_dims=NARROW), obs), **ACTIONS)
    out = tmp_path / "export"
    assert export_main(["--model_path", str(path), "--output_dir", str(out),
                        "--obs_dim", str(OBS), "--hidden", *map(str, NARROW),
                        "--generate_c_array", "--cpu"]) == 0
    printed = capsys.readouterr().out
    line = next(l for l in printed.splitlines() if l.startswith("int8 parity: max |Δa| = "))
    assert float(line.split("= ")[1].split()[0]) <= 0.1 and "WARNING" not in printed
    for name in ("tvc_actor_default.tflite", "tvc_model_data.cc", "tvc_model_data.h",
                 "inference_example.cpp"):
        assert (out / name).exists(), name


def test_select_student_takes_jax_students(tmp_path, capsys):
    from tvc_ai_torch import select_student

    view = theta_view_dim(1)   # the suite's student view at history 1
    for seed in (2, 3):
        (tmp_path / f"student_{seed:03d}.msgpack").write_bytes(jax_student(view, (8, 8), seed)[1])
    rc = select_student.main(["--cpu", "--dir", str(tmp_path), "--episodes", "2",
                              "--confirm_episodes", "2", "--history", "1", "--hidden", "8", "8"])
    assert rc == 0
    winner = json.loads((tmp_path / "selection_robustness.json").read_text())["winner"]
    assert (tmp_path / "student_selected_robustness.msgpack").read_bytes() == (
        tmp_path / winner["candidate"]).read_bytes()
    assert "winner student_00" in capsys.readouterr().out


def test_orbax_checkpoint_names_the_recipe(tmp_path):
    """The orbax checkpoint that once raised with the msgpack recipe is read:
    its manager root and its step directory, the tree as orbax wrote it
    (``tests/test_torch_orbax.py`` holds the reader to orbax's restore)."""
    from tvc_ai_torch.utils.checkpoint import CheckpointManager as TCheckpointManager
    from tvc_ai_tpu.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(tmp_path / "orbax")
    mngr.save(8, {"w": jnp.ones((2, 3))})
    mngr.wait()
    mngr.close()
    for path in (tmp_path / "orbax", tmp_path / "orbax" / "8"):
        reader, step = TCheckpointManager.locate(path)
        assert step == 8 and reader.host(8) == {}
        tree = reader.read(step)
        assert set(tree) == {"w"} and tree["w"].dtype == np.float32
        np.testing.assert_array_equal(tree["w"], np.ones((2, 3), np.float32))
        with pytest.raises(KeyError, match="agent"):   # no SAC agent in this tree
            load_agent_state(path, OBS, ACT, t_sac.SACConfig(hidden_dims=NARROW), device="cpu")


# ---------------------------------------------------------- the fixtures
@functools.cache
def fixtures() -> tuple[dict, dict]:
    """(manifest, expected outputs) of the checked-in fixtures."""
    with np.load(FIXTURES / "expected.npz") as npz:
        expected = dict(npz)
    return json.loads((FIXTURES / "manifest.json").read_text()), expected


@pytest.mark.parametrize("kind", ["legacy", "student", "theta", "ensemble"])
def test_fixture_decodes_as_flax(kind):
    manifest, _ = fixtures()
    raw = (FIXTURES / manifest[kind]["file"]).read_bytes()
    assert flax_msgpack.is_flax_msgpack(FIXTURES / manifest[kind]["file"])
    assert_trees_equal(flax_msgpack.msgpack_restore(raw), serialization.msgpack_restore(raw))


def fixture_outputs_jax(kind: str) -> dict[str, np.ndarray]:
    """The JAX package's outputs on the fixture's observations, from its file."""
    manifest, expected = fixtures()
    spec, path = manifest[kind], FIXTURES / manifest[kind]["file"]
    hidden = tuple(spec["hidden_dims"])
    if kind == "legacy":
        agent = j_legacy.SACAgent(OBS, ACT, j_sac.SACConfig(hidden_dims=hidden))
        agent.load(path)
        return {"legacy_actions": jax_actions(agent, expected["legacy_obs"])}
    if kind == "student":
        cfg = j_sac.SACConfig(hidden_dims=hidden)
        template = j_sac.init(jax.random.PRNGKey(0), OBS, ACT, cfg)
        state = serialization.from_state_dict(
            template, serialization.msgpack_restore(path.read_bytes())["state"])
        return {"student_actions": jax_state_actions(state, cfg, expected["student_obs"])}
    if kind == "theta":
        raw = serialization.msgpack_restore(path.read_bytes())
        net = j_ts.ThetaNet(hidden_dims=hidden)
        params = serialization.from_state_dict(
            net.init(jax.random.PRNGKey(0), jnp.zeros((1, spec["view_dim"]))), raw["params"])
        return {"theta_out": np.asarray(net.apply(params, expected["theta_obs"]))}
    j_cfg, _ = ensemble_configs(hidden)
    agent = j_ens.MultiAlgorithmAgent(config=j_cfg)
    agent.attach_carry(jax_ensemble(hidden).carry)   # members replaced by the file's
    agent.load_checkpoint(path)
    return {f"ensemble_{a}": v
            for a, v in jax_member_actions(agent, expected["ensemble_obs"]).items()}


def fixture_outputs_port(kind: str) -> dict[str, np.ndarray]:
    """The port's outputs on the fixture's observations, through its entry points."""
    manifest, expected = fixtures()
    spec, path = manifest[kind], FIXTURES / manifest[kind]["file"]
    hidden = tuple(spec["hidden_dims"])
    if kind == "legacy":
        agent = t_legacy.SACAgent(OBS, ACT, t_sac.SACConfig(hidden_dims=hidden), device="cpu")
        agent.load(path)
        assert agent.total_steps == spec["total_steps"]
        return {"legacy_actions": port_actions(agent.actor, expected["legacy_obs"])}
    if kind == "student":
        state = load_agent_state(path, OBS, ACT, t_sac.SACConfig(hidden_dims=hidden), "cpu")
        return {"student_actions": port_actions(state.actor, expected["student_obs"])}
    if kind == "theta":
        suite = policy_breakdown.suite_params("robustness", False, "ema")
        _, net = policy_breakdown.load_policy(path, suite, spec["history_len"], [], "cpu")
        with torch.no_grad():
            return {"theta_out": net(torch.from_numpy(expected["theta_obs"])).numpy()}
    _, t_cfg = ensemble_configs(hidden)
    agent = t_ens.MultiAlgorithmAgent(config=t_cfg, device="cpu")
    agent.attach_carry(t_ens.init_carry(env_params_from_numpy(EnvParams()), t_cfg, 4,
                                        device="cpu"))
    agent.load_checkpoint(path)
    assert {a: list(h) for a, h in agent.performance_history.items()} == \
        spec["performance_history"]
    assert agent.algorithm_weights == spec["algorithm_weights"]
    return {f"ensemble_{a}": agent.get_action(expected["ensemble_obs"], deterministic=True,
                                              algorithm=a)[0] for a in ("sac", "td3", "ppo")}


@pytest.mark.parametrize("kind", ["legacy", "student", "theta", "ensemble"])
def test_fixture_outputs_match_expected(kind):
    _, expected = fixtures()
    for name, got in fixture_outputs_jax(kind).items():
        np.testing.assert_allclose(got, expected[name], **ACTIONS, err_msg=f"JAX {name}")
    for name, got in fixture_outputs_port(kind).items():
        np.testing.assert_allclose(got, expected[name], **ACTIONS, err_msg=f"port {name}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixtures(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES)
