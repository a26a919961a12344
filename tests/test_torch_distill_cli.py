"""The distillation chain's command-line modules and the student artifact.

- Each ``python -m tvc_ai_torch.<name>`` module runs in-process with
  ``--cpu`` at tiny sizes and exits 0: ``dagger_distill`` (both teachers,
  ``--save_every``), ``theta_distill``, ``select_student`` (on the DAgger
  run's files), ``suite_feasibility`` (fixed, ``--scheduled``, ``--cem
  --reroll --student_view``), ``cross_transfer``, ``build_ctrl_library``
  (its ``.npz`` keys as the reference's) and ``pilot_eval`` (library
  selection and CEM replans). The schedule each designs is cut to a 3 × 3
  grid with a short verification (its parity is
  ``tests/test_torch_lqr_schedule.py``).
- Without ``--cpu`` they ask for the card (``tests/test_torch_hygiene.py``).
- ``student.pt`` round-trips through ``eval.evaluate.load_agent_state``;
  ``training.warm_start_actor`` sets the actor (and the EMA actor) to the
  student bit for bit and leaves the critic fresh, raises ``ValueError`` on
  a shape mismatch and on a flax msgpack file that holds no SACState (the
  JAX package's students themselves are read: ``test_torch_jax_artifacts.py``);
  ``robust_student_ft_r5.yaml`` (the port's copy, only the student's path
  changed) builds as the JAX package's and trains warm-started at tiny
  sizes.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_trainer import tiny_cfg, tiny_overrides
from tvc_ai_torch import build_ctrl_library, cross_transfer, dagger_distill, pilot_eval
from tvc_ai_torch import select_student, suite_feasibility, theta_distill
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.config.build import build_env_params, build_loop_config, build_sac_config
from tvc_ai_torch.eval import evaluate as t_evaluate
from tvc_ai_torch.eval.evaluate import load_agent_state
from tvc_ai_torch.training import dagger as t_dagger
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_torch.training.theta_student import ThetaNet
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import diff_states

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
LIBRARY = str(ROOT / "tvc_ai_torch" / "data" / "ctrl_library_robustness.npz")
CEM_TINY = ["--cem_pop", "2", "--cem_gens", "1", "--cem_horizon", "8"]


@pytest.fixture(autouse=True)
def small_schedule(monkeypatch):
    """Every CLI designs its schedule at 3 × 3 with a short verification."""
    monkeypatch.setattr(t_demos, "design_lqr_schedule", functools.partial(
        t_demos.design_lqr_schedule, n_mass=3, n_tscale=3, verify_rollouts=1,
        verify_horizon=60))


def easy_suite(monkeypatch):
    """The suites on the nominal plant from slightly tilted starts (a 3 × 3
    schedule's nominal cell wins them), so the CEM solves draws."""
    original = t_evaluate._suite_env_params

    def easy(name, *args, **kw):
        p = original(name, *args, **kw)
        return dataclasses.replace(p, randomization=dataclasses.replace(
            p.randomization, mass_variation=0.0, thrust_variation=0.0, cg_offset_max=0.0,
            wind_max=0.0, init_tilt_max=0.02))
    monkeypatch.setattr(t_evaluate, "_suite_env_params", easy)


@pytest.fixture(scope="module")
def dagger_run(tmp_path_factory):
    """One scheduled-teacher DAgger run with ``--save_every 1``."""
    out = tmp_path_factory.mktemp("dagger")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_demos, "design_lqr_schedule", functools.partial(
            t_demos.design_lqr_schedule, n_mass=3, n_tscale=3, verify_rollouts=1,
            verify_horizon=60))
        rc = dagger_distill.main([
            "--cpu", "--out", str(out), "--teacher", "scheduled", "--iters", "2", "--envs", "4",
            "--rollout_steps", "4", "--train_steps", "2", "--batch", "8", "--history", "2",
            "--hidden", "8", "8", "--eval_episodes", "2", "--save_every", "1", "--lr_cosine"])
    assert rc == 0
    return out


def test_dagger_distill_writes_a_student(dagger_run, capsys):
    names = sorted(p.name for p in dagger_run.iterdir())
    assert {"history.json", "student.pt", "student_000.pt", "student_001.pt"} <= set(names)
    # the artifact is a whole SAC state the evaluation entry points read
    state = load_agent_state(dagger_run / "student.pt", 16 * 2, 2, t_sac.SACConfig((8, 8)),
                             "cpu")
    assert state.actor.hidden_0.weight.shape == (8, 32)
    fresh = t_sac.init(32, 2, t_sac.SACConfig((8, 8)), "cpu", seed=0)
    assert diff_states(state.critic, fresh.critic) == []   # the critic is the template's


def test_dagger_distill_cem_teacher(tmp_path, capsys):
    rc = dagger_distill.main([
        "--cpu", "--out", str(tmp_path), "--iters", "1", "--envs", "4", "--rollout_steps", "4",
        "--train_steps", "2", "--batch", "8", "--history", "2", "--hidden", "8", "8",
        "--eval_episodes", "2", "--cg_offset_max", "0.0", *CEM_TINY])
    assert rc == 0
    out = capsys.readouterr().out
    assert "teacher_solved=" in out and "robust_cg0=" in out and "best: {" in out


def test_theta_distill_writes_its_student(tmp_path):
    rc = theta_distill.main([
        "--cpu", "--out", str(tmp_path), "--iters", "1", "--envs", "4", "--rollout_steps", "4",
        "--train_steps", "2", "--batch", "8", "--history", "2", "--hidden", "8", "8",
        "--eval_episodes", "2", *CEM_TINY])
    assert rc == 0
    payload = torch.load(tmp_path / "theta_student.pt", weights_only=True)
    assert payload["kind"] == "theta_student" and payload["history_len"] == 2
    assert payload["scale"].shape == (10,) and payload["config"]["hidden_dims"] == (8, 8)
    net = ThetaNet(payload["obs_dim"] * payload["history_len"], payload["hidden_dims"], device="cpu")
    net.load_state_dict(payload["params"])
    assert net(torch.zeros(1, 32)).shape == (1, 10)


def test_select_student(dagger_run, capsys):
    rc = select_student.main(["--cpu", "--dir", str(dagger_run), "--episodes", "2",
                              "--confirm_episodes", "2", "--history", "2", "--hidden", "8", "8"])
    assert rc == 0
    assert (dagger_run / "student_selected_robustness.pt").exists()
    assert "winner student" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["fixed", "scheduled", "cem"])
def test_suite_feasibility(mode, capsys):
    extra = {"fixed": [], "scheduled": ["--scheduled"],
             "cem": ["--cem", *CEM_TINY, "--reroll", "1", "--obs_noise", "0.02",
                     "--student_view"]}[mode]
    rc = suite_feasibility.main(["--cpu", "--suite", "robustness", "--episodes", "4",
                                 "--steps", "20", *extra])
    assert rc == 0
    out = capsys.readouterr().out
    assert "physics-infeasible" in out and "strict success" in out
    assert ("honest re-rolled ceiling" in out) == (mode == "cem")


def test_cross_transfer_and_library(monkeypatch, tmp_path, capsys):
    easy_suite(monkeypatch)
    solve = ["--cem_pop", "2", "--cem_gens", "1", "--cem_horizon", "250"]
    assert cross_transfer.main(["--cpu", "--episodes", "3", *solve]) == 0
    assert "greedy cover of 90% needs" in capsys.readouterr().out
    out = tmp_path / "lib.npz"
    assert build_ctrl_library.main(["--cpu", "--episodes", "3", "--fresh", "2", "--k", "2",
                                    "--out", str(out), "--obs_noise", "0.0", *solve]) == 0
    with np.load(out) as lib, np.load(LIBRARY) as ref:
        assert sorted(lib.files) == sorted(ref.files)
        assert lib["theta"].dtype == np.float32 and lib["theta"].shape[1] == 15


@pytest.mark.parametrize("mode", ["library", "replan"])
def test_pilot_eval(mode, capsys):
    extra = (["--library", LIBRARY, "--select", "10", "--select_samples", "2",
              "--select_horizon", "20"] if mode == "library"
             else ["--replan", "10", *CEM_TINY, "--diag"])
    rc = pilot_eval.main(["--cpu", "--episodes", "2", "--particles", "4", "--steps", "30",
                          *extra])
    assert rc == 0
    out = capsys.readouterr().out
    assert "pilot strict success" in out and "[pilot: 30 filter steps" in out


def _student(path, view_dim: int, hidden, seed: int = 5):
    cfg = t_sac.SACConfig(hidden_dims=hidden)
    actor = t_sac.make_actor(view_dim, 2, cfg, "cpu", seed=seed)
    t_dagger.save_student(path, actor, cfg, view_dim, 2)
    return actor


def test_warm_start_actor_sets_the_student(tmp_path):
    student = _student(tmp_path / "student.pt", 10, (16, 16))
    cfg = tiny_cfg(tmp_path, extra=[f"training.warm_start_actor={tmp_path / 'student.pt'}",
                                    "algorithms.sac.ema_decay=0.99"])
    t = Trainer(cfg, output_dir=tmp_path / "warm", device="cpu")
    agent = t.carry.agent
    assert diff_states(agent.actor, student) == [] and diff_states(agent.ema_actor, student) == []
    fresh = Trainer(tiny_cfg(tmp_path), output_dir=tmp_path / "cold", device="cpu").carry.agent
    assert diff_states(agent.critic, fresh.critic) == []
    assert diff_states(agent.actor, fresh.actor) != []
    t.logger.close()


def test_warm_start_actor_refusals(tmp_path):
    _student(tmp_path / "narrow.pt", 10, (8, 8))
    cfg = tiny_cfg(tmp_path, extra=[f"training.warm_start_actor={tmp_path / 'narrow.pt'}"])
    with pytest.raises(ValueError, match="actor shape mismatch"):
        Trainer(cfg, output_dir=tmp_path / "x", device="cpu")
    (tmp_path / "student.msgpack").write_bytes(b"\x81\xa5state\x80")
    cfg = tiny_cfg(tmp_path, extra=[f"training.warm_start_actor={tmp_path / 'student.msgpack'}"])
    with pytest.raises(ValueError, match="no actor_params"):
        Trainer(cfg, output_dir=tmp_path / "y", device="cpu")


def test_student_finetune_yaml_copy_builds_as_in_jax():
    from tvc_ai_tpu.config import build as j_build
    from tvc_ai_tpu.config import loader as j_loader

    name = "robust_student_ft_r5.yaml"
    port_path = ROOT / "tvc_ai_torch" / "config" / name
    ref_path = ROOT / "tvc_ai_tpu" / "config" / name
    header, body = port_path.read_text().split("\n", 1)
    assert header.startswith(f"# The port's copy of tvc_ai_tpu/config/{name}")
    assert body == ref_path.read_text().replace("outputs/dagger_r5/student.msgpack",
                                                "outputs/dagger_r5/student.pt")
    port, ref = t_loader.load_config(port_path), j_loader.load_config(ref_path)
    assert port.training.warm_start_actor == "outputs/dagger_r5/student.pt"
    port.training.warm_start_actor = ref.training.warm_start_actor
    assert port.to_dict() == ref.to_dict()
    t_sac_cfg, j_sac_cfg = build_sac_config(port), j_build.build_sac_config(ref)
    for f in dataclasses.fields(t_sac.SACConfig):
        assert getattr(t_sac_cfg, f.name) == getattr(j_sac_cfg, f.name), f.name
    assert build_loop_config(port).history_len == 8 and build_env_params(port).drift_obs_enabled


def test_student_finetune_yaml_trains_warm_started(tmp_path):
    path = tmp_path / "student.pt"
    student = _student(path, 16 * 8, (256, 256))
    cfg = t_loader.load_config(
        ROOT / "tvc_ai_torch" / "config" / "robust_student_ft_r5.yaml",
        [o for o in tiny_overrides(tmp_path, 64) if "hidden_dims" not in o]
        + [f"training.warm_start_actor={path}", "training.rollout_steps=4",
           "training.updates_per_step=1", "algorithms.sac.batch_size=16",
           "algorithms.sac.learning_starts=16"])
    t = Trainer(cfg, output_dir=tmp_path / "ft", device="cpu")
    assert diff_states(t.carry.agent.actor, student) == []
    result = t.train()
    assert result["env_steps"] >= 64
    assert diff_states(t.carry.agent.actor, student) != []   # it trained from the student
    t.logger.close()
