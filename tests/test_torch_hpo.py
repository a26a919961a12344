"""The hyperparameter search of tvc_ai_torch against the JAX package (CPU).

``run_study`` with the reference test's pure-Python objective in both
packages writes byte-equal ``trials.json``, ``best_params.json`` and
``trials.csv``; ``make_sac_objective`` builds the reference's ``SACConfig``
and ``TrainLoopConfig`` (the reference's captured from its ``init_carry``,
which is patched to record and stop, so nothing compiles) and reports at
the reference's rungs (the reference's objective run with its training and
evaluation patched out); the port's objective trains and scores on the CPU
at a tiny size and prunes; the command runs two tiny trials.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import random
import types

import jax
import numpy as np
import pytest

from tvc_ai_torch import tune_hyperparameters
from tvc_ai_torch.tuning import hpo as t_hpo
from tvc_ai_tpu.tuning import hpo as j_hpo

TINY = dict(total_steps=4 * 64 * 5, num_envs=4, eval_every_fraction=0.5, eval_episodes=2)
FIXED = dict(lr_actor=3e-4, lr_critic=3e-4, lr_alpha=3e-4, gamma=0.99, tau=0.005,
             batch_size=128, hidden_dim=128)


class FixedTrial:
    """A trial that suggests ``FIXED`` and records its reports."""

    def __init__(self, number: int = 0, prune: bool = False):
        self.number, self.prune = number, prune
        self.reports: list[tuple[int, float]] = []

    def suggest_float(self, name, low, high, log=False):
        return FIXED[name]

    def suggest_categorical(self, name, choices):
        assert FIXED[name] in choices
        return FIXED[name]

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return self.prune


def toy_objective(pruned_cls):
    """The reference test's objective (tests/test_training_subsystems.py)."""
    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        cat = trial.suggest_categorical("c", [1, 2, 3])
        for step in range(3):
            trial.report(x * 10 + cat, step)
            if trial.should_prune():
                raise pruned_cls()
        return x * 10 + cat

    return objective


@pytest.mark.parametrize("seed", [0, 3])
def test_run_study_artifacts_equal_the_reference(seed, tmp_path):
    best_t, res_t = t_hpo.run_study(toy_objective(t_hpo.Pruned), 10, seed, tmp_path / "t")
    best_j, res_j = j_hpo.run_study(toy_objective(j_hpo.Pruned), 10, seed, tmp_path / "j")
    assert dataclasses.asdict(best_t) == dataclasses.asdict(best_j)
    assert [dataclasses.asdict(r) for r in res_t] == [dataclasses.asdict(r) for r in res_j]
    assert any(r.pruned for r in res_t)   # the median pruner acted
    for name in ("trials.json", "best_params.json", "trials.csv"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_search_space_and_fallback_trial_equal_the_reference():
    def space(module, seed):
        return module.default_search_space(module._FallbackTrial(0, random.Random(seed), []))

    for seed in range(4):
        assert space(t_hpo, seed) == space(j_hpo, seed)
    histories = [[1.0, 2.0], [3.0, 1.0], [2.0, 5.0]]
    for value in (0.5, 2.5):
        t, j = (m._FallbackTrial(3, random.Random(0), histories) for m in (t_hpo, j_hpo))
        for trial in (t, j):
            trial.report(value, 0)
        assert t.should_prune() == j.should_prune() == (value < 2.0)


class Stop(Exception):
    pass


def test_objective_configs_equal_the_reference(monkeypatch):
    import tvc_ai_tpu.training.loop as j_loop
    import tvc_ai_torch.training.loop as t_loop

    seen = {}

    def recorder(side):
        def init_carry(*args, **kwargs):
            seen[side] = (args, kwargs)
            raise Stop()
        return init_carry

    monkeypatch.setattr(j_loop, "init_carry", recorder("jax"))
    monkeypatch.setattr(t_loop, "init_carry", recorder("torch"))
    for module in (j_hpo, t_hpo):
        kwargs = dict(total_steps=50_000, num_envs=256, seed=5)
        if module is t_hpo:
            kwargs["device"] = "cpu"
        with pytest.raises(Stop):
            module.make_sac_objective(**kwargs)(
                module._FallbackTrial(2, random.Random(11), []))
    (key, j_env, j_sac, j_loop_cfg), _ = seen["jax"]
    (t_env, t_sac, t_loop_cfg), t_kwargs = seen["torch"]
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(5 + 2)))
    assert t_kwargs["seed"] == 5 + 2 and t_kwargs["device"].type == "cpu"
    for ref, port in ((j_sac, t_sac), (j_loop_cfg, t_loop_cfg)):
        ref_fields = {f.name for f in dataclasses.fields(ref)}
        port_fields = {f.name for f in dataclasses.fields(port)}
        shared = sorted(ref_fields & port_fields)
        simple = [n for n in shared
                  if not dataclasses.is_dataclass(getattr(ref, n))]
        assert {n: getattr(port, n) for n in simple} == {n: getattr(ref, n) for n in simple}
    assert (t_sac.hidden_dims[0] in (128, 256, 512) and t_sac.buffer_size == 200_000
            and t_loop_cfg.rollout_steps == 64 and t_loop_cfg.num_envs == 256)
    assert j_env.max_episode_steps == t_env.max_episode_steps
    # the replay capacity: the reference's rule (training/loop.py's init_carry)
    # is buffer_size rounded down to a multiple of N; the port's gives the same
    small = dataclasses.replace(t_sac, hidden_dims=(8, 8))
    monkeypatch.undo()
    capacity = t_loop.init_carry(t_env, small, t_loop_cfg, device="cpu").buffer.capacity
    assert capacity == j_sac.buffer_size - j_sac.buffer_size % j_loop_cfg.num_envs == 199_936


def reference_rungs(monkeypatch, **kwargs) -> list[int]:
    """The iterations at which the reference's objective reports, its training
    and evaluation patched out (nothing traced or compiled)."""
    import tvc_ai_tpu.eval.rollout as j_rollout
    import tvc_ai_tpu.training.loop as j_loop

    monkeypatch.setattr(j_loop, "init_carry", lambda *a: types.SimpleNamespace(agent=None))
    monkeypatch.setattr(j_loop, "make_train_iteration",
                        lambda *a, **k: lambda carry, params: (carry, {}))
    monkeypatch.setattr(j_rollout, "make_eval_fn", lambda *a, **k: lambda *b: None)
    monkeypatch.setattr(j_rollout, "summarize_stats", lambda s: {"eval_reward_mean": 1.0})
    monkeypatch.setattr(jax, "jit", lambda fn, **k: fn)
    trial = FixedTrial()
    j_hpo.make_sac_objective(**kwargs)(trial)
    monkeypatch.undo()
    return [step for step, _ in trial.reports]


def test_objective_trains_scores_and_reports_at_the_reference_rungs(monkeypatch):
    rungs = reference_rungs(monkeypatch, **TINY)
    assert rungs == [1, 3, 4]
    trial = FixedTrial()
    score = t_hpo.make_sac_objective(**TINY, device="cpu")(trial)
    assert [step for step, _ in trial.reports] == rungs
    assert math.isfinite(score) and score == trial.reports[-1][1]
    # 5 iterations x 64 steps x 4 envs = 1280 rows: the last iteration learns
    pruning = FixedTrial(prune=True)
    with pytest.raises(t_hpo.Pruned):
        t_hpo.make_sac_objective(**TINY, device="cpu")(pruning)
    assert [step for step, _ in pruning.reports] == rungs[:1]
    assert pruning.reports[0] == trial.reports[0]   # same seed, same first score


def test_command_runs_two_trials_on_the_cpu(tmp_path):
    out_dir = tmp_path / "hpo"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tune_hyperparameters.main(["--cpu", "--n_trials", "2", "--trial_steps", "256",
                                        "--num_envs", "4", "--output_dir", str(out_dir)])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "backend: built-in random search"
    assert lines[1] == "2 trials (0 pruned)"
    assert lines[2].startswith("best eval reward: ")
    assert lines[-1] == f"artifacts: {out_dir}"
    trials = json.loads((out_dir / "trials.json").read_text())
    # the trial parameters are the seed's draws, as the reference's study draws them
    def draw_only(trial):
        j_hpo.default_search_space(trial)
        return 0.0

    _, drawn = j_hpo.run_study(draw_only, 2, 0)
    assert [t["params"] for t in trials] == [r.params for r in drawn]
    best = json.loads((out_dir / "best_params.json").read_text())
    assert [f"  {k} = {v}" for k, v in best["params"].items()] == lines[3:-1]
    assert all(math.isfinite(t["value"]) for t in trials)
