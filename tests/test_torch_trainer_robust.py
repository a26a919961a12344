"""The SAC trainer on the port's robust-training YAMLs (CPU).

``robust_full_r4d.yaml`` (feasible-only draws, the mixture, sensor dropout,
actuator delay, the survival payout, drift observation, a robust eval) and
``curriculum_showcase.yaml`` (the mixture from its second stage, a history
window) run tiny iterations with the overrides of
``tests/test_torch_trainer.py::tiny_overrides``: a save and resume carries the
carry (``prev_imu`` included) and both generators back bit for bit, and
(with the LR schedule off) one more iteration from there equals two
straight. The trainer's three eval envs
are those the JAX trainer builds from the same file, and a curriculum
promotion rebuilds the training env with the new stage's mixture gate.
"""

from __future__ import annotations

import copy
from pathlib import Path

import pytest
import torch

from test_torch_config import _jax_params, assert_params_equal
from test_torch_parity_utils import np_tree
from test_torch_trainer import tiny_overrides
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.config.build import build_env_params
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.config import loader as j_loader
from tvc_ai_tpu.training import trainer as j_trainer
from tvc_ai_tpu.training.curriculum import CurriculumManager as JCurriculum

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
STEPS_PER_ITER = 8 * 16
RUNS = ["curriculum_showcase.yaml", "robust_full_r4d.yaml"]


def robust_cfg(name: str, tmp_path, total: int, extra=()):
    return t_loader.load_config(ROOT / "tvc_ai_torch" / "config" / name,
                                tiny_overrides(tmp_path, total) + list(extra))


@pytest.mark.parametrize("name", RUNS)
def test_robust_yaml_trains_and_resumes_exactly(tmp_path, name):
    # an eval round (nominal and robust) every iteration; the LR schedule
    # off, since its horizon follows total_timesteps, which differs between
    # the first run and the two it is compared with
    extra = ["training.eval_freq=128", "stability.enable_lr_scheduling=false"]
    first = Trainer(robust_cfg(name, tmp_path, STEPS_PER_ITER, extra), output_dir=tmp_path / "a",
                    device="cpu")
    rnd = first.env_params.randomization
    assert rnd.dr_mixture_enabled and first.env_params.reward.survival_normalized_success
    dropout = name == "robust_full_r4d.yaml"
    assert rnd.feasible_only == rnd.sensor_dropout_enabled == rnd.actuator_delay == dropout
    assert first.robust_eval_env_params is not None
    result = first.train()
    assert result["iterations"] == 1 and "eval_robust_success_rate" in result
    assert (first.carry.env_states.prev_imu is not None) == dropout
    resumed = Trainer(robust_cfg(name, tmp_path, 2 * STEPS_PER_ITER, extra),
                      output_dir=tmp_path / "b", resume=tmp_path / "a" / "checkpoints",
                      device="cpu")
    assert diff_states({"carry": first.carry, "generator": first.generator},
                       {"carry": resumed.carry, "generator": resumed.generator}) == []
    resumed.train()
    straight = Trainer(robust_cfg(name, tmp_path, 2 * STEPS_PER_ITER, extra),
                       output_dir=tmp_path / "c", device="cpu")
    straight.train()
    assert resumed.iteration == straight.iteration == 2
    assert diff_states(resumed.carry, straight.carry) == []
    assert diff_states(first.carry, straight.carry)  # the comparison can fail


def _jax_eval_params(ref, stage_idx: int):
    """The JAX trainer's three eval envs for config ``ref`` at a curriculum
    stage, as the port's type: nominal, robust, stage (its own method on a
    bare trainer holding only the config and the curriculum)."""
    nominal = copy.deepcopy(ref)
    nominal.env.domain_randomization.enabled = False
    nominal.env.domain_randomization.sensor_noise_enabled = ref.training.eval_sensor_noise
    robust = copy.deepcopy(ref)
    robust.env.domain_randomization.enabled = True
    robust.env.domain_randomization.dr_prob = 1.0
    robust.env.domain_randomization.sensor_noise_enabled = ref.training.eval_sensor_noise
    robust.env.domain_randomization.feasible_only = False
    bare = object.__new__(j_trainer.Trainer)
    bare.cfg = ref
    bare.curriculum = JCurriculum(ref)
    while bare.curriculum.stage_idx < stage_idx:
        bare.curriculum.advance_stage()
    stage = bare._build_stage_eval_params()
    return _jax_params(nominal), _jax_params(robust), env_params_from_numpy(np_tree(stage))


@pytest.mark.parametrize("name", RUNS)
def test_robust_yaml_eval_envs_and_promotion(tmp_path, name):
    overrides = tiny_overrides(tmp_path, STEPS_PER_ITER) + ["curriculum.enabled=true"]
    cfg = t_loader.load_config(ROOT / "tvc_ai_torch" / "config" / name, overrides)
    ref = j_loader.load_config(ROOT / "tvc_ai_tpu" / "config" / name, overrides)
    t = Trainer(cfg, output_dir=tmp_path / "run", device="cpu")
    for stage_idx in (0, 1):
        want = _jax_eval_params(ref, stage_idx)
        got = (t.eval_env_params, t.robust_eval_env_params, t.stage_eval_env_params)
        for a, b in zip(got, want):
            assert_params_equal(a, b)
        nominal, robust, stage = got
        dr = cfg.env.domain_randomization
        # nominal: no domain draw, delay and dropout as configured
        assert not nominal.randomization.enabled
        assert nominal.randomization.actuator_delay == dr.actuator_delay
        assert nominal.randomization.sensor_dropout_enabled == (dr.sensor_dropout_prob > 0)
        # robust: the unfiltered box at dr_prob 1; stage: the stage at dr_prob 1
        assert not robust.randomization.feasible_only and not robust.randomization.dr_mixture_enabled
        assert not stage.randomization.dr_mixture_enabled
        assert t.env_params == build_env_params(cfg, t.curriculum.get_environment_config())
        if stage_idx == 0:
            assert not t.env_params.randomization.dr_mixture_enabled   # stage 0: dr_prob 1
            # promote: the stage's step budget spent (or its dwell over and
            # three evals at the gate)
            t.curriculum.steps_in_stage = 10**12
            metrics = t.evaluate()
            for _ in range(3):
                if t.curriculum.stage_idx == 0:
                    assert t._apply_eval_outcome(dict(metrics, eval_stage_success_rate=1.0)) is None
            assert t.curriculum.stage_idx == 1
    stage1 = cfg.curriculum.stages[1]
    assert stage1.dr_prob < 1.0 and t.env_params.randomization.dr_mixture_enabled
    assert t.env_params.randomization.dr_prob == pytest.approx(stage1.dr_prob)
    t.logger.close()
