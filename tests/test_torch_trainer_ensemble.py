"""The ensemble trainer of tvc_ai_torch on the CPU: a tiny ``EnsembleTrainer``
end to end with its resume from ``ensemble_final.pt``, and ``python -m
tvc_ai_torch.train --device cpu`` for each of ``training.algorithm``
ensemble, ppo and td3."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tvc_ai_torch.agents import ensemble as t_ens
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.training.trainer_ensemble import FINAL_CHECKPOINT, EnsembleTrainer
from tvc_ai_torch.utils.checkpoint import diff_states

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def tiny_overrides(tmp_path, algo: str = "ensemble", total: int = 256) -> list[str]:
    return [
        f"globals.output_dir={tmp_path}",
        f"training.algorithm={algo}",
        f"training.total_timesteps={total}",
        "training.num_envs=8",
        "training.rollout_steps=16",
        "training.eval_freq=128",
        "training.eval_episodes=2",
        "algorithms.sac.hidden_dims=[16,16]",
        "algorithms.td3.hidden_dims=[16,16]",
        "algorithms.td3.batch_size=16",
        "algorithms.sac.buffer_size=2048",
        "algorithms.sac.learning_starts=64",
        "algorithms.sac.batch_size=16",
        "algorithms.ppo.n_epochs=2",
        "algorithms.ensemble.selection_epsilon=0.3",
        "curriculum.enabled=false",
        "logging.tensorboard=false",
    ]


def test_trainer_end_to_end_and_resume(tmp_path):
    cfg = t_loader.load_config(None, tiny_overrides(tmp_path))
    first = EnsembleTrainer(cfg, output_dir=tmp_path / "run1", device="cpu")
    result = first.train()
    assert result["env_steps"] == 256 and result["iterations"] == 2
    assert set(result["stage_timing"]) == {"train_iteration", "evaluate", "checkpoint"}
    final = json.loads((tmp_path / "run1" / "final_metrics.json").read_text())
    assert final["env_steps"] == 256
    for member in t_ens.ALGORITHMS:
        assert f"{member}_eval_success_rate" in final and f"{member}_eval_reward_p95" in final
    header = (tmp_path / "run1" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"step", "sac_critic_loss", "td3_critic_loss", "actor_is_ppo",
            "sac_eval_success_rate"} <= set(header)
    assert sum(len(h) for h in first.agent.performance_history.values()) > 0

    resumed = EnsembleTrainer(cfg, output_dir=tmp_path / "run2",
                              resume=tmp_path / "run1" / FINAL_CHECKPOINT, device="cpu")
    members = lambda t: {m: getattr(t.carry, m) for m in t_ens.ALGORITHMS}  # noqa: E731
    assert diff_states(members(first), members(resumed)) == []
    assert resumed.agent.performance_history == first.agent.performance_history
    assert resumed.agent.algorithm_weights == first.agent.algorithm_weights
    assert resumed.env_steps == 0  # the members only, as in the reference
    resumed.logger.close()


@pytest.mark.parametrize("algo", ["ensemble", "ppo", "td3"])
def test_train_entry_point_routes_on_cpu(tmp_path, algo):
    cmd = [sys.executable, "-m", "tvc_ai_torch.train", "--device", "cpu", "--output-dir",
           str(tmp_path / "cli"), *tiny_overrides(tmp_path, algo, total=128)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final: success=" in proc.stdout
    assert (tmp_path / "cli" / FINAL_CHECKPOINT).exists()
    rows = (tmp_path / "cli" / "metrics.csv").read_text().splitlines()
    header = rows[0].split(",")
    acted_ppo = float(rows[1].split(",")[header.index("actor_is_ppo")])
    if algo != "ensemble":
        assert acted_ppo == float(algo == "ppo")
    assert ("ppo_policy_loss" in header) == (algo == "ppo") or algo == "ensemble"
    saved = t_loader.load_config(tmp_path / "cli" / "config.yaml")
    assert saved.training.algorithm == algo


def test_trainer_options(tmp_path):
    cfg = t_loader.load_config(None, tiny_overrides(tmp_path))
    with pytest.raises(ValueError, match="forced_actor"):
        EnsembleTrainer(cfg, output_dir=tmp_path / "x", forced_actor="a2c", device="cpu")
    t = EnsembleTrainer(dataclasses.replace(cfg), output_dir=tmp_path / "y", forced_actor="td3",
                        device="cpu")
    assert t.forced_actor == "td3" and t.carry.buffer.capacity == 2048
    t.logger.close()
