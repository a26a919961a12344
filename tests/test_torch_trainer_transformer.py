"""The SAC trainer with the transformer policy and with the loop's
extensions (CPU).

``transformer_r3.yaml`` (the transformer actor on a history-4 window, a fixed
entropy coefficient, an EMA eval actor) and the default config with ICM,
the physics-informed loss, RND and hierarchical RL all on run tiny
iterations (the overrides of ``tests/test_torch_trainer.py::tiny_overrides``,
narrower networks): a save and resume carries the carry (the ICM, RND and
high-level states, the goals and ``env_steps_host`` included) and both
generators back bit for bit, and one more iteration from there equals two
straight (LR schedule off). The hierarchical trainer evaluates through
``make_hier_eval_fn`` and its dormant-unit check probes the actor with the
goal-augmented view; demonstration seeding is refused in hierarchical mode
and runs beside the other extensions. ``python -m tvc_ai_torch.train
--device cpu`` trains ``transformer_r3.yaml`` in a subprocess.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_trainer import tiny_overrides
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import diff_states

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
STEPS_PER_ITER = 8 * 16
TRANSFORMER = ["network.transformer.d_model=16", "network.transformer.num_heads=2",
               "network.transformer.num_layers=1"]
EXTENSIONS = ["exploration.curiosity.enabled=true", "exploration.curiosity.hidden_dim=16",
              "exploration.random_network_distillation.enabled=true",
              "exploration.random_network_distillation.network_size=[16,8]",
              "exploration.random_network_distillation.update_frequency=5",
              "physics_informed.enabled=true", "hierarchical_rl.enabled=true"]
RUNS = {
    "transformer_r3": ("transformer_r3.yaml", TRANSFORMER),
    "extensions": (None, EXTENSIONS),
}


def run_cfg(name: str, tmp_path, total: int, more=()):
    path, extra = RUNS[name]
    # an eval round every iteration; the LR schedule off, since its horizon
    # follows total_timesteps, which differs between the runs compared
    return t_loader.load_config(
        None if path is None else ROOT / "tvc_ai_torch" / "config" / path,
        tiny_overrides(tmp_path, total) + extra
        + ["training.eval_freq=128", "stability.enable_lr_scheduling=false", *more])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_trains_and_resumes_exactly(tmp_path, name):
    first = Trainer(run_cfg(name, tmp_path, STEPS_PER_ITER), output_dir=tmp_path / "a",
                    device="cpu")
    carry = first.carry
    if name == "transformer_r3":
        assert isinstance(carry.agent.actor, TransformerActor)
        assert first.loop_cfg.history_len == 4 and carry.obs.shape == (8, 40)
        assert first.sac_cfg.ema_decay == pytest.approx(0.999)
        assert not first.sac_cfg.automatic_entropy_tuning
    else:
        assert None not in (carry.icm, carry.rnd, carry.hier, carry.goal)
        assert carry.buffer.data["obs"].shape[1] == 10 + 4   # the goal one-hot
    result = first.train()
    assert result["iterations"] == 1 and first.env_steps == STEPS_PER_ITER
    assert all(v == v for k, v in result.items() if k.startswith("eval_"))   # no NaN
    if name == "extensions":
        assert first.carry.env_steps_host == 16 and first.carry.rnd.step == 4   # steps 0, 5, 10, 15
        assert first.carry.icm.step == 16
    resumed = Trainer(run_cfg(name, tmp_path, 2 * STEPS_PER_ITER), output_dir=tmp_path / "b",
                      resume=tmp_path / "a" / "checkpoints", device="cpu")
    assert diff_states({"carry": first.carry, "generator": first.generator},
                       {"carry": resumed.carry, "generator": resumed.generator}) == []
    resumed.train()
    straight = Trainer(run_cfg(name, tmp_path, 2 * STEPS_PER_ITER), output_dir=tmp_path / "c",
                       device="cpu")
    straight.train()
    assert resumed.iteration == straight.iteration == 2
    assert diff_states(resumed.carry, straight.carry) == []
    assert diff_states(first.carry, straight.carry)   # the comparison can fail


def test_hierarchical_evaluation_and_dormant_check(tmp_path):
    # a dormant-unit check after the iteration (16 updates >= 8): the MLP
    # actor's first layer takes the goal-augmented view
    t = Trainer(run_cfg("extensions", tmp_path, STEPS_PER_ITER,
                        ["stability.dormant_check_interval=8"]),
                output_dir=tmp_path / "run", device="cpu")
    before = t.carry.agent.actor.hidden_0.weight.detach().clone()
    t.train()
    assert t.stability._last_dormant == 16
    assert t.carry.agent.actor.hidden_0.weight.shape[1] == 14 and not torch.equal(
        before, t.carry.agent.actor.hidden_0.weight)
    seen = []
    inner = t._eval_fn

    def recording(agent, generator, params, draws=None):
        seen.append(agent)
        return inner(agent, generator, params, draws)

    t._eval_fn = recording
    metrics = t.evaluate()
    assert seen and all(isinstance(a, tuple) and a[1] is t.carry.hier for a in seen)
    assert 0.0 <= metrics["eval_success_rate"] <= 1.0
    t.logger.close()


def test_ensemble_sac_member_follows_the_transformer():
    """The ensemble's SAC member takes the solo path's SACConfig, so it is a
    transformer actor under ``transformer_r3.yaml``, as in the reference."""
    from tvc_ai_torch.agents import ensemble
    from tvc_ai_torch.config.build import build_env_params
    from tvc_ai_torch.training.trainer_ensemble import build_ensemble_config

    cfg = t_loader.load_config(ROOT / "tvc_ai_torch" / "config" / "transformer_r3.yaml",
                               ["training.algorithm=ensemble", *TRANSFORMER,
                                "algorithms.sac.hidden_dims=[16,16]",
                                "algorithms.sac.batch_size=16", "algorithms.sac.learning_starts=16",
                                "algorithms.td3.hidden_dims=[16,16]",
                                "algorithms.td3.batch_size=16"])
    ens = build_ensemble_config(cfg)
    assert ens.sac.architecture == "transformer"
    params = build_env_params(cfg)
    carry = ensemble.init_carry(params, ens, 8, device="cpu", seed=0)
    assert isinstance(carry.sac.actor, TransformerActor)
    carry, metrics = ensemble.make_ensemble_iteration("sac", ens, 8, 4)(carry, [1, 1, 1], params)
    assert carry.sac.step > 0 and all(bool(torch.isfinite(v)) for v in metrics.values())


def test_hierarchical_refuses_demo_seeding(tmp_path):
    cfg = run_cfg("extensions", tmp_path, STEPS_PER_ITER)
    cfg.training.demo_seeding.enabled = True
    with pytest.raises(ValueError, match="hierarchical"):
        Trainer(cfg, output_dir=tmp_path / "run", device="cpu")
    # with hierarchical RL off the extensions' trainer seeds its replay
    cfg.hierarchical_rl.enabled = False
    cfg.training.demo_seeding.envs = 8
    cfg.training.demo_seeding.steps = 4
    cfg.training.demo_seeding.fraction = 0.25
    t = Trainer(cfg, output_dir=tmp_path / "run2", device="cpu")
    assert t.carry.buffer.size == t.carry.demo_buffer.size == 8 * 4
    assert torch.equal(t.carry.demo_buffer.data["obs"], t.carry.buffer.data["obs"][:32])
    assert t.carry.icm is not None and t.carry.rnd is not None and t.carry.hier is None
    t.logger.close()


def test_train_entry_point_transformer_r3_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "tvc_ai_torch.train", "--device", "cpu", "--config",
           str(ROOT / "tvc_ai_torch" / "config" / "transformer_r3.yaml"), "--output-dir",
           str(tmp_path / "cli"), *tiny_overrides(tmp_path, total=256), *TRANSFORMER]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final: success=" in proc.stdout
    saved = t_loader.load_config(tmp_path / "cli" / "config.yaml")
    assert saved.network.architecture_type == "transformer" and saved.network.history_len == 4
