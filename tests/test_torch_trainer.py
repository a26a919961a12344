"""The trainer slice of tvc_ai_torch: curriculum, hacking detector, stability
interventions and eval gating against the JAX package on scripted inputs,
checkpoint/resume, and a tiny trainer end to end on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.convert import actor_from_flax
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.train import main as train_main
from tvc_ai_torch.training import curriculum as t_curriculum
from tvc_ai_torch.training import hacking as t_hacking
from tvc_ai_torch.training import stability as t_stability
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import CheckpointManager, diff_states
from tvc_ai_torch.utils.profiling import StageTimer
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.config import loader as j_loader
from tvc_ai_tpu.training import curriculum as j_curriculum
from tvc_ai_tpu.training import hacking as j_hacking
from tvc_ai_tpu.training import stability as j_stability

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
STEPS_PER_ITER = 8 * 16


def tiny_overrides(tmp_path, total=2048) -> list[str]:
    """The overrides of ``tests/test_trainer.py::tiny_cfg``."""
    return [
        f"globals.output_dir={tmp_path}",
        f"training.total_timesteps={total}",
        "training.num_envs=8",
        "training.rollout_steps=16",
        "training.updates_per_step=1",
        "training.eval_freq=1024",
        "training.eval_episodes=2",
        "training.early_stopping.enabled=false",
        "algorithms.sac.hidden_dims=[16,16]",
        "algorithms.sac.buffer_size=2048",
        "algorithms.sac.learning_starts=64",
        "algorithms.sac.batch_size=16",
        "curriculum.enabled=false",
        "logging.tensorboard=false",
    ]


def tiny_cfg(tmp_path, total=2048, extra=()):
    return t_loader.load_config(None, tiny_overrides(tmp_path, total) + list(extra))


# ------------------------------------------------------------------ curriculum
CURRICULA = {
    "default": [],
    "dwell": ["curriculum.min_stage_steps=3000"],
    "budget": ["curriculum.max_stage_steps=4000", "curriculum.watchdog_evals=3"],
    "short_window": ["curriculum.stability_window=30", "curriculum.min_stage_fraction=0.1"],
}


def _stage_dict(stage):
    return None if stage is None else vars(stage)


@pytest.mark.parametrize("name", sorted(CURRICULA))
def test_curriculum_matches_jax(name):
    path = t_loader.default_config_path()
    port = t_curriculum.CurriculumManager(t_loader.load_config(path, CURRICULA[name]))
    ref = j_curriculum.CurriculumManager(j_loader.load_config(path, CURRICULA[name]))
    rng = np.random.default_rng(len(name))
    promoted = 0
    for i in range(400):
        kind = rng.integers(0, 3)
        if kind == 0:
            eps, rate, steps = int(rng.integers(0, 60)), float(rng.random()), 512
            out = port.update(eps, rate, steps), ref.update(eps, rate, steps)
        elif kind == 1:
            rate = float(rng.choice([0.0, 0.3, rng.random(), 0.95]))
            out = port.update_eval(rate), ref.update_eval(rate)
        else:
            out = port.watchdog_alert(), ref.watchdog_alert()
        assert out[0] == out[1], (i, out)
        promoted += out[0] is True
        assert port.state_dict() == ref.state_dict(), i
        assert _stage_dict(port.get_environment_config()) == _stage_dict(
            ref.get_environment_config())
        assert port.get_adaptive_hyperparameters() == ref.get_adaptive_hyperparameters()
        if i == 200:  # a resume: the windows and the watchdog reset on load
            state = ref.state_dict()
            port.load_state_dict(json.loads(json.dumps(state)))
            ref.load_state_dict(json.loads(json.dumps(state)))
            assert not port.eval_window and port.evals_in_stage == 0
    assert promoted > 0


def test_curriculum_save(tmp_path):
    cur = t_curriculum.CurriculumManager(t_loader.load_config(None))
    cur.advance_stage()
    cur.save_curriculum_data(tmp_path / "c.json")
    assert json.loads((tmp_path / "c.json").read_text())["stage_idx"] == 1


# ------------------------------------------------------------------ hacking
REGIMES = {
    "normal": lambda r, n: (r.normal(300, 50, n), r.random(n) < 0.5, r.integers(50, 400, n)),
    "farming": lambda r, n: (r.normal(1500, 10, n), np.zeros(n, bool), r.integers(901, 1000, n)),
    "impossible": lambda r, n: (r.normal(2500, 5, n), np.zeros(n, bool), r.integers(100, 300, n)),
    "spikes": lambda r, n: (np.where(r.random(n) < 0.05, 5e4, r.normal(10, 1, n)),
                            r.random(n) < 0.05, r.integers(10, 50, n)),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_hacking_matches_jax(regime):
    port, ref = t_hacking.RewardHackingDetector(), j_hacking.RewardHackingDetector()
    rng = np.random.default_rng(3)
    rewards, successes, lengths = REGIMES[regime](rng, 160)
    scores = set()
    for i, (r, s, n) in enumerate(zip(rewards, successes, lengths)):
        port.add_episode(reward=float(r), success=bool(s), length=int(n))
        ref.add_episode(reward=float(r), success=bool(s), length=int(n))
        if i % 7 == 0 or i == len(rewards) - 1:
            a, b = port.detect_hacking(), ref.detect_hacking()
            assert (a.score, a.indicators, a.is_hacking) == (b.score, b.indicators, b.is_hacking)
            scores.add(a.score)
    assert len(scores) > 1 or regime == "normal"


# ------------------------------------------------------------------ stability
def _jax_actor(seed: int, hidden=(32, 32)):
    return j_sac.init(jax.random.PRNGKey(seed), 10, 2, j_sac.SACConfig(hidden_dims=hidden)).actor_params


def _port_actor(flax_params, hidden=(32, 32)) -> GaussianActor:
    actor = GaussianActor(10, 2, hidden, device="cpu")
    actor.load_state_dict(actor_from_flax(jax.tree.map(np.asarray, flax_params)))
    return actor


def _flax_leaves_by_torch_name(tree) -> dict[str, np.ndarray]:
    """Each flax leaf under its torch parameter name, in the torch layout."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path if hasattr(p, "key")][1:]  # drop "params"
        kind = "weight" if keys[-1] == "kernel" else "bias"
        leaf = np.asarray(leaf)
        out[".".join(keys[:-1] + [kind])] = leaf.T if kind == "weight" else leaf
    return out


def _assert_actor_equals(actor: GaussianActor, flax_params, **tol) -> None:
    ref = _flax_leaves_by_torch_name(flax_params)
    for name, p in actor.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], err_msg=name, **tol)


@pytest.mark.parametrize("ratio", [0.05, 0.5])
def test_primacy_reset_matches_jax(ratio):
    params, initial = _jax_actor(1), _jax_actor(2)
    key = jax.random.PRNGKey(9)
    ref = j_stability.primacy_reset(params, initial, key, ratio)
    # replay the per-leaf Bernoulli masks (leaves in flax's sorted order)
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    masks = jax.tree.unflatten(treedef, [jax.random.bernoulli(k, ratio, leaf.shape)
                                         for leaf, k in zip(leaves, keys)])
    masks = _flax_leaves_by_torch_name(masks)
    actor = _port_actor(params)
    init = _flax_leaves_by_torch_name(initial)
    names = [n for n, _ in actor.named_parameters()]
    t_stability.primacy_reset(actor, [torch.tensor(init[n]) for n in names], ratio,
                              masks=[torch.tensor(masks[n]) for n in names])
    _assert_actor_equals(actor, ref, rtol=0, atol=0)
    # drawn from a generator: the same share of weights is reset
    fresh = _port_actor(params)
    t_stability.primacy_reset(fresh, [torch.zeros_like(p) for p in fresh.parameters()], ratio,
                              generator=torch.Generator().manual_seed(0))
    zeros = sum(int((p == 0).sum()) for p in fresh.hidden_1.parameters())
    total = sum(p.numel() for p in fresh.hidden_1.parameters())
    assert abs(zeros / total - ratio) < 0.05 + 0.1 * ratio


@pytest.mark.parametrize("max_ratio", [0.1, 0.5])
def test_reinit_dormant_units_matches_jax(max_ratio):
    params = _jax_actor(3)
    # six dead units (and one barely alive) in the first hidden layer
    bias = params["params"]["hidden_0"]["bias"]
    bias = bias.at[jnp.array([1, 4, 7, 8, 20, 31])].set(-100.0).at[12].set(-3.0)
    params = jax.tree.map(lambda x: x, params)
    params["params"]["hidden_0"]["bias"] = bias
    probe = jax.random.normal(jax.random.PRNGKey(4), (64, 10))
    key = jax.random.PRNGKey(5)
    ref = j_stability.reinit_dormant_units(None, params, probe, key, 0.01, max_ratio)
    fresh = jax.random.normal(key, params["params"]["hidden_0"]["kernel"].shape)
    actor = _port_actor(params)
    before = actor.hidden_0.weight.detach().clone()
    probe_t = torch.tensor(np.asarray(probe))
    fraction = float(t_stability.dormant_neuron_fraction(actor, probe_t, 0.01))
    assert fraction == pytest.approx(
        float(j_stability.dormant_neuron_fraction(None, params, probe, 0.01)))
    t_stability.reinit_dormant_units(actor, probe_t, 0.01, max_ratio,
                                     fresh=torch.from_numpy(np.asarray(fresh).T.copy()))
    _assert_actor_equals(actor, ref, rtol=1e-6, atol=1e-7)
    changed = (actor.hidden_0.weight != before).any(dim=1)
    assert int(changed.sum()) == min(round(fraction * 32), int(32 * max_ratio)) >= 3


def test_adaptive_tau_and_manager_match_jax():
    for adaptive in (False, True):
        cfg_t = t_stability.StabilityConfig(adaptive_tau=adaptive)
        cfg_j = j_stability.StabilityConfig(adaptive_tau=adaptive)
        for step in (0, 1, 10, 700, 5000):
            assert np.float32(t_stability.adaptive_tau(cfg_t, step)) == np.float32(
                j_stability.adaptive_tau(cfg_j, jnp.int32(step)))
    cfg = dict(reset_interval=300, dormant_check_interval=200)
    port = t_stability.TrainingStabilityManager(t_stability.StabilityConfig(**cfg), 10_000)
    ref = j_stability.TrainingStabilityManager(j_stability.StabilityConfig(**cfg), 10_000)
    port.register_initial_params(_port_actor(_jax_actor(0)))
    ref.register_initial_params(_jax_actor(0))
    for n in [128] * 12:
        port.step(n)
        ref.step(n)
        assert (port.due_primacy_reset(), port.due_dormant_check()) == (
            ref.due_primacy_reset(), ref.due_dormant_check())
        assert port.state_dict() == ref.state_dict()
    assert port.should_stop_training(0.95) and not port.should_stop_training(0.5)
    other = t_stability.TrainingStabilityManager(t_stability.StabilityConfig(), 0)
    other.load_state_dict(port.state_dict())
    assert other.state_dict() == port.state_dict()


# ------------------------------------------------------------------ eval gating
class _StubCkpt:
    """Records save calls in place of a checkpoint manager."""

    def __init__(self):
        self.saved_steps = []

    def save(self, step, payload, host=None):
        self.saved_steps.append(int(step))
        return 0


@pytest.fixture(scope="module")
def gate_trainer(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("gating")
    cfg = tiny_cfg(tmp_path)
    cfg.training.early_stopping.metric = "eval_robust_success_rate"
    cfg.training.eval_domain_randomization = True
    cfg.training.early_stopping.enabled = False
    cfg.curriculum.enabled = True
    cfg.env.domain_randomization.enabled = True
    return Trainer(cfg, output_dir=tmp_path / "run", device="cpu")


def _reset_gate_state(t):
    t.curriculum = t_curriculum.CurriculumManager(t.cfg)
    t.best_metric = float("-inf")
    t.best_nominal_key = (float("-inf"), float("-inf"))
    t.best_significant_metric = float("-inf")
    t.eval_rounds_since_improvement = 0
    t.ckpt_best = _StubCkpt()
    t.ckpt_best_nominal = _StubCkpt()
    return t


def _metrics(nominal, stage=None, robust=None):
    m = {"eval_success_rate": nominal, "eval_reward_mean": 0.0, "eval_crash_rate": 0.0}
    if stage is not None:
        m["eval_stage_success_rate"] = stage
    if robust is not None:
        m["eval_robust_success_rate"] = robust
    return m


def test_gating_stage_eval_gates_promotion(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.curriculum.steps_in_stage = t.curriculum.cur.min_stage_steps
    for _ in range(4):
        assert t._apply_eval_outcome(_metrics(1.0, stage=0.0)) is None
    assert t.curriculum.stage_idx == 0
    thr = t.curriculum.stage.success_threshold
    t._apply_eval_outcome(_metrics(1.0, stage=thr))
    t._apply_eval_outcome(_metrics(1.0, stage=thr))
    assert t.curriculum.stage_idx == 1


def test_gating_promotion_respects_dwell(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.curriculum.cur.min_stage_steps = 10_000
    try:
        t.curriculum.steps_in_stage = 0
        thr = t.curriculum.stage.success_threshold
        for _ in range(5):
            t._apply_eval_outcome(_metrics(1.0, stage=thr))
        assert t.curriculum.stage_idx == 0
    finally:
        t.curriculum.cur.min_stage_steps = 0


def test_gating_lexicographic_nominal_capture(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t._apply_eval_outcome(_metrics(1.0, robust=0.2))
    assert t.best_nominal_key == (1.0, 0.2)
    n_saves = len(t.ckpt_best_nominal.saved_steps)
    t._apply_eval_outcome(_metrics(1.0, robust=0.1))
    assert t.best_nominal_key == (1.0, 0.2)
    assert len(t.ckpt_best_nominal.saved_steps) == n_saves
    t._apply_eval_outcome(_metrics(1.0, robust=0.5))
    assert t.best_nominal_key == (1.0, 0.5)
    assert len(t.ckpt_best_nominal.saved_steps) == n_saves + 1


def test_gating_stage_tiebreak_resets_on_promotion(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.curriculum.steps_in_stage = t.curriculum.cur.min_stage_steps
    thr = t.curriculum.stage.success_threshold
    t._apply_eval_outcome(_metrics(1.0, stage=0.9))
    t._apply_eval_outcome(_metrics(1.0, stage=0.9))
    assert t.best_nominal_key == (1.0, 0.9)
    t._apply_eval_outcome(_metrics(1.0, stage=max(thr, 0.9)))
    assert t.curriculum.stage_idx == 1
    assert t.best_nominal_key[1] == float("-inf")
    n_saves = len(t.ckpt_best_nominal.saved_steps)
    t._apply_eval_outcome(_metrics(1.0, stage=0.3))
    assert t.best_nominal_key == (1.0, 0.3)
    assert len(t.ckpt_best_nominal.saved_steps) == n_saves + 1


def test_gating_robust_tiebreak_not_reset_on_promotion(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.curriculum.steps_in_stage = t.curriculum.cur.min_stage_steps
    thr = t.curriculum.stage.success_threshold
    for _ in range(3):
        t._apply_eval_outcome(_metrics(1.0, stage=thr, robust=0.4))
    assert t.curriculum.stage_idx == 1
    assert t.best_nominal_key == (1.0, 0.4)


def test_gating_primary_best_and_early_stopping(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.cfg.training.early_stopping.enabled = True
    t.cfg.training.early_stopping.patience = 2
    try:
        assert t._apply_eval_outcome(_metrics(0.5, robust=0.3)) is None
        assert t.best_metric == 0.3
        assert t.ckpt_best.saved_steps
        assert t._apply_eval_outcome(_metrics(0.5, robust=0.3)) is None
        assert t._apply_eval_outcome(_metrics(0.5, robust=0.3)) == "early_stopping"
    finally:
        t.cfg.training.early_stopping.enabled = False


def test_gating_trainer_builds_the_three_evals(gate_trainer):
    t = _reset_gate_state(gate_trainer)
    t.stage_eval_env_params = t._build_stage_eval_params()
    assert t.robust_eval_env_params.randomization.enabled
    assert t.robust_eval_env_params.randomization.dr_prob == 1.0
    assert not t.eval_env_params.randomization.enabled
    assert t.stage_eval_env_params.randomization.wind_max == 0.0  # stage 0 overlay
    metrics = t.evaluate()
    assert {"eval_success_rate", "eval_robust_success_rate", "eval_stage_success_rate"} <= set(
        metrics)


# ------------------------------------------------------------------ trainer
def test_trainer_end_to_end_and_resume(tmp_path):
    t1 = Trainer(tiny_cfg(tmp_path), output_dir=tmp_path / "run1", device="cpu")
    result = t1.train()
    assert result["env_steps"] >= 2048
    assert result["stop_reason"] == "total_timesteps"
    assert set(result["stage_timing"]) == {"train_iteration", "evaluate", "checkpoint"}
    final = json.loads((tmp_path / "run1" / "final_metrics.json").read_text())
    assert final["env_steps"] == result["env_steps"] and "eval_reward_p95" in final
    header = (tmp_path / "run1" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"step", "critic_loss", "success_rate_recent", "eval_success_rate"} <= set(header)
    assert (tmp_path / "run1" / "curriculum.json").exists()
    saved_steps = result["env_steps"]

    t2 = Trainer(tiny_cfg(tmp_path, total=4096), output_dir=tmp_path / "run2",
                 resume=tmp_path / "run1" / "checkpoints", device="cpu")
    assert t2.env_steps == saved_steps
    assert not diff_states(t1.carry, t2.carry)
    assert t2.iteration == t1.iteration
    result2 = t2.train()
    assert result2["env_steps"] >= 4096

    best = sorted(d.name for d in (tmp_path / "run1" / "checkpoints_best").iterdir())
    t3 = Trainer(tiny_cfg(tmp_path, total=4096), output_dir=tmp_path / "run3",
                 resume=tmp_path / "run1" / "checkpoints_best" / best[0], device="cpu")
    assert t3.env_steps == int(best[0])
    t3.logger.close()


def test_resume_continues_exactly(tmp_path):
    """Two iterations, save, resume, one more: the carry equals that of three
    straight iterations, bit for bit."""
    extra = ["training.eval_freq=128"]  # an eval round after every iteration
    first = Trainer(tiny_cfg(tmp_path, 2 * STEPS_PER_ITER, extra), output_dir=tmp_path / "a",
                    device="cpu")
    first.train()
    resumed = Trainer(tiny_cfg(tmp_path, 3 * STEPS_PER_ITER, extra), output_dir=tmp_path / "b",
                      resume=tmp_path / "a" / "checkpoints", device="cpu")
    resumed.train()
    straight = Trainer(tiny_cfg(tmp_path, 3 * STEPS_PER_ITER, extra),
                       output_dir=tmp_path / "c", device="cpu")
    straight.train()
    assert resumed.iteration == straight.iteration == 3
    assert resumed.carry.agent.step == straight.carry.agent.step > 0
    assert diff_states(resumed.carry, straight.carry) == []
    assert diff_states(first.carry, straight.carry)  # the comparison can fail


@pytest.mark.parametrize("case,extra,saved", [
    ("period", ["training.checkpointing.period=128"], [128, 256, 384]),
    ("save_freq", ["training.save_freq=256"], [256, 384]),   # period left at 25,000
    ("default", [], [384]),                                   # save_freq 10,000: final only
])
def test_periodic_save_cadence(tmp_path, case, extra, saved):
    """checkpointing.period wins unless it is exactly 25,000, where
    training.save_freq sets the cadence (the reference's rule)."""
    t = Trainer(tiny_cfg(tmp_path, 3 * STEPS_PER_ITER, ["training.eval_freq=100000", *extra]),
                output_dir=tmp_path / case, device="cpu")
    t.train()
    assert CheckpointManager(tmp_path / case / "checkpoints").all_steps() == saved


def test_trainer_schedule_horizon_leaves_out_update_interval(tmp_path):
    from tvc_ai_torch.config.build import build_sac_config

    cfg = tiny_cfg(tmp_path, 40_960, ["training.update_interval=4", "training.rollout_steps=16",
                                      "training.updates_per_step=2"])
    t = Trainer(cfg, output_dir=tmp_path / "h", device="cpu")
    assert t.sac_cfg.schedule_total_steps == 40_960 // 8 * 2
    assert build_sac_config(cfg).schedule_total_steps == 40_960 // 8 * 2 // 4
    t.logger.close()


def test_robust_metric_requires_robust_eval(tmp_path):
    cfg = tiny_cfg(tmp_path)
    cfg.training.early_stopping.metric = "eval_robust_success_rate"
    with pytest.raises(ValueError, match="eval_domain_randomization"):
        Trainer(cfg, output_dir=tmp_path / "runx", device="cpu")


@pytest.mark.parametrize("option", ["warm_start", "demo_seeding"])
def test_unported_trainer_options_raise(tmp_path, option):
    """Both options are ported now and no longer raise: warm_start_actor
    reads the port's own student file and sets the actor from it (its
    refusals and the fine-tune config are in tests/test_torch_distill_cli.py),
    demo_seeding seeds the replay (its parity is in tests/test_torch_demos.py)."""
    if option == "warm_start":
        from tvc_ai_torch.agents import sac as sac_mod
        from tvc_ai_torch.training.dagger import save_student

        student = sac_mod.make_actor(10, 2, sac_mod.SACConfig((16, 16)), "cpu", seed=3)
        save_student(tmp_path / "student.pt", student, sac_mod.SACConfig((16, 16)), 10, 2)
        t = Trainer(tiny_cfg(tmp_path, extra=[
            f"training.warm_start_actor={tmp_path / 'student.pt'}"]),
            output_dir=tmp_path / "x", device="cpu")
        assert diff_states(t.carry.agent.actor, student) == []
        t.logger.close()
        return
    extra = ["training.demo_seeding.enabled=true", "training.demo_seeding.envs=8",
             "training.demo_seeding.steps=4"]
    t = Trainer(tiny_cfg(tmp_path, extra=extra), output_dir=tmp_path / "x", device="cpu")
    assert t.carry.buffer.size == 8 * 4 and t.carry.demo_buffer is None  # fraction 0
    assert t.demo_stats["demo_transitions"] == 32.0
    t.logger.close()


@pytest.mark.parametrize("algo", ["ensemble", "ppo", "td3"])
def test_train_entry_point_refuses_other_algorithms(tmp_path, algo, monkeypatch):
    """These routes no longer raise ``NotImplementedError``: the SAC trainer
    refuses them and they go to ``EnsembleTrainer`` as in ``scripts/train.py``
    (ppo and td3 with that member forced to act), on the device asked for.
    The routes themselves run in ``tests/test_torch_trainer_ensemble.py``."""
    from tvc_ai_torch.training import trainer_ensemble

    seen = {}

    def stub(cfg, output_dir=None, resume=None, forced_actor=None, device="cuda"):
        seen.update(algorithm=cfg.training.algorithm, forced_actor=forced_actor, device=device)
        raise RuntimeError("stub trainer")

    monkeypatch.setattr(trainer_ensemble, "EnsembleTrainer", stub)
    with pytest.raises(RuntimeError, match="stub trainer"):
        train_main(["--device", "cpu", f"training.algorithm={algo}"])
    assert seen == {"algorithm": algo, "forced_actor": None if algo == "ensemble" else algo,
                    "device": "cpu"}


def test_train_entry_point_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "tvc_ai_torch.train", "--device", "cpu", "--output-dir",
           str(tmp_path / "cli"), *tiny_overrides(tmp_path, total=256)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final: success=" in proc.stdout
    saved = t_loader.load_config(tmp_path / "cli" / "config.yaml")
    assert saved.training.num_envs == 8
    assert (tmp_path / "cli" / "final_metrics.json").exists()


# ------------------------------------------------------------------ checkpoint
def test_checkpoint_manager(tmp_path):
    mngr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    gen = torch.Generator().manual_seed(1)
    payload = {"x": torch.arange(4), "gen": gen, "n": 3}
    for step in (10, 20, 30):
        mngr.save(step, payload, {"step": step})
    mngr.save(30, {"x": torch.zeros(4), "gen": gen, "n": 0})  # an existing step is skipped
    assert mngr.all_steps() == [20, 30] and mngr.latest_step() == 30
    (tmp_path / "ck" / "40.tmp-123").mkdir()  # a save killed midway
    assert mngr.latest_step() == 30
    torch.rand(3, generator=gen)
    state, host = mngr.restore()
    assert host == {"step": 30} and state["n"] == 3
    other = torch.Generator()
    from tvc_ai_torch.utils.checkpoint import load_state

    loaded = load_state({"x": torch.zeros(4), "gen": other, "n": 0}, state)
    assert torch.equal(loaded["x"], torch.arange(4)) and loaded["n"] == 3
    assert torch.equal(torch.rand(3, generator=other), torch.rand(3, generator=torch.Generator(
    ).manual_seed(1)))
    assert CheckpointManager.locate(tmp_path / "ck")[1] == 30
    assert CheckpointManager.locate(tmp_path / "ck" / "20")[1] == 20
    with pytest.raises(FileNotFoundError):
        CheckpointManager.locate(tmp_path / "empty")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no completed checkpoints"):
        CheckpointManager.locate(tmp_path / "empty")


def test_stage_timer_matches_jax():
    from tvc_ai_tpu.utils.profiling import StageTimer as JStageTimer

    port, ref = StageTimer(), JStageTimer()
    for timer in (port, ref):
        for name in ("a", "b", "a"):
            with timer.stage(name):
                pass
    assert {k: v["count"] for k, v in port.report().items()} == {
        k: v["count"] for k, v in ref.report().items()}
    assert port.summary_line().count("x") == 2
