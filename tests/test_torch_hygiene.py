"""tvc_ai_torch stands alone: no JAX, no tvc_ai_tpu, CUDA unless asked otherwise,
and the card's eval path integrates only through K1."""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib.util
import io
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tvc_ai_torch
from tvc_ai_torch.agents import ensemble, ppo, sac, td3
from tvc_ai_torch.agents.legacy import SACAgent
from tvc_ai_torch.agents.replay import ReplayBuffer
from tvc_ai_torch.config import load_config
from tvc_ai_torch.convert import env_state_from_numpy, sac_state_from_numpy
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.eval.evaluate import load_agent_state, run_all_suites, run_suite
from tvc_ai_torch.evaluate import main as evaluate_main
from tvc_ai_torch.export.__main__ import main as export_main
from tvc_ai_torch.export.tflite import ExportError, collect_representative_obs
from tvc_ai_torch.models import curiosity as icm
from tvc_ai_torch.models import hierarchical, rnd
from tvc_ai_torch.models.safety import SafetyCorrectionNet
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.train import main as train_main
from tvc_ai_torch.training import cem, dagger, demos, loop, pilot, population, theta_student
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.training.trainer_ensemble import EnsembleTrainer

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(tvc_ai_torch.__path__, "tvc_ai_torch.")
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FOREIGN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert {"tvc_ai_torch.agents.optim", "tvc_ai_torch.agents.replay", "tvc_ai_torch.agents.sac",
            "tvc_ai_torch.training.loop", "tvc_ai_torch.convert",
            "tvc_ai_torch.config.schema", "tvc_ai_torch.config.loader",
            "tvc_ai_torch.config.build", "tvc_ai_torch.env.wrappers",
            "tvc_ai_torch.eval.rollout", "tvc_ai_torch.eval.evaluate",
            "tvc_ai_torch.training.curriculum", "tvc_ai_torch.training.hacking",
            "tvc_ai_torch.training.stability", "tvc_ai_torch.training.trainer",
            "tvc_ai_torch.utils.checkpoint", "tvc_ai_torch.utils.logging",
            "tvc_ai_torch.utils.profiling", "tvc_ai_torch.train",
            "tvc_ai_torch.evaluate", "tvc_ai_torch.agents.td3", "tvc_ai_torch.agents.ppo",
            "tvc_ai_torch.agents.ensemble",
            "tvc_ai_torch.training.trainer_ensemble", *EXTENSION_MODULES,
            *EXPORT_MODULES, *PARALLEL_DEMO_MODULES, *DISTILL_MODULES,
            *SINGLE_ENV_MODULES, *REMNANT_MODULES, *ARTIFACT_MODULES,
            *ORBAX_MODULES, *REFERENCE_TOOL_MODULES} <= set(MODULES)


# what no module of the port imports: the JAX package and its stack, and the
# libraries the JAX package's checkpoints are written and read with
FOREIGN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tvc_ai_tpu", "orbax", "tensorstore",
           "zstandard")


# the transformer policy and the loop's extensions (ICM, physics-informed
# loss, RND, hierarchical RL)
EXTENSION_MODULES = ["tvc_ai_torch.agents.physics_informed", "tvc_ai_torch.models.curiosity",
                     "tvc_ai_torch.models.hierarchical", "tvc_ai_torch.models.layers",
                     "tvc_ai_torch.models.rnd", "tvc_ai_torch.models.transformer"]
# the export path, the legacy agent it reads, population training and the
# safety correction net
EXPORT_MODULES = ["tvc_ai_torch.agents.legacy", "tvc_ai_torch.export",
                  "tvc_ai_torch.export.__main__", "tvc_ai_torch.export.c_array",
                  "tvc_ai_torch.export.micro", "tvc_ai_torch.export.tflite",
                  "tvc_ai_torch.models.safety", "tvc_ai_torch.training.population"]
# data parallel and demonstration seeding
PARALLEL_DEMO_MODULES = ["tvc_ai_torch.parallel", "tvc_ai_torch.parallel.mesh",
                         "tvc_ai_torch.training.demos"]
# the distillation chain and its command-line modules
DISTILL_CLIS = ["dagger_distill", "theta_distill", "select_student", "suite_feasibility",
                "cross_transfer", "build_ctrl_library", "pilot_eval"]
DISTILL_MODULES = ["tvc_ai_torch.training.cem", "tvc_ai_torch.training.dagger",
                   "tvc_ai_torch.training.theta_student", "tvc_ai_torch.training.pilot",
                   *(f"tvc_ai_torch.{name}" for name in DISTILL_CLIS)]


# the single-env core, the gym envs and their registry, the diagnostics CLIs
SINGLE_ENV_CLIS = ["policy_breakdown", "ablate_dr", "inspect_policy", "diagnose_cg",
                   "lqr_balance", "scripted_controller"]
SINGLE_ENV_MODULES = ["tvc_ai_torch.env.single", "tvc_ai_torch.env.wrappers",
                      "tvc_ai_torch.env.registration",
                      *(f"tvc_ai_torch.{name}" for name in SINGLE_ENV_CLIS)]
# the last modules: HPO, the plots, the parity gate, the console scripts
REMNANT_CLIS = ["tune_hyperparameters", "pybullet_goldens", "visualize", "cli"]
REMNANT_MODULES = ["tvc_ai_torch.tuning", "tvc_ai_torch.tuning.hpo", "tvc_ai_torch.viz",
                   "tvc_ai_torch.viz.visualize", "tvc_ai_torch.eval.pybullet_parity",
                   *(f"tvc_ai_torch.{name}" for name in REMNANT_CLIS)]


# the reader of the JAX package's flax msgpack files (it decodes them itself:
# msgpack is as foreign to the card's host as flax)
ARTIFACT_MODULES = ["tvc_ai_torch.utils.flax_msgpack"]
# the reader of the JAX package's orbax checkpoints (zstd, OCDBT and zarr
# decoded here: none of orbax, tensorstore or zstandard is on the card's host)
ORBAX_MODULES = ["tvc_ai_torch.utils.zstd", "tvc_ai_torch.utils.ocdbt",
                 "tvc_ai_torch.utils.orbax_read"]
# the reference's installation check, performance suite and test runner
REFERENCE_TOOL_MODULES = ["tvc_ai_torch.verify_installation", "tvc_ai_torch.benchmark",
                          "tvc_ai_torch.run_tests"]


@pytest.mark.parametrize("name", EXTENSION_MODULES + EXPORT_MODULES + PARALLEL_DEMO_MODULES
                         + DISTILL_MODULES + SINGLE_ENV_MODULES + REMNANT_MODULES
                         + ARTIFACT_MODULES + ORBAX_MODULES + REFERENCE_TOOL_MODULES)
def test_extension_module_imports_no_jax(name):
    tree = ast.parse(Path(importlib.util.find_spec(name).origin).read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not roots & set(FOREIGN), (name, roots)


def test_orbax_reader_imports_without_its_libraries():
    """The orbax reader imports, and reads a checkpoint, with orbax,
    tensorstore and zstandard blocked."""
    code = (
        "import sys\n"
        "for name in ('orbax', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {ORBAX_MODULES!r}:\n"
        "    __import__(name)\n"
        "from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints\n"
        "m = OrbaxCheckpoints('tests/fixtures/jax_orbax/checkpoints')\n"
        "agent = m.read(m.latest_step(), prefix=('agent',))\n"
        "assert agent['log_alpha'].shape == ()\n"
        f"bad = sorted(m for m in sys.modules if m and m.split('.')[0] in {FOREIGN!r}"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_without_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['chip_smoke.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "finally:\n"
        "    bad = [m for m in sys.modules\n"
        f"           if m.split('.')[0] in {FOREIGN!r}]\n"
        "    assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _flax_params(module: torch.nn.Module) -> dict:
    """A module's weights laid out as flax params (numpy, kernels (in, out))."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        *path, kind = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node["kernel" if kind == "weight" else "bias"] = (t.T if kind == "weight" else t).numpy()
    return {"params": tree}


def _numpy_sac_state(cfg: sac.SACConfig) -> dict:
    """A JAX-shaped ``SACState`` (optax's chain states as tuples) built
    without JAX."""
    src = sac.init(10, 2, cfg, device="cpu")

    def chain(m):
        return ((), ({"mu": _flax_params(m), "nu": _flax_params(m), "count": 0}, ()))

    return {
        "actor_params": _flax_params(src.actor), "critic_params": _flax_params(src.critic),
        "target_critic_params": _flax_params(src.target_critic),
        "log_alpha": src.log_alpha.numpy(), "actor_opt": chain(src.actor),
        "critic_opt": chain(src.critic),
        "alpha_opt": ({"mu": src.log_alpha.numpy() * 0, "nu": src.log_alpha.numpy() * 0,
                       "count": 0}, ()),
        "step": 0, "ema_actor_params": None,
    }


ENTRY_POINTS = ["reset", "actor", "env_state_from_numpy", "sac_init", "replay_create",
                "init_carry", "sac_state_from_numpy", "trainer", "run_suite", "run_all_suites",
                "td3_init", "ppo_init", "ensemble_init_carry", "ensemble_agent",
                "ensemble_trainer", "transformer_actor", "icm_init", "rnd_init", "high_init",
                "sac_agent", "init_population", "safety_net", "load_agent_file",
                "generate_demonstrations", "refine_per_draw",
                "dagger_init_state", "cem_dagger_state", "theta_state", "load_jax_student"]
JAX_STUDENT = ROOT / "tests" / "fixtures" / "jax_msgpack" / "student.msgpack"
SMALL_DAGGER = dagger.DaggerConfig(num_envs=2, rollout_steps=2, capacity=8, batch_size=4,
                                   train_steps=1)
# a small trainer run (the overrides of tests/test_trainer.py::tiny_cfg)
TINY = ["training.total_timesteps=128", "training.num_envs=8", "training.rollout_steps=16",
        "training.eval_episodes=2", "algorithms.sac.hidden_dims=[16,16]",
        "algorithms.sac.buffer_size=2048", "algorithms.sac.learning_starts=64",
        "algorithms.sac.batch_size=16", "curriculum.enabled=false", "logging.tensorboard=false"]
AGENT_DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_cuda(entry, tmp_path):
    """With no device given an entry point asks for CUDA: it raises where
    there is none, and places its tensors on the card where there is one."""
    small = sac.SACConfig((8, 8), buffer_size=64)
    agent = sac.init(10, 2, small, device=AGENT_DEVICE)
    calls = {
        "reset": lambda: rocket_env.reset(EnvParams(), 2)[1],
        "actor": lambda: next(sac.make_actor(10, 2, sac.SACConfig((8, 8))).parameters()),
        "env_state_from_numpy": lambda: env_state_from_numpy(
            rocket_env.reset(EnvParams(), 2, device="cpu")[0]
        ).fuel,
        "sac_init": lambda: sac.init(10, 2, small).log_alpha,
        "replay_create": lambda: ReplayBuffer.create(8, {"obs": torch.zeros(10)}).data["obs"],
        "init_carry": lambda: loop.init_carry(
            EnvParams(), small, loop.TrainLoopConfig(num_envs=4, rollout_steps=1)).obs,
        "sac_state_from_numpy": lambda: sac_state_from_numpy(
            _numpy_sac_state(small), small, 10, 2).log_alpha,
        "trainer": lambda: Trainer(load_config(None, TINY), output_dir=tmp_path / "run").carry.obs,
        "run_suite": lambda: run_suite(agent, small, "standard", num_episodes=2).stats.returns,
        "run_all_suites": lambda: run_all_suites(
            agent, small, tmp_path / "suites", episodes_scale=0.01)["stress"].stats.returns,
        "td3_init": lambda: next(td3.init(10, 2, td3.TD3Config((8, 8))).actor.parameters()),
        "ppo_init": lambda: ppo.init(10, 2, ppo.PPOConfig((8, 8))).opt.mu[0],
        "ensemble_init_carry": lambda: ensemble.init_carry(
            EnvParams(), ensemble.EnsembleConfig(sac=small, td3=td3.TD3Config((8, 8)),
                                                 ppo=ppo.PPOConfig((8, 8))), 4).obs,
        "ensemble_agent": lambda: torch.rand(1, generator=ensemble.MultiAlgorithmAgent(
        ).generator, device="cuda"),
        "ensemble_trainer": lambda: EnsembleTrainer(
            load_config(None, [*TINY, "training.algorithm=ensemble"]),
            output_dir=tmp_path / "ens").carry.obs,
        "transformer_actor": lambda: next(TransformerActor(10, 2, 16, 2, 1).parameters()),
        "icm_init": lambda: next(icm.init(icm.CuriosityConfig(hidden_dim=8)).nets.parameters()),
        "rnd_init": lambda: rnd.init(rnd.RNDConfig(hidden_dims=(8,), embed_dim=4)).bonus_var,
        "high_init": lambda: hierarchical.init_high(10, hierarchical.HierarchicalConfig()).step,
        "sac_agent": lambda: SACAgent(10, 2, small).log_alpha,
        "init_population": lambda: population.init_population(
            EnvParams(), small, population.PopulationConfig(num_agents=2, envs_per_agent=4)
        )[1].obs,
        "safety_net": lambda: next(SafetyCorrectionNet().parameters()),
        "load_agent_file": lambda: load_agent_state(agent_file(), 10, 2, small).log_alpha,
        "generate_demonstrations": lambda: demos.generate_demonstrations(
            EnvParams(), ANY_DESIGN, 2, 1)[0]["obs"],
        "refine_per_draw": lambda: cem.refine_per_draw(
            EnvParams(), rocket_env.reset(EnvParams(), 2)[0],
            torch.zeros(2, cem.THETA_DIM, device="cuda"),
            cem.CEMConfig(pop=2, elites=1, generations=1, horizon=2))[0],
        "dagger_init_state": lambda: dagger.init_state(
            EnvParams(), sac.make_actor(10, 2, small, AGENT_DEVICE), SMALL_DAGGER, 10, 2).data_obs,
        "cem_dagger_state": lambda: dagger.init_cem_state(
            sac.make_actor(10, 2, small, AGENT_DEVICE), SMALL_DAGGER, 10, 2).data_w,
        "theta_state": lambda: theta_student.init_theta_state(
            theta_student.ThetaDaggerConfig(num_envs=2, rollout_steps=2, capacity=8,
                                            history_len=1, hidden_dims=(8,)), 10).data_theta,
        "load_jax_student": lambda: load_agent_state(JAX_STUDENT, 10, 2,
                                                     sac.SACConfig((32, 32))).log_alpha,
    }

    def agent_file():
        SACAgent(10, 2, small, device=AGENT_DEVICE).save(tmp_path / "agent.pt")
        return tmp_path / "agent.pt"

    if torch.cuda.is_available():
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()


@pytest.mark.parametrize("entry", ["train", "evaluate", "train_ensemble", "train_ppo",
                                   "train_td3"])
def test_command_line_entry_points_default_to_cuda(entry, tmp_path):
    """``python -m tvc_ai_torch.train`` (each ``training.algorithm`` route) /
    ``.evaluate`` ask for CUDA unless ``--device cpu`` is given."""
    out = tmp_path / "run"
    if entry == "train":
        run = lambda: train_main(["--output-dir", str(out), *TINY])  # noqa: E731
    elif entry.startswith("train_"):
        algo = entry.removeprefix("train_")
        run = lambda: train_main(  # noqa: E731
            ["--output-dir", str(out), *TINY, f"training.algorithm={algo}"])
    else:
        Trainer(load_config(None, TINY), output_dir=out, device=AGENT_DEVICE).train()
        run = lambda: evaluate_main(  # noqa: E731
            ["--model_path", str(out / "checkpoints"), "--hidden", "16", "16",
             "--episodes_scale", "0.01", "--output_dir", str(tmp_path / "eval")])
    if torch.cuda.is_available():
        assert run() == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_eval_path_reaches_physics_only_through_k1(monkeypatch):
    """The evaluation rollout integrates through K1's wrapper (which launches
    K1 on a CUDA tensor or raises); it never calls the plain integrator
    itself. On the CPU the wrapper's plain route is what runs."""
    from tvc_ai_torch.eval.rollout import make_eval_fn, make_trajectory_fn
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("the eval path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    small = sac.SACConfig((8, 8))
    agent = sac.init(10, 2, small, device="cpu")
    params = EnvParams(max_episode_steps=40)
    gen = torch.Generator().manual_seed(0)
    stats = make_eval_fn(small, 3, check_every=10**9)(agent, gen, params)
    make_trajectory_fn(small, 3)(agent, gen, params)
    assert calls == ["cpu"] * 80 and stats.lengths.shape == (3,)


def test_ensemble_path_reaches_physics_only_through_k1(monkeypatch):
    """The ensemble iteration (every acting member) and the stand-alone PPO
    iteration integrate through K1's wrapper, never the plain integrator."""
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("the ensemble path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    cfg = ensemble.EnsembleConfig(
        sac=sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8),
        td3=td3.TD3Config((8, 8), batch_size=8), ppo=ppo.PPOConfig((8, 8), n_epochs=1))
    params = EnvParams(max_episode_steps=3)
    for actor in ensemble.ACTORS:
        carry = ensemble.init_carry(params, cfg, 4, device="cpu", seed=1)
        carry, _ = ensemble.make_ensemble_iteration(actor, cfg, 4, 3)(carry, [1, 1, 1], params)
        assert carry.sac.step == 2, actor   # the gate opens at the second step
    gen = torch.Generator().manual_seed(0)
    states, obs = rocket_env.reset(params, 4, "cpu", generator=gen)
    ppo.make_train_iteration(cfg.ppo, 4, 3, 10, 2)(
        ppo.init(10, 2, cfg.ppo, device="cpu"), states, obs, gen, params)
    assert calls == ["cpu"] * (3 * len(ensemble.ACTORS) + 3)


def test_export_command_defaults_to_cuda(tmp_path):
    """``python -m tvc_ai_torch.export`` asks for CUDA unless ``--cpu`` is
    given; where TensorFlow is absent (the card's host) it then raises
    ``ExportError``."""
    SACAgent(10, 2, sac.SACConfig((8, 8), buffer_size=64), device=AGENT_DEVICE).save(
        tmp_path / "agent.pt")
    argv = ["--model_path", str(tmp_path / "agent.pt"), "--obs_dim", "10", "--hidden", "8", "8",
            "--output_dir", str(tmp_path / "export")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_main(argv)
    elif importlib.util.find_spec("tensorflow") is None:
        with pytest.raises(ExportError):
            export_main(argv)
    else:
        assert export_main(argv) == 0


def test_export_and_population_paths_reach_physics_only_through_k1(monkeypatch):
    """The export's calibration rollout and the population iteration
    integrate through K1's wrapper, never the plain integrator."""
    from tvc_ai_torch.env.wrappers import RocketConfig
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("an export or population path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    export_params = RocketConfig().to_env_params(domain_randomization=False, sensor_noise=False,
                                                 max_episode_steps=1000)
    obs = collect_representative_obs(None, export_params, 200, 10, device="cpu")
    assert obs.shape == (200, 10)
    small = sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8)
    pcfg = population.PopulationConfig(num_agents=2, envs_per_agent=4, rollout_steps=3)
    params = EnvParams(max_episode_steps=3)
    carries = population.init_population(params, small, pcfg, device="cpu", seed=1)
    population.make_population_iteration(small, pcfg)(carries, params)
    assert calls == ["cpu"] * (3 + 2 * 3)


def test_port_reads_no_yaml_of_the_jax_package():
    """Every config file the port opens, while it loads each of its YAMLs
    and builds their env, SAC and loop configs, lies in its own
    ``config/`` directory (an audit hook records every ``open``); and no
    string in its code other than a docstring names a path under
    ``tvc_ai_tpu``."""
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev == 'open' and str(args[0]).endswith(('.yaml', '.yml')) else None)\n"
        "from tvc_ai_torch.config import build, loader\n"
        "root = loader.default_config_path().parent\n"
        "names = sorted(p.name for p in root.glob('*.yaml'))\n"
        "for name in names:\n"
        "    cfg = loader.load_config(root / name)\n"
        "    build.build_env_params(cfg)\n"
        "    build.build_sac_config(cfg)\n"
        "    build.build_loop_config(cfg)\n"
        "loader.load_config(None)\n"
        "assert opened and all(p.startswith(str(root)) for p in opened), opened\n"
        "assert len(names) == 17, names\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in MODULES + ["tvc_ai_torch"]:
        tree = ast.parse(Path(importlib.util.find_spec(name).origin).read_text())
        docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                      if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                      and node.body and isinstance(node.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings):
                assert "tvc_ai_tpu" not in node.value, (name, node.value)


def test_robust_option_paths_reach_physics_only_through_k1(monkeypatch):
    """With every robust-training env option on, the SAC iteration, the
    evaluation rollout, the ensemble iteration and the stand-alone PPO
    iteration integrate through K1's wrapper, never the plain integrator."""
    from tvc_ai_torch.env.types import RandomizationConfig, RewardConfig
    from tvc_ai_torch.eval.rollout import make_eval_fn
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("a robust-option path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    params = EnvParams(
        randomization=RandomizationConfig(
            enabled=True, sensor_noise_enabled=True, feasible_only=True, dr_mixture_enabled=True,
            dr_prob=0.5, sensor_dropout_enabled=True, sensor_dropout_prob=0.2,
            actuator_delay=True),
        reward=RewardConfig(survival_normalized_success=True, equilibrium_relative_shaping=True),
        max_episode_steps=3)
    small = sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8)
    loop_cfg = loop.TrainLoopConfig(num_envs=4, rollout_steps=3)
    carry = loop.init_carry(params, small, loop_cfg, device="cpu", seed=1)
    loop.make_train_iteration(small, loop_cfg)(carry, params)
    gen = torch.Generator().manual_seed(0)
    make_eval_fn(small, 3, check_every=10**9)(sac.init(10, 2, small, device="cpu"), gen, params)
    cfg = ensemble.EnsembleConfig(sac=small, td3=td3.TD3Config((8, 8), batch_size=8),
                                  ppo=ppo.PPOConfig((8, 8), n_epochs=1))
    carry = ensemble.init_carry(params, cfg, 4, device="cpu", seed=1)
    ensemble.make_ensemble_iteration("ensemble", cfg, 4, 3)(carry, [1, 1, 1], params)
    states, obs = rocket_env.reset(params, 4, "cpu", generator=gen)
    ppo.make_train_iteration(cfg.ppo, 4, 3, 10, 2)(
        ppo.init(10, 2, cfg.ppo, device="cpu"), states, obs, gen, params)
    assert calls == ["cpu"] * (3 + 3 + 3 + 3)


def test_extension_paths_reach_physics_only_through_k1(monkeypatch):
    """With ICM, the physics-informed loss, RND and hierarchical RL on (a
    transformer actor on a history window), the SAC iteration and the
    hierarchical evaluation integrate through K1's wrapper only."""
    from tvc_ai_torch.env.types import RandomizationConfig
    from tvc_ai_torch.eval.rollout import make_hier_eval_fn
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("an extension path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    params = EnvParams(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
                       max_episode_steps=3)
    small = sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8,
                          architecture="transformer", transformer_d_model=16,
                          transformer_heads=2, transformer_layers=1)
    loop_cfg = loop.TrainLoopConfig(num_envs=4, rollout_steps=3, history_len=2,
                                    use_curiosity=True, use_physics_informed=True,
                                    use_rnd=True, use_hierarchical=True)
    carry = loop.init_carry(params, small, loop_cfg, device="cpu", seed=1)
    carry, _ = loop.make_train_iteration(small, loop_cfg)(carry, params)
    make_hier_eval_fn(small, loop_cfg.hierarchical, 3, history_len=2, check_every=10**9)(
        (carry.agent, carry.hier), torch.Generator().manual_seed(0), params)
    assert calls == ["cpu"] * (3 + 3)


# an LQR design for the path tests (any gains: these tests time no control)
ANY_DESIGN = demos.LQRDesign(gain=np.full(6, 0.1, np.float32), gain_pitch=np.full(6, 0.1, np.float32),
                             z_eq=np.float32(0.5), trim_slope=np.float32(-1.8),
                             trim_slope_pitch=np.float32(1.8))


def test_demo_path_reaches_physics_only_through_k1(monkeypatch):
    """The demonstration rollout integrates through K1's wrapper, never the
    plain integrator (the LQR design's own step map is the plain one, on the
    CPU, by design)."""
    from tvc_ai_torch.env.types import RandomizationConfig
    from tvc_ai_torch.physics import integrator

    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].pos.device.type)
        return integrator.step(*args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("the demo rollout called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    params = EnvParams(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
                       max_episode_steps=3, drift_obs_enabled=True)
    trans, stats = demos.generate_demonstrations(params, ANY_DESIGN, 4, 5, history_len=2,
                                                 device="cpu",
                                                 generator=torch.Generator().manual_seed(0))
    assert calls == ["cpu"] * 5 and trans["obs"].shape == (5, 4, 28)
    assert stats["demo_episodes"] >= 4


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# each distillation command's smallest run (the card's host runs it)
DISTILL_TINY = {
    "dagger_distill": ["--iters", "1", "--envs", "2", "--rollout_steps", "2", "--train_steps",
                       "1", "--batch", "4", "--history", "2", "--hidden", "8", "8",
                       "--eval_episodes", "2", "--cem_pop", "2", "--cem_gens", "1",
                       "--cem_horizon", "2"],
    "theta_distill": ["--iters", "1", "--envs", "2", "--rollout_steps", "2", "--train_steps",
                      "1", "--batch", "4", "--history", "2", "--hidden", "8", "8",
                      "--eval_episodes", "2", "--cem_pop", "2", "--cem_gens", "1",
                      "--cem_horizon", "2"],
    "select_student": ["--episodes", "2", "--confirm_episodes", "2", "--history", "2",
                       "--hidden", "8", "8"],
    "suite_feasibility": ["--episodes", "2", "--steps", "2", "--suite", "robustness"],
    "cross_transfer": ["--episodes", "2", "--cem_pop", "2", "--cem_gens", "1",
                       "--cem_horizon", "2"],
    "build_ctrl_library": ["--episodes", "2", "--cem_pop", "2", "--cem_gens", "1",
                           "--cem_horizon", "2"],
    "pilot_eval": ["--episodes", "2", "--particles", "2", "--steps", "2", "--replan", ""],
}


@pytest.mark.parametrize("name", DISTILL_CLIS)
def test_distill_commands_default_to_cuda(name, tmp_path):
    """``python -m tvc_ai_torch.<name>`` asks for CUDA unless ``--cpu`` is
    given: it raises where there is none, before it writes anything."""
    main = importlib.import_module(f"tvc_ai_torch.{name}").main
    argv = list(DISTILL_TINY[name])
    if name in ("dagger_distill", "theta_distill"):
        argv += ["--out", str(tmp_path / "out")]
    elif name == "select_student":
        argv += ["--dir", str(tmp_path / "out")]
    elif name == "build_ctrl_library":
        argv += ["--out", str(tmp_path / "lib.npz")]
    if torch.cuda.is_available():
        if name == "select_student":
            dagger.save_student(tmp_path / "out" / "student.pt",
                                sac.make_actor(32, 2, sac.SACConfig((8, 8)), "cuda"),
                                sac.SACConfig((8, 8)), 32, 2)
        assert main(argv) in (0, 1)   # 1: no draw solved, as the reference says
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        assert not (tmp_path / "out").exists()


def test_distill_paths_reach_physics_only_through_k1(monkeypatch):
    """The schedule's verification, the CEM scoring, both DAgger iterations,
    the θ-student's and the pilot (prediction, selection, replan) integrate
    through K1's wrapper, never the plain integrator, and every input K1
    gets passes its check (dtype, shape, contiguity, 16-byte alignment: the
    wrapper checks them on the CPU route too)."""
    from tvc_ai_torch.env.types import RandomizationConfig
    from tvc_ai_torch.ops import step_kernel as k1

    calls = []

    def wrapper(state, control, params, *args, **kwargs):
        calls.append(state.pos.shape[0])
        return k1.step_kernel(state, control, params, *args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("a distillation path called the plain integrator")

    gen = torch.Generator().manual_seed(0)
    params = EnvParams(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
                       drift_obs_enabled=True, action_obs_enabled=True, max_episode_steps=3)
    # the design's linearization is the plain step map on the host, by design
    sched = demos.design_lqr_schedule(params, 2, 2, verify=False)
    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(pilot, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    # the verification: 2 × 2 cells × 4 variants × 1 rollout, 3 steps
    demos.design_lqr_schedule(params, 2, 2, verify_rollouts=1, verify_horizon=3, device="cpu",
                              generator=gen)
    assert calls == [16] * 3
    calls.clear()
    states, obs = rocket_env.reset(params, 3, "cpu", generator=gen)
    ccfg = cem.CEMConfig(pop=2, elites=1, generations=2, horizon=3)
    cem.refine_per_draw(params, states, cem.theta_for_states(sched, states), ccfg, generator=gen)
    assert calls == [6] * 6
    calls.clear()
    small = sac.SACConfig((8, 8))
    dcfg = dagger.DaggerConfig(num_envs=3, rollout_steps=2, capacity=6, batch_size=4,
                               train_steps=1, history_len=2)
    actor = sac.make_actor(32, 2, small, "cpu")
    state = dagger.init_state(params, actor, dcfg, 16, 2, "cpu", gen)
    dagger.make_dagger_iteration(params, lambda s: torch.zeros(3, 2), small, dcfg, 16, 2)(
        state, 0.5, generator=gen)
    dagger.make_cem_dagger_iteration(params, sched, small, dcfg, 16, 2, ccfg)(
        dagger.init_cem_state(actor, dcfg, 16, 2, "cpu"), 0.5, generator=gen)
    tcfg = theta_student.ThetaDaggerConfig(num_envs=3, rollout_steps=2, capacity=6,
                                           batch_size=4, train_steps=1, history_len=2,
                                           hidden_dims=(8,))
    theta_student.make_theta_dagger_iteration(params, sched, tcfg, 16, ccfg)(
        theta_student.init_theta_state(tcfg, 16, "cpu"), 0.5, generator=gen)
    assert calls == [3] * 2 + ([6] * 6 + [3] * 2) * 2
    calls.clear()
    pcfg = pilot.PilotConfig(particles=4)
    ps = pilot.init_pilot(obs, params, pcfg, generator=gen)
    ps, act = pilot.pilot_act(ps, sched, params, pcfg)
    ps = pilot.pilot_observe(ps, obs, params, pcfg, generator=gen)
    ps = pilot.select_from_library(ps, torch.zeros(5, cem.THETA_DIM), params, ccfg, states,
                                   n_samples=2, generator=gen)
    pilot.replan(ps, sched, params, ccfg, states, generator=gen)
    assert calls == [12] + [30] * 3 + [6] * 6


def test_single_env_core_imports_without_gymnasium():
    """The core, the env package and the diagnostics CLIs import with
    gymnasium blocked, and the gym classes' gymnasium-free bases reset and
    step; only the gym names need it."""
    code = (
        "import importlib, sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import tvc_ai_torch.env as env\n"
        "from tvc_ai_torch.env.single import (EnhancedRocketTVC, RocketConfig, RocketTVC,\n"
        "                                     SingleEnv)\n"
        "for cls, width in ((RocketTVC, 8), (EnhancedRocketTVC, 10)):\n"
        "    shell = cls(device='cpu')\n"
        "    assert shell.reset(seed=1)[0].shape == (width,)\n"
        "    assert shell.step([0.1, 0.0])[0].shape == (width,)\n"
        f"for name in {SINGLE_ENV_CLIS!r}:\n"
        "    importlib.import_module('tvc_ai_torch.' + name)\n"
        "assert env.RocketConfig is RocketConfig\n"
        "try:\n"
        "    env.RocketTVCEnv\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('the gym names need gymnasium')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", SINGLE_ENV_CLIS)
def test_single_env_commands_default_to_cuda(name, tmp_path):
    """``python -m tvc_ai_torch.<name>`` asks for CUDA unless ``--cpu`` is
    given: it raises where there is none, before it reads anything."""
    main = importlib.import_module(f"tvc_ai_torch.{name}").main
    model = str(tmp_path / "missing.pt")
    argv = {"policy_breakdown": ["--model", model], "ablate_dr": ["--model_path", model],
            "inspect_policy": ["--model_path", model], "diagnose_cg": ["--model_path", model],
            "lqr_balance": ["--cg", "0.0", "--steps", "2"],
            "scripted_controller": ["--cg", "0.0", "--steps", "2"]}[name]
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke.py [17c] runs the commands there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("factory", ["make_training_env", "make_evaluation_env", "make_debug_env",
                                     "make_legacy_env", "gym_make", "single_env"])
def test_single_env_factories_default_to_cuda(factory):
    """The gym factories, ``gym.make`` of the port's ids and the core ask for
    CUDA when no device is given."""
    import gymnasium as gym

    from tvc_ai_torch.env import registration
    from tvc_ai_torch.env.single import SingleEnv

    registration.register_envs()
    make = {"gym_make": lambda: gym.make("tvc_ai_torch/EnhancedRocketTVC-v0").unwrapped,
            "single_env": lambda: SingleEnv(EnvParams())}.get(
        factory, getattr(registration, factory, None))
    if torch.cuda.is_available():
        made = make()
        core = made if isinstance(made, SingleEnv) else made.core
        assert core.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_single_env_paths_reach_physics_only_through_k1(monkeypatch):
    """The gym step (both classes), the core and the six diagnostics CLIs'
    rollouts integrate through K1's wrapper, never the plain integrator, and
    every input K1 gets passes its check (dtype, shape, contiguity, 16-byte
    alignment), a replaced CG offset included."""
    from tvc_ai_torch import (ablate_dr, diagnose_cg, inspect_policy, lqr_balance,
                              policy_breakdown, scripted_controller)
    from tvc_ai_torch.env.wrappers import EnhancedRocketTVCEnv, RocketTVCEnv
    from tvc_ai_torch.eval.rollout import EvalDraws
    from tvc_ai_torch.ops import step_kernel as k1

    calls = []

    def wrapper(state, control, params, *args, **kwargs):
        calls.append(state.pos.shape[0])
        return k1.step_kernel(state, control, params, *args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("a single-env path called the plain integrator")

    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    for cls in (EnhancedRocketTVCEnv, RocketTVCEnv):
        env = cls(domain_randomization=True, sensor_noise=True, device="cpu")
        env.reset(seed=1)
        for _ in range(3):
            env.step(np.full(2, 0.1, np.float32))
    assert calls == [1] * 6
    calls.clear()
    small = sac.SACConfig((8, 8))
    actor = sac.make_actor(10, 2, small, "cpu")
    params = diagnose_cg.env_params()
    inspect_policy.inspect(actor, dataclasses.replace(params, max_episode_steps=3), 1, 1, "cpu")
    diagnose_cg.diagnose(actor, params, [0.02], 3, 1, "cpu")
    monkeypatch.setattr(demos, "design_lqr", lambda p: ANY_DESIGN)
    lqr_balance.probe(params, [0.02], "privileged", 3, 0, False, "cpu")
    scripted_controller.probe(params, [0.02], "integral", (5.0, 2.0, 0.2, 0.5, 1.0), 3, 0,
                              False, False, "cpu")
    assert calls == [1] * 12
    calls.clear()
    scripted_controller.probe(params, [0.02], "cascade", None, 2, 0, True, False, "cpu")
    assert calls == [3] * 2   # the cascade grid's 3 gain sets as one batch
    calls.clear()
    suite = dataclasses.replace(policy_breakdown.suite_params("robustness", False, "ema"),
                                max_episode_steps=2)
    gen = torch.Generator().manual_seed(0)
    draws = EvalDraws(reset=rocket_env.draw_reset(suite, 4, torch.device("cpu"), gen))
    policy_breakdown.breakdown(
        lambda a, o: sac.select_action(a, o, deterministic=True),
        sac.make_actor(16, 2, small, "cpu"), suite, 4, 1, draws, gen)
    ablate_dr.ablate(sac.init(10, 2, small, device="cpu"), small, 4, 1, 0, horizon=2)
    assert calls == [4] * 2 + [4] * 2 * len(ablate_dr.axes())


REMNANT_ENTRIES = ["make_sac_objective", "torch_trajectory", "check_goldens",
                   "device_manager_auto", "tune_hyperparameters_cli", "pybullet_goldens_cli"]


@pytest.mark.parametrize("entry", REMNANT_ENTRIES)
def test_remnant_entry_points_default_to_cuda(entry, tmp_path):
    """The HPO objective, the parity trajectory and check, the device
    manager's ``"auto"`` and the two new device commands ask for CUDA unless
    the CPU is named: they raise where there is none, before they write
    anything."""
    from tvc_ai_torch import pybullet_goldens, tune_hyperparameters
    from tvc_ai_torch.eval import pybullet_parity
    from tvc_ai_torch.tuning import hpo
    from tvc_ai_torch.utils.devices import DeviceManager

    out = tmp_path / "out"
    calls = {
        "make_sac_objective": lambda: hpo.make_sac_objective(total_steps=64, num_envs=1),
        "torch_trajectory": lambda: pybullet_parity.torch_trajectory(np.zeros((2, 2))),
        "check_goldens": lambda: pybullet_parity.check_goldens(out / "missing.npz"),
        "device_manager_auto": lambda: DeviceManager("auto"),
        "tune_hyperparameters_cli": lambda: tune_hyperparameters.main(
            ["--n_trials", "1", "--trial_steps", "64", "--num_envs", "1",
             "--output_dir", str(out)]),
        "pybullet_goldens_cli": lambda: pybullet_goldens.main(
            ["check", "--fixture", str(out / "missing.npz")]),
    }
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke.py [18a]-[18c] runs these there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not out.exists()


def test_remnant_paths_reach_physics_only_through_k1(monkeypatch):
    """The parity trajectory and the HPO objective (its training iterations
    and its evaluations) integrate through K1's wrapper, never the plain
    integrator on their own, and every input K1 gets passes its check
    (dtype, shape, contiguity, 16-byte alignment)."""
    from tvc_ai_torch.eval import pybullet_parity
    from tvc_ai_torch.ops import step_kernel as k1
    from tvc_ai_torch.physics import integrator
    from tvc_ai_torch.tuning import hpo

    calls, inside = [], []
    original, plain_step = k1.step_kernel, integrator.step

    def wrapper(state, control, params, *args, **kwargs):
        calls.append(state.pos.shape[0])
        inside.append(True)
        try:
            return original(state, control, params, *args, **kwargs)
        finally:
            inside.pop()

    def plain(*args, **kwargs):
        if not inside:
            raise AssertionError("a path called the plain integrator outside K1's wrapper")
        return plain_step(*args, **kwargs)

    monkeypatch.setattr(k1, "step_kernel", wrapper)
    monkeypatch.setattr(integrator, "step", plain)
    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    actions = pybullet_parity.SCENARIOS[-1].actions()[:5]
    traj = pybullet_parity.torch_trajectory(actions, device="cpu")
    assert traj.shape == (5, 13) and calls == [1] * 5
    calls.clear()

    class Trial:
        number = 0

        def suggest_float(self, name, low, high, log=False):
            return low

        def suggest_categorical(self, name, choices):
            return choices[0]

        def report(self, value, step):
            pass

        def should_prune(self):
            return False

    hpo.make_sac_objective(total_steps=64, num_envs=1, eval_episodes=2, device="cpu")(Trial())
    assert calls[:64] == [1] * 64 and set(calls[64:]) == {2}


@pytest.mark.parametrize("name", REFERENCE_TOOL_MODULES)
def test_reference_tools_import_no_pre_port_file(name):
    """The installation check, the suite and the runner import nothing of
    the repo outside the port: not the JAX build's scripts they mirror."""
    tree = ast.parse(Path(importlib.util.find_spec(name).origin).read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    pre_port = {p.stem for p in ROOT.glob("*.py")} | {"tests", "scripts", "native"}
    assert not roots & pre_port, (name, roots & pre_port)


REFERENCE_TOOL_ENTRIES = ["verify_installation", "benchmark_main", "bench_env_steps",
                          "bench_inference", "bench_training", "bench_memory",
                          "bench_convergence"]


@pytest.mark.parametrize("entry", REFERENCE_TOOL_ENTRIES)
def test_reference_tools_default_to_cuda(entry, tmp_path):
    """``python -m tvc_ai_torch.verify_installation`` fails on the torch
    device where there is no CUDA device; the suite and each of its
    functions raise there, before they write anything."""
    from tvc_ai_torch import benchmark, verify_installation

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke.py [23] runs these there")
    out = tmp_path / "results.json"
    if entry == "verify_installation":
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert verify_installation.main([]) == 1
        assert "[FAIL] torch device: device 'cuda' requested" in buf.getvalue()
        return
    call = (lambda: benchmark.main(["--out", str(out)])) if entry == "benchmark_main" else (
        lambda: getattr(benchmark, entry)({}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not out.exists()


def test_reference_tool_paths_reach_physics_only_through_k1(monkeypatch):
    """The installation check's env step, the suite's single env (N = 1),
    batched env and convergence run integrate through K1's wrapper, never
    the plain integrator on their own, and every input K1 gets passes its
    check (dtype, shape, contiguity, 16-byte alignment)."""
    from tvc_ai_torch import benchmark, verify_installation
    from tvc_ai_torch.ops import step_kernel as k1
    from tvc_ai_torch.physics import integrator

    calls, inside = [], []
    original, plain_step = k1.step_kernel, integrator.step

    def wrapper(state, control, params, *args, **kwargs):
        calls.append(state.pos.shape[0])
        inside.append(True)
        try:
            return original(state, control, params, *args, **kwargs)
        finally:
            inside.pop()

    def plain(*args, **kwargs):
        if not inside:
            raise AssertionError("a path called the plain integrator outside K1's wrapper")
        return plain_step(*args, **kwargs)

    monkeypatch.setattr(k1, "step_kernel", wrapper)
    monkeypatch.setattr(integrator, "step", plain)
    monkeypatch.setattr(rocket_env, "step_kernel", wrapper)
    monkeypatch.setattr(rocket_env, "physics_step", plain)
    with contextlib.redirect_stdout(io.StringIO()):
        assert verify_installation.main(["--cpu"]) == 0
    assert calls == [1]
    calls.clear()
    # the single env is never reset: it crashes within ~40 steps and steps on, grounded
    benchmark.bench_env_steps({}, "cpu", single_steps=60, num_envs=4, steps=2, calls=1)
    assert calls == [1] * 61 + [4] * 4
    calls.clear()
    benchmark.bench_convergence({}, "cpu", iterations=2, num_envs=4, rollout_steps=2,
                                hidden_dims=(8, 8), batch_size=4, buffer_size=16,
                                learning_starts=8)
    assert calls == [4] * 4
