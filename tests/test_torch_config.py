"""The port's config tree, YAML loader and build functions against the JAX package's."""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from tvc_ai_torch.agents.sac import SACConfig
from tvc_ai_torch.config import build as t_build
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.config.schema import FrameworkConfig
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_tpu.config import build as j_build
from tvc_ai_tpu.config import loader as j_loader

ROOT = Path(__file__).resolve().parent.parent
JAX_CONFIGS = sorted((ROOT / "tvc_ai_tpu" / "config").glob("*.yaml"))


def _jax_params(jcfg, stage=None):
    """The JAX package's EnvParams for a config, as the port's type."""
    return env_params_from_numpy(jax.tree.map(np.asarray, j_build.build_env_params(jcfg, stage)))


def assert_loop_configs_equal(port, ref) -> None:
    """Every field of two ``TrainLoopConfig``s, the sub-configs (safety, ICM,
    RND, physics-informed, hierarchical) field by field."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def assert_params_equal(port, ref) -> None:
    """Field by field: bools and ints exact, floats equal as float32."""
    a, b = dataclasses.asdict(port), dataclasses.asdict(ref)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, float):
            assert np.float32(x) == np.float32(y), (path, x, y)
        else:
            assert type(x) is type(y) and x == y, (path, x, y)

    walk(a, b, "params")
    assert port == ref


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.name)
def test_every_yaml_parses_as_in_jax(path):
    assert t_loader.load_config(path).to_dict() == j_loader.load_config(path).to_dict()


def test_default_yaml_is_a_copy():
    port = t_loader.default_config_path()
    ref = j_loader.default_config_path()
    assert port.parent == ROOT / "tvc_ai_torch" / "config"
    assert port.read_text() == ref.read_text()
    assert yaml.safe_load(port.read_text()) == yaml.safe_load(ref.read_text())
    assert t_loader.load_config(None).to_dict() == j_loader.load_config(None).to_dict()
    assert FrameworkConfig().training.checkpointing.period == 25_000


OVERRIDES = [
    ["training.num_envs=64", "training.total_timesteps=5e5"],
    ["algorithms.sac.lr_actor=3e-4", "algorithms.sac.hidden_dims=[64,32]"],
    ["env.domain_randomization.enabled=false", "curriculum.enabled=off"],
    ["curriculum.stages=[{name: a, episodes: 5}, {name: b, cg_offset_max: 0.02}]"],
    ["training.checkpointing.period=50000", "network.history_len=3"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0].split("=")[0])
def test_overrides_as_in_jax(overrides):
    for path in (None, t_loader.default_config_path()):
        port = t_loader.load_config(path, overrides)
        assert port.to_dict() == j_loader.load_config(path, overrides).to_dict()


def test_override_errors():
    with pytest.raises(ValueError, match="key.path=value"):
        t_loader.load_config(None, ["training.num_envs"])
    with pytest.raises(KeyError, match="unknown config keys"):
        t_loader.load_config(None, ["training.num_env=4"])
    with pytest.raises(TypeError, match="cannot coerce"):
        t_loader.load_config(None, ["training.num_envs=many"])
    data = {"a": 1}
    with pytest.raises(TypeError, match="non-mapping"):
        t_loader.apply_override(data, "a.b", 2)


def test_save_config_round_trip(tmp_path):
    cfg = t_loader.load_config(t_loader.default_config_path(), ["training.num_envs=32"])
    t_loader.save_config(cfg, tmp_path / "c.yaml")
    assert t_loader.load_config(tmp_path / "c.yaml").to_dict() == cfg.to_dict()
    assert cfg.training.checkpointing.period == 25_000


def _variants() -> dict:
    """name: (config edit, stage index or None), as the trainer builds them."""
    out = {f"stage{i}": (lambda c: c, i) for i in [None, *range(5)]}

    def nominal_eval(c):
        c.env.domain_randomization.enabled = False
        c.env.domain_randomization.sensor_noise_enabled = c.training.eval_sensor_noise
        return c

    def robust_eval(c):
        c.env.domain_randomization.enabled = True
        c.env.domain_randomization.dr_prob = 1.0
        c.env.domain_randomization.sensor_noise_enabled = c.training.eval_sensor_noise
        c.env.domain_randomization.feasible_only = False
        return c

    def stage_eval(c):
        c.env.domain_randomization.dr_prob = 1.0
        c.env.domain_randomization.sensor_noise_enabled = c.training.eval_sensor_noise
        return c

    def extras(c):
        c.env.trim_observation.enabled = True
        c.env.trim_observation.mode = "integral"
        c.env.drift_observation.enabled = True
        c.env.action_observation.enabled = True
        c.env.max_gimbal_deg = 15.0
        c.env.domain_randomization.progress_rate_min = 0.5
        c.env.domain_randomization.init_omega_max = 0.3
        return c

    out.update(nominal_eval=(nominal_eval, None), robust_eval=(robust_eval, None),
               stage_eval1=(stage_eval, 1), obs_channels=(extras, 2))
    return out


VARIANTS = _variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_build_env_params_as_in_jax(name):
    edit, stage = VARIANTS[name]
    path = t_loader.default_config_path()
    port = edit(t_loader.load_config(path))
    ref = edit(j_loader.load_config(path))
    t_stage = None if stage is None else copy.deepcopy(port.curriculum.stages[stage])
    j_stage = None if stage is None else copy.deepcopy(ref.curriculum.stages[stage])
    if name.startswith("stage_eval"):
        for s in (t_stage, j_stage):
            s.dr_prob = 1.0 if s.dr_prob is not None else None
    assert_params_equal(t_build.build_env_params(port, t_stage), _jax_params(ref, j_stage))


@pytest.mark.parametrize("overrides", [
    [],
    ["stability.enable_lr_scheduling=true", "stability.adaptive_tau=true",
     "algorithms.sac.ent_coef=0.1", "algorithms.sac.ema_decay=0.999",
     "training.update_interval=4", "training.updates_per_step=2"],
    ["training.demo_seeding.enabled=true", "training.demo_seeding.bc_weight=0.5",
     "training.demo_seeding.fraction=0.25", "safety.enabled=false",
     "env.trim_observation.enabled=true", "network.history_len=2"],
], ids=["default", "schedules", "demo_bc"])
def test_sac_and_loop_configs_as_in_jax(overrides):
    path = t_loader.default_config_path()
    port = t_loader.load_config(path, overrides)
    ref = j_loader.load_config(path, overrides)
    t_sac, j_sac = t_build.build_sac_config(port), j_build.build_sac_config(ref)
    for f in dataclasses.fields(SACConfig):
        assert getattr(t_sac, f.name) == getattr(j_sac, f.name), f.name
    assert_loop_configs_equal(t_build.build_loop_config(port), j_build.build_loop_config(ref))


UNPORTED = {
    "bfloat16": ["algorithms.sac.compute_dtype=bfloat16"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_fail_when_built(name):
    cfg = t_loader.load_config(None, UNPORTED[name])
    with pytest.raises(NotImplementedError):
        t_build.build_env_params(cfg)
        t_build.build_sac_config(cfg)
        t_build.build_loop_config(cfg)


EXTENSIONS = {
    "transformer": ["network.architecture_type=transformer", "network.transformer.d_model=64",
                    "network.transformer.num_layers=3", "network.transformer.num_heads=4"],
    "curiosity": ["exploration.curiosity.enabled=true", "exploration.curiosity.hidden_dim=64",
                  "exploration.curiosity.lr=3e-4", "exploration.curiosity.reward_scale=0.02"],
    "rnd": ["exploration.random_network_distillation.enabled=true",
            "exploration.random_network_distillation.network_size=[64,32]",
            "exploration.random_network_distillation.update_frequency=7"],
    "physics_informed": ["physics_informed.enabled=true",
                         "physics_informed.physics_loss_weight=0.3"],
    "hierarchical": ["hierarchical_rl.enabled=true", "hierarchical_rl.num_goals=3",
                     "hierarchical_rl.high_level_lr=2e-4"],
}


@pytest.mark.parametrize("name", sorted(EXTENSIONS))
def test_extension_options_build_as_in_jax(name):
    """The options that raised until the port had their modules build the
    reference's ``SACConfig`` and ``TrainLoopConfig``, the sub-configs field
    by field."""
    port = t_loader.load_config(None, EXTENSIONS[name])
    ref = j_loader.load_config(None, EXTENSIONS[name])
    t_sac, j_sac = t_build.build_sac_config(port), j_build.build_sac_config(ref)
    for f in dataclasses.fields(SACConfig):
        assert getattr(t_sac, f.name) == getattr(j_sac, f.name), f.name
    t_loop = t_build.build_loop_config(port)
    assert_loop_configs_equal(t_loop, j_build.build_loop_config(ref))
    on = {"transformer": t_sac.architecture == "transformer", "curiosity": t_loop.use_curiosity,
          "rnd": t_loop.use_rnd, "physics_informed": t_loop.use_physics_informed,
          "hierarchical": t_loop.use_hierarchical}
    assert [k for k, v in on.items() if v] == [name]


def test_transformer_r3_yaml_is_a_copy():
    """Byte for byte the JAX package's file; the same tree; the env at every
    curriculum stage, ``SACConfig`` and ``TrainLoopConfig`` as JAX builds them."""
    port_path = ROOT / "tvc_ai_torch" / "config" / "transformer_r3.yaml"
    ref_path = ROOT / "tvc_ai_tpu" / "config" / "transformer_r3.yaml"
    assert port_path.read_bytes() == ref_path.read_bytes()
    port, ref = t_loader.load_config(port_path), j_loader.load_config(ref_path)
    assert port.to_dict() == ref.to_dict()
    assert_params_equal(t_build.build_env_params(port), _jax_params(ref))
    for t_stage, j_stage in zip(port.curriculum.stages, ref.curriculum.stages, strict=True):
        assert_params_equal(t_build.build_env_params(port, t_stage), _jax_params(ref, j_stage))
    t_sac, j_sac = t_build.build_sac_config(port), j_build.build_sac_config(ref)
    for f in dataclasses.fields(SACConfig):
        assert getattr(t_sac, f.name) == getattr(j_sac, f.name), f.name
    assert (t_sac.architecture, t_sac.transformer_d_model, t_sac.transformer_heads,
            t_sac.transformer_layers, t_sac.batch_size) == ("transformer", 128, 8, 2, 1024)
    t_loop = t_build.build_loop_config(port)
    assert_loop_configs_equal(t_loop, j_build.build_loop_config(ref))
    assert (t_loop.num_envs, t_loop.updates_per_step, t_loop.history_len) == (512, 16, 4)


ENSEMBLE_YAMLS = ["ensemble_r3.yaml", "ensemble_r4.yaml"]


@pytest.mark.parametrize("name", ENSEMBLE_YAMLS)
def test_ensemble_yaml_is_a_copy(name):
    port = ROOT / "tvc_ai_torch" / "config" / name
    ref = ROOT / "tvc_ai_tpu" / "config" / name
    assert port.read_text() == ref.read_text()
    assert t_loader.load_config(port).to_dict() == j_loader.load_config(ref).to_dict()
    assert t_loader.load_config(port).training.algorithm == "ensemble"


@pytest.mark.parametrize("name", ["default.yaml", *ENSEMBLE_YAMLS, "transformer_r3.yaml"])
def test_build_ensemble_config_as_in_jax(name):
    """Every field of the ensemble config and of its three members."""
    from tvc_ai_torch.training.trainer_ensemble import build_ensemble_config as t_build_ens
    from tvc_ai_tpu.training.trainer_ensemble import build_ensemble_config as j_build_ens

    overrides = ["training.algorithm=ensemble"]
    port = t_build_ens(t_loader.load_config(ROOT / "tvc_ai_torch" / "config" / name, overrides))
    ref = j_build_ens(j_loader.load_config(ROOT / "tvc_ai_tpu" / "config" / name, overrides))
    for f in dataclasses.fields(port):
        if f.name in ("sac", "td3", "ppo"):
            # every field the port has (its SACConfig leaves out the two
            # the reference never reads)
            a, b = getattr(port, f.name), getattr(ref, f.name)
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), (f.name, g.name)
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    if name == "ensemble_r4.yaml":
        assert (port.selection_epsilon, port.sac.batch_size, port.sac.alpha) == (0.2, 1024, 0.05)
        assert not port.sac.automatic_entropy_tuning


# the YAMLs of the robust-training runs the port runs (robust_r4.yaml with
# training.demo_seeding; robust_student_ft_r5.yaml, whose student path the
# port's copy changes, is held in tests/test_torch_distill_cli.py)
ROBUST_YAMLS = ["curriculum_showcase.yaml", "probe_cg.yaml", "robust_full_r4d.yaml",
                "robust_noncg_r4.yaml", "robust_noncg_r4b.yaml", "robust_noncg_r4c.yaml",
                "robust_r3.yaml", "robust_r3b.yaml", "robust_r3c.yaml", "robust_r3d.yaml",
                "robust_r3e.yaml", "robust_r4.yaml"]


@pytest.mark.parametrize("name", ROBUST_YAMLS)
def test_robust_yaml_copy_builds_as_in_jax(name):
    """The port's copy is the JAX package's file under one header line; it
    loads to the same tree, and ``build_env_params`` (the base env and every
    curriculum stage, each stage's ``dr_prob`` setting the mixture gate),
    ``build_sac_config`` and ``build_loop_config`` build it as JAX does,
    field by field."""
    port_path = ROOT / "tvc_ai_torch" / "config" / name
    ref_path = ROOT / "tvc_ai_tpu" / "config" / name
    header, body = port_path.read_text().split("\n", 1)
    assert header == f"# The port's copy of tvc_ai_tpu/config/{name}, unchanged below this line."
    assert body == ref_path.read_text()
    port, ref = t_loader.load_config(port_path), j_loader.load_config(ref_path)
    assert port.to_dict() == ref.to_dict()
    built = [t_build.build_env_params(port)]
    assert_params_equal(built[0], _jax_params(ref))
    for t_stage, j_stage in zip(port.curriculum.stages, ref.curriculum.stages):
        built.append(t_build.build_env_params(port, t_stage))
        assert_params_equal(built[-1], _jax_params(ref, j_stage))
        dr_prob = port.env.domain_randomization.dr_prob if t_stage.dr_prob is None else t_stage.dr_prob
        assert built[-1].randomization.dr_mixture_enabled == (dr_prob < 1.0)
    rnd = built[0].randomization
    # every file turns on an option this slice ports
    assert (rnd.feasible_only or rnd.dr_mixture_enabled or rnd.sensor_dropout_enabled
            or rnd.actuator_delay or built[0].reward.survival_normalized_success
            or built[0].reward.equilibrium_relative_shaping)
    t_sac, j_sac = t_build.build_sac_config(port), j_build.build_sac_config(ref)
    for f in dataclasses.fields(SACConfig):
        assert getattr(t_sac, f.name) == getattr(j_sac, f.name), f.name
    assert_loop_configs_equal(t_build.build_loop_config(port), j_build.build_loop_config(ref))
