"""The TFLite int8 export, the C artifacts and the ``export`` command line of
tvc_ai_torch against the JAX package (CPU; TensorFlow is imported here).

A flax ``GaussianActor`` at unequal widths (obs 8 → 32 → 16 → 2) is carried
across with ``convert.actor_from_flax``. Bars:

- the Keras mirror of the port's actor against the port's deterministic
  actor: 1e-4;
- the int8 actions of the port's TFLite model against the JAX package's on
  the same calibration rows and observations: exactly equal (TFLite's
  converter does not give the same bytes twice, so bytes are not compared);
- the calibration rollout, its draws replayed from the reference's keys
  (the reset's, the actions' and each env step's): the obs bar, 5e-5 /
  5e-4;
- the C array, its header and the TFLM example: the reference's text.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, np_tree, record_env_keys, to_torch
from tvc_ai_torch.agents.legacy import SACAgent
from tvc_ai_torch.agents.sac import SACConfig
from tvc_ai_torch.convert import actor_from_flax, env_params_from_numpy
from tvc_ai_torch.export import c_array as t_c_array
from tvc_ai_torch.export import tflite as t_tflite
from tvc_ai_torch.export.__main__ import main as export_main
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.utils.checkpoint import CheckpointManager
from tvc_ai_tpu.env.wrappers import RocketConfig
from tvc_ai_tpu.export import c_array as j_c_array
from tvc_ai_tpu.export import tflite as j_tflite
from tvc_ai_tpu.models import mlp as j_mlp

pytest.importorskip("tensorflow")
torch.set_num_threads(1)
OBS, ACT, HIDDEN = 8, 2, (32, 16)
OBS_BAR = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(scope="module")
def actors():
    params = j_mlp.GaussianActor(ACT, HIDDEN).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    port = GaussianActor(OBS, ACT, HIDDEN, device="cpu")
    port.load_state_dict(actor_from_flax(np_tree(params)))
    return params, port


@pytest.fixture(scope="module")
def export_params():
    return RocketConfig().to_env_params(domain_randomization=False, sensor_noise=False,
                                        max_episode_steps=1000)


@pytest.fixture(scope="module")
def calib(export_params):
    return np.asarray(j_tflite.collect_representative_obs(None, export_params, 100, OBS))


def test_keras_mirror_matches_the_port_actor(actors):
    _, port = actors
    model = t_tflite.build_keras_actor(port, OBS)
    obs = np.random.default_rng(0).standard_normal((16, OBS)).astype(np.float32)
    with torch.no_grad():
        want = torch.tanh(port(torch.from_numpy(obs))[0]).numpy()
    np.testing.assert_allclose(model.predict(obs, verbose=0), want, atol=1e-4)
    np.testing.assert_allclose(t_tflite.float_actor_fn(port)(obs), want, atol=1e-6)


@pytest.mark.parametrize("optimization", ["default", "none"])
def test_int8_actions_equal_the_reference_model(actors, calib, optimization):
    params, port = actors
    got = t_tflite.TFLiteActor(
        t_tflite.convert_int8(t_tflite.build_keras_actor(port, OBS), calib, optimization))
    want = j_tflite.TFLiteActor(
        j_tflite.convert_int8(j_tflite.build_keras_actor(params, OBS), calib, optimization))
    obs = np.concatenate([calib, np.random.default_rng(1).standard_normal((32, OBS))
                          .astype(np.float32)])
    np.testing.assert_array_equal(got(obs), want(obs))
    max_diff, mean_diff = t_tflite.validate_actions(got, t_tflite.float_actor_fn(port), calib)
    assert max_diff <= 0.1 and mean_diff <= max_diff
    assert t_tflite.benchmark_latency(got, calib, n=8) > 0


@pytest.mark.parametrize("num_samples,obs_dim", [(100, 10), (200, OBS)])
def test_calibration_rollout_replays_the_reference(export_params, num_samples, obs_dim):
    seed = 3
    want, env_keys = record_env_keys(
        lambda: np.asarray(j_tflite.collect_representative_obs(
            None, export_params, num_samples, obs_dim, seed)), min(num_samples, 64))
    n, steps = t_tflite.calibration_shape(num_samples)
    assert env_keys.shape[:2] == (steps, n)
    chain = KeyChain(export_params)
    key = jax.random.PRNGKey(seed)
    actions = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        actions.append(to_torch(jax.random.uniform(k, (n, ACT), minval=-1.0, maxval=1.0)))
    draws = t_tflite.CalibrationDraws(
        reset=chain.reset(jax.random.split(jax.random.PRNGKey(seed), n)), actions=actions,
        steps=[chain.step(env_keys[t]) for t in range(steps)])
    got = t_tflite.collect_representative_obs(None, env_params_from_numpy(export_params),
                                              num_samples, obs_dim, device="cpu", draws=draws)
    assert got.shape == want.shape == (max(num_samples, n), obs_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **OBS_BAR)
    with pytest.raises(ValueError, match="steps"):
        t_tflite.collect_representative_obs(None, env_params_from_numpy(export_params),
                                            num_samples, obs_dim, device="cpu",
                                            draws=t_tflite.CalibrationDraws(draws.reset, [], []))


def test_c_artifacts_equal_the_reference_text(tmp_path):
    blob = bytes(np.random.default_rng(2).integers(0, 256, 77, dtype=np.uint8))
    for name in ("tvc_model", "tvc_actor"):
        got = t_c_array.generate_c_array(blob, tmp_path / "t", name)
        want = j_c_array.generate_c_array(blob, tmp_path / "j", name)
        assert [p.name for p in got] == [p.name for p in want]
        for g, w in zip(got, want):
            assert g.read_text() == w.read_text()
    got = t_c_array.generate_tflm_example(tmp_path / "t", obs_dim=10, action_dim=2)
    want = j_c_array.generate_tflm_example(tmp_path / "j", obs_dim=10, action_dim=2)
    assert got.read_text() == want.read_text()


def test_export_actor_pipeline(actors, export_params, tmp_path):
    _, port = actors
    result = t_tflite.export_actor(port, OBS, env_params_from_numpy(export_params), tmp_path,
                                   num_calibration_samples=64, device="cpu")
    assert result.tflite_path == tmp_path / "tvc_actor_default.tflite"
    assert result.size_bytes == result.tflite_path.stat().st_size < 1024 * 1024
    assert result.max_action_diff <= 0.1 and result.latency_us > 0


def _check_cli_output(out_dir, printed: str) -> None:
    assert f"tflite: {out_dir / 'tvc_actor_default.tflite'}" in printed
    line = next(l for l in printed.splitlines() if l.startswith("int8 parity: max |Δa| = "))
    assert float(line.split("= ")[1].split()[0]) <= 0.1
    assert "µs/inference" in printed and "WARNING" not in printed
    for name in ("tvc_model_data.cc", "tvc_model_data.h", "inference_example.cpp"):
        assert (out_dir / name).exists(), name


def test_cli_on_a_sacagent_file(tmp_path, capsys):
    agent = SACAgent(10, 2, SACConfig((16, 16), buffer_size=64), seed=4, device="cpu")
    agent.save(tmp_path / "agent.pt")
    out = tmp_path / "export"
    assert export_main(["--model_path", str(tmp_path / "agent.pt"), "--output_dir", str(out),
                        "--obs_dim", "10", "--hidden", "16", "16", "--generate_c_array",
                        "--cpu"]) == 0
    _check_cli_output(out, capsys.readouterr().out)


def test_cli_on_a_checkpoint_dir(tmp_path, capsys):
    cfg = SACConfig((16, 16), buffer_size=64)
    carry = t_loop.init_carry(env_params_from_numpy(RocketConfig().to_env_params(
        domain_randomization=False, sensor_noise=False, max_episode_steps=100)), cfg,
        t_loop.TrainLoopConfig(num_envs=4, rollout_steps=1), device="cpu", seed=2)
    CheckpointManager(tmp_path / "checkpoints").save(16, {"carry": carry})
    out = tmp_path / "export"
    assert export_main(["--model_path", str(tmp_path / "checkpoints"), "--output_dir", str(out),
                        "--obs_dim", "10", "--hidden", "16", "16", "--generate_c_array",
                        "--cpu"]) == 0
    _check_cli_output(out, capsys.readouterr().out)


def test_without_tensorflow_the_export_raises(tmp_path, monkeypatch):
    """As on a host without TensorFlow: ``ExportError``, no fallback."""
    agent = SACAgent(10, 2, SACConfig((16, 16), buffer_size=64), device="cpu")
    agent.save(tmp_path / "agent.pt")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(t_tflite.ExportError, match="TensorFlow is required"):
        export_main(["--model_path", str(tmp_path / "agent.pt"), "--obs_dim", "10",
                     "--hidden", "16", "16", "--output_dir", str(tmp_path / "x"), "--cpu"])
    assert not (tmp_path / "x" / "tvc_actor_default.tflite").exists()
