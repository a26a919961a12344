"""The native int8 export (``.tvcq`` + ``native/tvc_micro.cpp`` through
ctypes) of tvc_ai_torch against the JAX package (CPU).

A flax ``GaussianActor`` at unequal widths (obs 8 → 32 → 16 → 2, so a
kernel that is not transposed fails on shape) is carried across with
``convert.actor_from_flax``. Given the same weights and calibration rows the
port's ``.tvcq`` bytes equal the reference's byte for byte, and the port's
runtime (built with g++ into ``tvc_ai_torch/build/``) gives exactly the
outputs of the reference's committed library on the same bytes. The port
never writes into ``native/``.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree
from tvc_ai_torch.convert import actor_from_flax
from tvc_ai_torch.export import micro as t_micro
from tvc_ai_torch.export import tflite as t_tflite
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_tpu.export import micro as j_micro
from tvc_ai_tpu.export import tflite as j_tflite
from tvc_ai_tpu.models import mlp as j_mlp

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "native"
OBS, ACT = 8, 2

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


def native_fingerprint() -> dict[str, tuple[int, int, str]]:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(NATIVE.iterdir())}


def flax_actor(hidden: tuple[int, ...], seed: int):
    params = j_mlp.GaussianActor(ACT, hidden).init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    port = GaussianActor(OBS, ACT, hidden, device="cpu")
    port.load_state_dict(actor_from_flax(np_tree(params)))
    return params, port


@pytest.fixture(scope="module")
def calib() -> np.ndarray:
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((256, OBS)).astype(np.float32)
    obs[:, :4] /= np.linalg.norm(obs[:, :4], axis=1, keepdims=True)
    obs[:, 7] = rng.uniform(0, 1, 256)
    return obs


@pytest.mark.parametrize("hidden,seed", [((32, 16), 0), ((24,), 1), ((16, 40, 8), 2)])
def test_tvcq_bytes_equal_the_reference(hidden, seed, calib):
    params, port = flax_actor(hidden, seed)
    want = j_tflite.actor_dense_stack(params)
    got = t_tflite.actor_dense_stack(port)
    assert [k.shape for k, _ in got] == [np.asarray(k).shape for k, _ in want]
    for (gk, gb), (wk, wb) in zip(got, want):
        assert gk.dtype == np.float32 and gk.flags.c_contiguous
        np.testing.assert_array_equal(gk, np.asarray(wk))
        np.testing.assert_array_equal(gb, np.asarray(wb))
    assert t_micro.quantize_actor(port, calib) == j_micro.quantize_actor(params, calib)


def test_micro_actor_outputs_equal_the_reference_runtime(calib):
    params, port = flax_actor((32, 16), 0)
    model = t_micro.quantize_actor(port, calib)
    got = t_micro.MicroActor(model)
    # the reference's own library, loaded where it lies (nothing is built)
    want = j_micro.MicroActor(model, lib_path=NATIVE / "libtvc_micro.so")
    assert (got.input_dim, got.output_dim) == (OBS, ACT)
    np.testing.assert_array_equal(got(calib), want(calib))
    np.testing.assert_array_equal(got(calib[3]), want(calib[3]))
    ref = t_tflite.float_actor_fn(port)(calib[:64])
    with torch.no_grad():
        mean, _ = port(torch.from_numpy(calib[:64]))
    np.testing.assert_allclose(ref, torch.tanh(mean).numpy(), atol=1e-6)
    diff = np.abs(got(calib[:64]) - ref)
    assert diff.max() <= 0.1 and diff.mean() <= 0.03, (diff.max(), diff.mean())


def test_runtime_rejects_garbage_and_wrong_widths(calib):
    with pytest.raises(ValueError, match="rejected"):
        t_micro.MicroActor(b"not a model")
    _, port = flax_actor((24,), 1)
    actor = t_micro.MicroActor(t_micro.quantize_actor(port, calib))
    with pytest.raises(ValueError, match="wide"):
        actor(np.zeros((2, OBS + 2), np.float32))


def test_runtime_builds_into_the_port_and_leaves_native_untouched(tmp_path, monkeypatch):
    before = native_fingerprint()
    lib = t_micro.build_runtime()
    assert lib == t_micro.runtime_path() and lib.exists()
    assert lib.parent == ROOT / "tvc_ai_torch" / "build" and lib.name.startswith("libtvc_micro_")
    assert t_micro.build_runtime() == lib   # cached
    # a fresh build into another directory, then a source g++ refuses
    monkeypatch.setattr(t_micro, "BUILD_DIR", tmp_path / "build")
    fresh = t_micro.build_runtime()
    assert fresh.parent == tmp_path / "build" and fresh.name == lib.name
    assert [p.name for p in fresh.parent.iterdir()] == [lib.name]   # no temporary left
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(t_micro, "RUNTIME_SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_micro.build_runtime()
    assert native_fingerprint() == before


def test_export_micro_writes_the_artifact(calib, tmp_path):
    _, port = flax_actor((32, 16), 0)
    path = t_micro.export_micro(port, calib, tmp_path)
    assert path == tmp_path / "tvc_actor.tvcq"
    assert path.read_bytes() == t_micro.quantize_actor(port, calib)
    assert path.stat().st_size < 1024 * 1024   # the MCU's flash budget
    out = t_micro.MicroActor(path.read_bytes())(calib[0])
    assert out.shape == (ACT,) and np.all(np.abs(out) <= 1.0)
