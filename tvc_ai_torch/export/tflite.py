"""Actor → TFLite int8 export for microcontroller deployment.

Counterpart of ``tvc_ai_tpu/export/tflite.py``:

- ``actor_dense_stack``: the deterministic actor's layers as numpy
  (kernel (in, out), bias) pairs, hidden_0..hidden_{n-1} then ``mean_head``
  (``log_std_head`` is not exported);
- ``build_keras_actor``: the Keras mirror of the deterministic path (Dense +
  ReLU stack → mean head → tanh) with those weights;
- ``collect_representative_obs``: observations from a batched env rollout
  through ``batched_step_autoreset`` (K1 on the card), random actions
  unless a policy is given;
- ``convert_int8``: full-integer post-training quantization (int8 in and
  out) at the none / default / aggressive levels;
- ``TFLiteActor``, ``validate_actions``, ``benchmark_latency``: the int8
  model on the host, its action error against the float actor (the export
  budget is 0.1), its latency;
- ``export_actor``: the whole pipeline.

TensorFlow is imported only when a function needs it; without it they raise
``ExportError``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.randomization import draw_uniform
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import ACTION_DIM, OBS_DIM, EnvParams
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.training.loop import StepDraws
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

CALIBRATION_ENVS = 64   # the most envs the calibration rollout runs at once


class ExportError(RuntimeError):
    pass


def _require_tf():
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ExportError(
            "TensorFlow is required for TFLite export but is not available"
        ) from exc
    return tf


@dataclasses.dataclass
class ExportResult:
    tflite_path: Path
    size_bytes: int
    max_action_diff: float
    mean_action_diff: float
    latency_us: float
    optimization: str


def actor_dense_stack(actor: GaussianActor) -> list[tuple[np.ndarray, np.ndarray]]:
    """Ordered (kernel (in, out), bias) float32 numpy pairs on the host:
    hidden_0..hidden_{n-1}, then mean_head."""
    if not isinstance(actor, GaussianActor):
        raise TypeError(f"export takes a GaussianActor (an MLP actor), not {type(actor).__name__}")
    layers = [getattr(actor, f"hidden_{i}") for i in range(len(actor.hidden_dims))]
    layers.append(actor.mean_head)
    return [
        (np.ascontiguousarray(layer.weight.detach().cpu().numpy().T, dtype=np.float32),
         np.ascontiguousarray(layer.bias.detach().cpu().numpy(), dtype=np.float32))
        for layer in layers
    ]


def build_keras_actor(actor: GaussianActor, obs_dim: int):
    """Keras mirror of the deterministic actor: ReLU MLP → tanh(mean)."""
    tf = _require_tf()
    stack = actor_dense_stack(actor)
    inputs = tf.keras.Input(shape=(obs_dim,), dtype=tf.float32, name="obs")
    x = inputs
    for kernel, _ in stack[:-1]:
        x = tf.keras.layers.Dense(kernel.shape[1], activation="relu")(x)
    x = tf.keras.layers.Dense(stack[-1][0].shape[1])(x)
    outputs = tf.keras.layers.Activation("tanh", name="gimbal")(x)
    model = tf.keras.Model(inputs, outputs)
    dense_layers = [l for l in model.layers if isinstance(l, tf.keras.layers.Dense)]
    for layer, (kernel, bias) in zip(dense_layers, stack):
        layer.set_weights([kernel, bias])
    return model


@dataclasses.dataclass
class CalibrationDraws:
    """The random numbers of one calibration rollout of n envs: the first
    reset's, then per step the actions (n, action_dim) U[-1, 1) (unused
    with a policy) and the env step's draws (``StepDraws``; ``n_act`` unused)."""

    reset: ResetDraws
    actions: Sequence[torch.Tensor]
    steps: Sequence[StepDraws]


def calibration_shape(num_samples: int) -> tuple[int, int]:
    """(envs, steps) of the calibration rollout for ``num_samples`` rows."""
    n = min(num_samples, CALIBRATION_ENVS)
    return n, max(num_samples // n, 1)


def collect_representative_obs(
    policy_fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor] | None,
    env_params: EnvParams,
    num_samples: int = 100,
    obs_dim: int = OBS_DIM,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
    draws: CalibrationDraws | None = None,
) -> np.ndarray:
    """Observations from a batched env rollout (random actions if no policy):
    n = min(num_samples, 64) envs reset, then max(num_samples // n, 1) steps
    through ``batched_step_autoreset``; the first ``obs_dim`` channels of the
    reset's and each step's observations, cut to max(num_samples, n) rows,
    float32. The draws come from ``draws`` or a generator seeded with
    ``seed`` on ``device``."""
    dev = resolve_device(device)
    n, steps = calibration_shape(num_samples)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if draws is not None and (len(draws.actions) != steps or len(draws.steps) != steps):
        raise ValueError(f"draws hold {len(draws.actions)} / {len(draws.steps)} steps, "
                         f"want {steps}")
    states, obs = rocket_env.reset(env_params, n, dev, generator=gen,
                                   draws=None if draws is None else draws.reset)
    samples = [obs[..., :obs_dim]]
    for t in range(steps):
        if policy_fn is not None:
            actions = policy_fn(obs, gen)
        elif draws is not None:
            actions = draws.actions[t]
        else:
            actions = draw_uniform((n, ACTION_DIM), dev, gen)
        d = draws.steps[t] if draws is not None else StepDraws()
        states, _, obs = rocket_env.batched_step_autoreset(
            states, actions, env_params, generator=gen, n_imu=d.n_imu, reset_draws=d.reset,
            u_drop=d.u_drop)
        samples.append(obs[..., :obs_dim])
    data = torch.cat(samples)[: max(num_samples, n)]
    return data.cpu().numpy().astype(np.float32)


def convert_int8(keras_model, representative_obs: np.ndarray, optimization: str = "default"
                 ) -> bytes:
    """Full-int8 post-training quantization; ``"none"`` converts without it."""
    tf = _require_tf()
    converter = tf.lite.TFLiteConverter.from_keras_model(keras_model)
    if optimization == "none":
        return converter.convert()

    def rep_dataset():
        for row in representative_obs:
            yield [row[None, :]]

    converter.optimizations = [tf.lite.Optimize.DEFAULT]
    converter.representative_dataset = rep_dataset
    converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    converter.inference_input_type = tf.int8
    converter.inference_output_type = tf.int8
    if optimization == "aggressive":
        converter.target_spec.supported_types = [tf.int8]
    return converter.convert()


class TFLiteActor:
    """Host-side int8 interpreter (quantize in, dequantize out)."""

    def __init__(self, model_bytes: bytes):
        tf = _require_tf()
        self.interpreter = tf.lite.Interpreter(model_content=model_bytes)
        self.interpreter.allocate_tensors()
        self.inp = self.interpreter.get_input_details()[0]
        self.out = self.interpreter.get_output_details()[0]

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        single = obs.ndim == 1
        if single:
            obs = obs[None]
        actions = []
        for row in obs:
            x = row[None, :]
            if self.inp["dtype"] == np.int8:
                scale, zp = self.inp["quantization"]
                x = np.clip(np.round(x / scale + zp), -128, 127).astype(np.int8)
            self.interpreter.set_tensor(self.inp["index"], x)
            self.interpreter.invoke()
            y = self.interpreter.get_tensor(self.out["index"])
            if self.out["dtype"] == np.int8:
                scale, zp = self.out["quantization"]
                y = (y.astype(np.float32) - zp) * scale
            actions.append(y[0])
        result = np.stack(actions)
        return result[0] if single else result


def validate_actions(
    tflite_actor: Callable[[np.ndarray], np.ndarray],
    reference_fn: Callable[[np.ndarray], np.ndarray],
    obs_samples: np.ndarray,
) -> tuple[float, float]:
    """(max, mean) |Δaction| between the int8 and the float actor."""
    ref = np.asarray(reference_fn(obs_samples))
    diff = np.abs(ref - tflite_actor(obs_samples))
    return float(diff.max()), float(diff.mean())


def benchmark_latency(actor: Callable[[np.ndarray], np.ndarray], obs: np.ndarray, n: int = 200
                      ) -> float:
    """Mean single-inference host latency in µs."""
    actor(obs[0])  # warm-up
    t0 = time.perf_counter()
    for i in range(n):
        actor(obs[i % len(obs)])
    return (time.perf_counter() - t0) / n * 1e6


def float_actor_fn(actor: GaussianActor) -> Callable[[np.ndarray], np.ndarray]:
    """The deterministic actor in numpy float32: ReLU stack → tanh(mean)."""
    stack = actor_dense_stack(actor)

    def deterministic_fn(obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, np.float32)
        for kernel, bias in stack[:-1]:
            x = np.maximum(x @ kernel + bias, 0.0)
        kernel, bias = stack[-1]
        return np.tanh(x @ kernel + bias)

    return deterministic_fn


def export_actor(
    actor: GaussianActor,
    obs_dim: int,
    env_params: EnvParams,
    output_dir: str | Path,
    optimization: str = "default",
    num_calibration_samples: int = 100,
    deterministic_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ExportResult:
    """Keras mirror → calibration rollout on ``device`` → int8 → validation
    on the first 64 calibration rows → ``tvc_actor_{optimization}.tflite``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    keras_model = build_keras_actor(actor, obs_dim)
    if deterministic_fn is None:
        deterministic_fn = float_actor_fn(actor)
    rep = collect_representative_obs(None, env_params, num_calibration_samples, obs_dim,
                                     device=device)
    model_bytes = convert_int8(keras_model, rep, optimization)
    path = output_dir / f"tvc_actor_{optimization}.tflite"
    path.write_bytes(model_bytes)

    int8_actor = TFLiteActor(model_bytes)
    max_diff, mean_diff = validate_actions(int8_actor, deterministic_fn, rep[:64])
    return ExportResult(
        tflite_path=path,
        size_bytes=len(model_bytes),
        max_action_diff=max_diff,
        mean_action_diff=mean_diff,
        latency_us=benchmark_latency(int8_actor, rep),
        optimization=optimization,
    )
