"""Quantize the actor to the native ``.tvcq`` format, and drive the native
int8 runtime through ctypes.

Counterpart of ``tvc_ai_tpu/export/micro.py``: per-tensor symmetric int8
weights, activation ranges calibrated from representative observations,
serialized to the ``.tvcq`` container that ``native/tvc_micro.cpp`` (and MCU
firmware) reads. After ``actor_dense_stack`` everything is numpy, so the
same float weights and calibration rows give the same bytes as the
reference (``np.round`` rounds half to even).

``build_runtime`` compiles ``native/tvc_micro.cpp`` as it is (the format's
one definition) with g++ into ``tvc_ai_torch/build/``, under a name keyed on
the source's and flags' hash, through a temporary file and a rename; it
never writes beside the source. ``MicroActor`` loads that library and runs
one observation at a time, as the MCU does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

from tvc_ai_torch.export.tflite import actor_dense_stack
from tvc_ai_torch.models.mlp import GaussianActor

MAGIC = 0x54564351   # "TVCQ"
RUNTIME_SOURCE = Path(__file__).resolve().parents[2] / "native" / "tvc_micro.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def _activation_ranges(
    stack: list[tuple[np.ndarray, np.ndarray]], calib_obs: np.ndarray
) -> list[tuple[float, float]]:
    """(min, max) of the input and of each hidden layer's float activations
    over the calibration rows."""
    ranges = [(float(calib_obs.min()), float(calib_obs.max()))]
    x = calib_obs
    for kernel, bias in stack[:-1]:
        x = np.maximum(x @ kernel + bias, 0.0)
        ranges.append((float(x.min()), float(x.max())))
    return ranges


def _affine_params(lo: float, hi: float) -> tuple[float, int]:
    """int8 affine quantization (scale, zero point) covering [lo, hi] ∪ {0}."""
    lo, hi = min(lo, 0.0), max(hi, 1e-6)
    scale = (hi - lo) / 255.0
    zero = int(round(-128 - lo / scale))
    return scale, max(-128, min(127, zero))


def quantize_actor(actor: GaussianActor, calib_obs: np.ndarray) -> bytes:
    """The actor's deterministic path as ``.tvcq`` bytes."""
    stack = actor_dense_stack(actor)
    ranges = _activation_ranges(stack, calib_obs.astype(np.float32))

    out = bytearray()
    out += struct.pack("<III", MAGIC, 1, len(stack))
    in_scale, in_zero = _affine_params(*ranges[0])
    out += struct.pack("<fi", in_scale, in_zero)

    cur_scale = in_scale
    for li, (kernel, bias) in enumerate(stack):
        rows, cols = kernel.shape
        w_scale = float(np.abs(kernel).max()) / 127.0 or 1e-8
        w_q = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
        # the bias on the int32 accumulator's grid: real = acc · w_scale · in_scale
        bias_q = np.round(bias / (w_scale * cur_scale)).astype(np.int64)
        bias_q = np.clip(bias_q, -(2**31) + 1, 2**31 - 1).astype(np.int32)
        if li == len(stack) - 1:
            o_scale, o_zero = 1.0, 0   # the last layer dequantizes to float
        else:
            o_scale, o_zero = _affine_params(*ranges[li + 1])
        out += struct.pack("<IIf", rows, cols, w_scale)
        out += bias_q.tobytes()
        out += w_q.tobytes()
        out += struct.pack("<fi", o_scale, o_zero)
        cur_scale = o_scale
    return bytes(out)


def runtime_path() -> Path:
    """Where ``build_runtime`` puts the library for this source and these flags."""
    digest = hashlib.sha256(RUNTIME_SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtvc_micro_{digest.hexdigest()[:16]}.so"


def build_runtime() -> Path:
    """Compile the native runtime with g++ unless this source's build exists;
    raises ``RuntimeError`` with g++'s output when the build fails."""
    lib = runtime_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(RUNTIME_SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    tmp.replace(lib)
    return lib


class MicroActor:
    """ctypes binding of the native int8 runtime, one observation at a time."""

    def __init__(self, model_bytes: bytes, lib_path: Path | None = None):
        self._handle = None
        lib = ctypes.CDLL(str(lib_path or build_runtime()))
        lib.tvc_micro_load.restype = ctypes.c_void_p
        lib.tvc_micro_load.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.tvc_micro_infer.restype = ctypes.c_int
        lib.tvc_micro_infer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.tvc_micro_input_dim.restype = ctypes.c_uint32
        lib.tvc_micro_input_dim.argtypes = [ctypes.c_void_p]
        lib.tvc_micro_output_dim.restype = ctypes.c_uint32
        lib.tvc_micro_output_dim.argtypes = [ctypes.c_void_p]
        lib.tvc_micro_free.restype = None
        lib.tvc_micro_free.argtypes = [ctypes.c_void_p]
        self._lib = lib

        buf = (ctypes.c_uint8 * len(model_bytes)).from_buffer_copy(model_bytes)
        self._handle = lib.tvc_micro_load(buf, len(model_bytes))
        if not self._handle:
            raise ValueError("tvc_micro_load rejected the model bytes")
        self.input_dim = int(lib.tvc_micro_input_dim(self._handle))
        self.output_dim = int(lib.tvc_micro_output_dim(self._handle))

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        single = obs.ndim == 1
        if single:
            obs = obs[None]
        if obs.shape[-1] != self.input_dim:
            raise ValueError(f"observations are {obs.shape[-1]} wide, the model takes "
                             f"{self.input_dim}")
        out = np.empty((obs.shape[0], self.output_dim), np.float32)
        res = np.empty(self.output_dim, np.float32)
        for i, row in enumerate(obs):
            row = np.ascontiguousarray(row, np.float32)
            rc = self._lib.tvc_micro_infer(
                self._handle,
                row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                res.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if rc != 0:
                raise RuntimeError(f"tvc_micro_infer failed: {rc}")
            out[i] = res
        return out[0] if single else out

    def close(self) -> None:
        if self._handle:
            self._lib.tvc_micro_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def export_micro(actor: GaussianActor, calib_obs: np.ndarray, output_dir: str | Path,
                 name: str = "tvc_actor") -> Path:
    """Write ``{name}.tvcq`` into ``output_dir``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / f"{name}.tvcq"
    path.write_bytes(quantize_actor(actor, calib_obs))
    return path
