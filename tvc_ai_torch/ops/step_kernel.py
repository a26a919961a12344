"""K1: the integrate + contact control step as a CUDA kernel (build, bind, wrap).

Replaces ``tvc_ai_tpu/ops/pallas_step.py::_kernel``. The source is
``tvc_ai_torch/csrc/step_kernel.cu`` (its header note gives the design and
the bound); it is compiled at first use with ``nvcc`` for ``sm_90a`` into
``tvc_ai_torch/build/`` (ignored by git), under a name keyed on the source's
hash, and loaded with ``ctypes``.

``step_kernel`` is a drop-in for ``physics.integrator.step``: CPU tensors go to
that plain version, CUDA tensors launch the kernel or raise.
``step_kernel.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tvc_ai_torch.physics import integrator
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "step_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

def flops_per_env(substeps: int) -> int:
    """Arithmetic of one env's step as the kernel writes it (see the .cu note)."""
    return 143 + 298 * substeps


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in the CUDA toolkit's default place")


def build() -> tuple[Path, str]:
    """Compile the kernel if its source changed; returns (library, compiler log)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libtvc_step_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    tmp.replace(lib)
    return lib, proc.stderr


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.tvc_step_kernel
    fn.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_float] * 19
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def step_kernel(
    state: RigidBodyState,
    control: ThrustControl,
    params: RocketParams,
    mass: torch.Tensor,
    thrust_scale: torch.Tensor,
    cg_offset: torch.Tensor,
    wind: torch.Tensor,
) -> RigidBodyState:
    """One control step for N envs; the batched ``integrator.step``.

    Parity physics only: the opt-in terms (Magnus, ground effect, gyroscopic)
    raise ``ValueError`` — route those batches to ``integrator.step``.
    """
    if params.magnus_effect or params.ground_effect or params.gyroscopic:
        raise ValueError(
            "step_kernel implements parity physics only; an opt-in term "
            "(magnus/ground-effect/gyroscopic) is on"
        )
    n = state.pos.shape[0]
    dev = state.pos.device
    f32 = torch.float32
    for name, t, shape, dtype in (
        ("pos", state.pos, (n, 3), f32),
        ("quat", state.quat, (n, 4), f32),
        ("vel", state.vel, (n, 3), f32),
        ("omega", state.omega, (n, 3), f32),
        ("gimbal", control.gimbal, (n, 2), f32),
        ("thrust_active", control.thrust_active, (n,), torch.bool),
        ("mass", mass, (n,), f32),
        ("thrust_scale", thrust_scale, (n,), f32),
        ("cg_offset", cg_offset, (n, 3), f32),
        ("wind", wind, (n, 3), f32),
    ):
        _check(name, t, shape, dtype, dev)
    if dev.type == "cpu":
        return integrator.step(state, control, params, mass, thrust_scale, cg_offset, wind)
    if dev.type != "cuda":
        raise ValueError(f"step_kernel: unsupported device {dev}")

    out = RigidBodyState(
        pos=torch.empty_like(state.pos),
        quat=torch.empty_like(state.quat),
        vel=torch.empty_like(state.vel),
        omega=torch.empty_like(state.omega),
    )
    lib = _load()
    ox, oy, oz = params.thrust_offset
    with torch.cuda.device(dev):
        err = lib.tvc_step_kernel(
            state.pos.data_ptr(), state.quat.data_ptr(), state.vel.data_ptr(),
            state.omega.data_ptr(), control.gimbal.data_ptr(),
            control.thrust_active.data_ptr(), mass.data_ptr(),
            thrust_scale.data_ptr(), cg_offset.data_ptr(), wind.data_ptr(),
            out.pos.data_ptr(), out.quat.data_ptr(), out.vel.data_ptr(),
            out.omega.data_ptr(),
            params.thrust, params.gravity, 1.0 if params.double_gravity else 0.0,
            params.drag_coeff, params.rho0, params.atmosphere_scale_height,
            params.aero_angular_damping, params.drag_min_speed,
            params.linear_damping, params.angular_damping, params.dt,
            params.contact_stiffness, params.contact_damping,
            params.contact_friction, params.radius, params.length, ox, oy, oz,
            params.substeps, n, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"step_kernel launch failed: cudaError {err}")
    step_kernel.launches += 1
    return out


step_kernel.launches = 0
