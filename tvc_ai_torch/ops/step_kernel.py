"""K1: the integrate + contact control step as a CUDA kernel (build, bind, wrap).

Replaces ``tvc_ai_tpu/ops/pallas_step.py::_kernel``. The source is
``tvc_ai_torch/csrc/step_kernel.cu`` (its header note gives the design and
the bound); it is compiled at first use with ``nvcc`` for ``sm_90a`` into
``tvc_ai_torch/build/`` (ignored by git), under a name keyed on the source's
hash, and loaded with ``ctypes``.

``step_kernel`` is a drop-in for ``physics.integrator.step``: CPU tensors go to
that plain version, CUDA tensors launch the kernel or raise. Both routes check
the inputs first, 16-byte alignment included (the kernel stages 16-byte
chunks). ``step_kernel.launches`` counts the launches.

The launch path is built to be cheap and static: the scalars are packed once
per ``RocketParams`` value into a ``StepParams`` structure passed by value,
and the four outputs are views of one allocation. ``launch_floor`` and
``copy_floor`` launch an empty kernel on K1's grid and K1's I/O without its
arithmetic, the yardsticks ``chip_smoke.py`` times K1 against.
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
ALIGN = 16  # bytes; every tensor K1 reads or writes starts on this boundary
F32 = torch.float32
# the kernel's inputs in argument order: name, shape after the env axis, dtype
INPUTS = (
    ("pos", (3,), F32), ("quat", (4,), F32), ("vel", (3,), F32), ("omega", (3,), F32),
    ("gimbal", (2,), F32), ("thrust_active", (), torch.bool), ("mass", (), F32),
    ("thrust_scale", (), F32), ("cg_offset", (3,), F32), ("wind", (3,), F32),
)
OUTPUT_WIDTHS = (3, 4, 3, 3)  # pos, quat, vel, omega


def flops_per_env(substeps: int) -> int:
    """Arithmetic of one env's step as the algorithm counts it (see the .cu note)."""
    return 143 + 298 * substeps


class StepParams(ctypes.Structure):
    """Host mirror of ``StepParams`` in ``csrc/step_kernel.cu``: same fields, same order."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "thrust", "gravity", "double_g", "drag_coeff", "rho0", "scale_height",
        "aero_damp", "drag_min_speed", "lin_damp", "ang_damp", "dt",
        "contact_k", "contact_d", "contact_mu", "radius", "length",
        "off_x", "off_y", "off_z",
    )] + [("substeps", ctypes.c_int)]


@functools.lru_cache(maxsize=32)
def pack_params(params: RocketParams) -> StepParams:
    """K1's scalar parameters for ``params``, built once per value (callers
    must not modify the shared result)."""
    ox, oy, oz = params.thrust_offset
    return StepParams(
        params.thrust, params.gravity, 1.0 if params.double_gravity else 0.0,
        params.drag_coeff, params.rho0, params.atmosphere_scale_height,
        params.aero_angular_damping, params.drag_min_speed,
        params.linear_damping, params.angular_damping, params.dt,
        params.contact_stiffness, params.contact_damping, params.contact_friction,
        params.radius, params.length, ox, oy, oz, params.substeps,
    )


@functools.lru_cache(maxsize=8)
def _output_layout(n: int) -> tuple[int, tuple]:
    """(floats in all, ((shape, stride, offset) of each output)); each span
    is padded to a multiple of 4 floats so that the next starts 16-byte
    aligned."""
    views, offset = [], 0
    for k in OUTPUT_WIDTHS:
        views.append(((n, k), (k, 1), offset))
        offset += -(-k * n // 4) * 4
    return offset, tuple(views)


def alloc_outputs(n: int, device: torch.device) -> RigidBodyState:
    """pos, quat, vel, omega for n envs as contiguous, 16-byte-aligned views
    of one allocation."""
    total, views = _output_layout(n)
    buf = torch.empty(total, dtype=F32, device=device)
    return RigidBodyState(*(buf.as_strided(*view) for view in views))


@functools.lru_cache(maxsize=8)
def _input_shapes(n: int) -> tuple:
    return tuple(torch.Size((n, *tail)) for _, tail, _ in INPUTS)


def check_inputs(state: RigidBodyState, control: ThrustControl, mass: torch.Tensor,
                 thrust_scale: torch.Tensor, cg_offset: torch.Tensor,
                 wind: torch.Tensor) -> list[int]:
    """Check K1's inputs in one pass (dtype, shape, device, contiguity,
    alignment); returns their data pointers in ``INPUTS`` order."""
    n, index = state.pos.shape[0], state.pos.get_device()  # -1 on the CPU
    tensors = (state.pos, state.quat, state.vel, state.omega, *control,
               mass, thrust_scale, cg_offset, wind)
    ptrs = []
    for (name, _, dtype), shape, t in zip(INPUTS, _input_shapes(n), tensors, strict=True):
        if t.dtype is not dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.get_device() != index:
            raise ValueError(f"{name}: on {t.device}, want {state.pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        ptr = t.data_ptr()
        if ptr % ALIGN:
            raise ValueError(f"{name}: data at {ptr:#x} is not {ALIGN}-byte aligned")
        ptrs.append(ptr)
    return ptrs


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


_POINTERS = [ctypes.c_void_p] * (len(INPUTS) + len(OUTPUT_WIDTHS))
# the C entry points of csrc/step_kernel.cu and their argument types
ENTRY_ARGTYPES = {
    "tvc_step_kernel": _POINTERS + [StepParams, ctypes.c_int, ctypes.c_void_p],
    "tvc_step_copy": _POINTERS + [ctypes.c_int, ctypes.c_void_p],
    "tvc_step_empty": [ctypes.c_int, ctypes.c_void_p],
    "tvc_step_attributes": [ctypes.c_void_p],
}


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in ENTRY_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _on_stream(fn, device: torch.device, *args) -> None:
    """Call a launcher with ``device``'s current stream; raise on a CUDA error.

    The stream is read as a raw handle (``_cuda_getCurrentRawStream``, as
    PyTorch's own generated kernels do): ``torch.cuda.current_stream()``
    builds a ``Stream`` object on every call, a host cost K1 pays per step.
    """
    if device.type != "cuda":
        raise ValueError(f"step_kernel: unsupported device {device}")
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def _launch(fn, ptrs: list[int], n: int, device: torch.device, *params) -> RigidBodyState:
    """Allocate the outputs and launch ``fn`` from the checked inputs to them."""
    out = alloc_outputs(n, device)
    _on_stream(fn, device, *ptrs, out.pos.data_ptr(), out.quat.data_ptr(),
               out.vel.data_ptr(), out.omega.data_ptr(), *params, n)
    return out


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
    ptrs = check_inputs(state, control, mass, thrust_scale, cg_offset, wind)
    n, dev = state.pos.shape[0], state.pos.device
    if dev.type == "cpu":
        return integrator.step(state, control, params, mass, thrust_scale, cg_offset, wind)
    out = _launch(_load().tvc_step_kernel, ptrs, n, dev, pack_params(params))
    step_kernel.launches += 1
    return out


step_kernel.launches = 0


def copy_floor(state, control, mass, thrust_scale, cg_offset, wind) -> RigidBodyState:
    """K1's memory floor: its staged loads and stores without its arithmetic
    (returns the state, copied). Not counted in ``step_kernel.launches``."""
    ptrs = check_inputs(state, control, mass, thrust_scale, cg_offset, wind)
    return _launch(_load().tvc_step_copy, ptrs, state.pos.shape[0], state.pos.device)


def launch_floor(n: int, device: torch.device) -> None:
    """K1's launch floor: an empty kernel on K1's grid for n envs."""
    _on_stream(_load().tvc_step_empty, device, n)


def kernel_attributes() -> dict:
    """K1's envs per block, registers per thread and local memory per thread
    (stack frame plus spills), as the CUDA runtime reports them."""
    vals = (ctypes.c_int * 3)()
    err = _load().tvc_step_attributes(vals)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return dict(block=vals[0], registers=vals[1], local_bytes=vals[2])
