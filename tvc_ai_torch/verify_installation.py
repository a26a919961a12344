"""Installation check of the PyTorch/CUDA port.

    python -m tvc_ai_torch.verify_installation [--device cuda|cpu | --cpu]

The counterpart of ``verify_installation.py``, with its line format: one
``[ok  ]`` or ``[FAIL]`` line per required check and ``[opt ]`` for what is
optional or not checked, then ``FAILED checks: [...]`` and exit code 1, or
``All required checks passed.`` and exit code 0.

Required: Python >= 3.10; the port's core dependencies (``torch``, ``numpy``,
``yaml``); the torch device (CUDA unless ``--cpu`` is given: a host without
a CUDA device fails, it does not fall back to the CPU); K1 built from
``csrc/step_kernel.cu`` and launched on a seeded batch in flight, held
against the plain integrator at 2e-5 abs / 2e-4 rel (under ``--cpu`` the
line is ``[opt ]``: it needs the card); one env step through
``rocket_env.batched_step`` with a finite reward; and, where gymnasium
imports, ``gym.make`` of the port's namespaced id. Gymnasium is optional
here: the port's core runs without it.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

import torch

from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.ops import step_kernel as k1
from tvc_ai_torch.physics import integrator
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

CORE_DEPENDENCIES = ("torch", "numpy", "yaml")
OPTIONAL_FEATURES = (
    ("tensorflow", "int8 TFLite export"),
    ("tensorboardX", "TensorBoard logging"),
    ("optuna", "Optuna HPO (falls back to built-in search)"),
    ("matplotlib", "plots"),
    ("psutil", "host telemetry"),
    ("gymnasium", "Gymnasium envs"),
)
K1_ENVS = 64
K1_TOL = dict(atol=2e-5, rtol=2e-4)   # the flight bar, as tests/test_pallas_step.py


class Report:
    """The checks made so far and their printed lines."""

    def __init__(self):
        self.results: list[tuple[str, bool, str]] = []

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        self.results.append((name, ok, detail))
        _line("ok  " if ok else "FAIL", name, detail)

    def failures(self) -> list[str]:
        return [name for name, ok, _ in self.results if not ok]


def _line(mark: str, name: str, detail: str = "") -> None:
    print(f"[{mark}] {name}{': ' + detail if detail else ''}")


def k1_check(dev) -> str:
    """Build K1, launch it on a seeded batch of ``K1_ENVS`` envs clear of the
    ground and hold it against the plain integrator; returns the detail."""
    lib, _ = k1.build()
    gen = torch.Generator(device=dev).manual_seed(0)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    n = K1_ENVS
    quat = torch.randn((n, 4), generator=gen, device=dev)
    pos = u(n, 3, lo=-2.0, hi=2.0)
    pos[:, 2] = u(n, lo=1.0, hi=10.0)   # both ends (0.5 m out) stay clear of the ground
    state = RigidBodyState(pos=pos, quat=quat / torch.linalg.vector_norm(quat, dim=-1,
                                                                          keepdim=True),
                           vel=2.0 * torch.randn((n, 3), generator=gen, device=dev),
                           omega=torch.randn((n, 3), generator=gen, device=dev))
    ctrl = ThrustControl(u(n, 2, lo=-0.3, hi=0.3), u(n, lo=0.0, hi=1.0) > 0.3)
    dr = (u(n, lo=1.5, hi=2.5), u(n, lo=0.8, hi=1.2),
          0.02 * torch.randn((n, 3), generator=gen, device=dev),
          torch.randn((n, 3), generator=gen, device=dev))
    params = RocketParams()
    out = k1.step_kernel(state, ctrl, params, *dr)
    ref = integrator.step(state, ctrl, params, *dr)
    err = 0.0
    for field in ("pos", "quat", "vel", "omega"):
        got, want = getattr(out, field), getattr(ref, field)
        torch.testing.assert_close(got, want, **K1_TOL, msg=lambda m, f=field: f"{f}: {m}")
        err = max(err, float((got - want).abs().max()))
    source = k1.SOURCE.relative_to(k1.SOURCE.parent.parent).as_posix()
    return (f"built {lib.name} from {source}; N={n} max |K1 - plain| {err:.3e} "
            f"(atol {K1_TOL['atol']}, rtol {K1_TOL['rtol']})")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Installation check (PyTorch/CUDA port)")
    add_device_flags(parser)
    device = device_from_flags(parser, parser.parse_args(argv))
    report = Report()

    # --- python version
    v = sys.version_info
    report.check("python >= 3.10", (v.major, v.minor) >= (3, 10),
                 f"{v.major}.{v.minor}.{v.micro}")

    # --- core deps
    for mod in CORE_DEPENDENCIES:
        if importlib.util.find_spec(mod) is None:
            report.check(mod, False, "not installed")
            continue
        try:
            imported = __import__(mod)
            report.check(mod, True, getattr(imported, "__version__", "?"))
        except Exception as exc:  # a broken install: report it, keep checking
            report.check(mod, False, str(exc))

    # --- torch device + K1 build and launch (each later check raises again
    # where the device is missing, so each reports it)
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            detail = (f"{dev} {torch.cuda.get_device_name(dev)} "
                      f"({torch.cuda.device_count()} CUDA device(s))")
        else:
            detail = f"{dev} (asked for; torch.cuda.is_available() {torch.cuda.is_available()})"
        report.check("torch device", True, detail)
    except RuntimeError as exc:
        report.check("torch device", False, str(exc))
    if torch.device(device).type == "cpu":
        _line("opt ", "K1 build + launch", "needs the card")
    else:
        try:
            report.check("K1 build + launch", True, k1_check(resolve_device(device)))
        except Exception as exc:  # nvcc's or CUDA's message is the detail
            report.check("K1 build + launch", False, str(exc))

    # --- env smoke test: one step through K1 (its plain version on the CPU)
    try:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
        state, _ = rocket_env.reset(EnvParams(), 1, device, generator=gen)
        _, out = rocket_env.batched_step(state, torch.zeros((1, 2), device=gen.device),
                                         EnvParams(), generator=gen)
        report.check("rocket env step", bool(torch.isfinite(out.reward).all()),
                     f"reward={float(out.reward[0]):.2f}")
    except Exception as exc:
        report.check("rocket env", False, str(exc))

    # --- gymnasium registration, where gymnasium imports
    if importlib.util.find_spec("gymnasium") is None:
        _line("opt ", "gymnasium registration", "gymnasium absent")
    else:
        try:
            import gymnasium as gym

            from tvc_ai_torch.env.registration import register_envs

            register_envs()
            env = gym.make("tvc_ai_torch/EnhancedRocketTVC-v0", device=device)
            env.reset()
            env.close()
            report.check("gymnasium registration", True)
        except Exception as exc:
            report.check("gymnasium registration", False, str(exc))

    # --- optional features
    for mod, feature in OPTIONAL_FEATURES:
        present = importlib.util.find_spec(mod) is not None
        print(f"[{'ok  ' if present else 'opt '}] optional: {feature} "
              f"({'available' if present else 'absent'})")
    return _finish(report)


def _finish(report: Report) -> int:
    failures = report.failures()
    print()
    if failures:
        print(f"FAILED checks: {failures}")
        return 1
    print("All required checks passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
