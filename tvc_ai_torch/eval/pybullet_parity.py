"""PyBullet trajectory-parity harness (the physics-fidelity gate), packaged so
the gate can run anywhere.

Counterpart of ``tvc_ai_tpu/eval/pybullet_parity.py``, with the same
scenarios, scene constants and fixture format, so one fixture serves both
packages:

- on a machine WITH pybullet, ``record_goldens(path)`` simulates the
  reference scene (cylinder body, analytic inertia, the double-gravity
  quirk, thrust at the base, exponential-atmosphere drag, angular damping)
  for every scenario and writes a self-describing ``.npz`` fixture
  (``write_goldens``, which also writes a fixture from other trajectories);
- anywhere, ``check_goldens(path)`` replays the recorded actions through
  ``torch_trajectory`` (K1 at N = 1 on the card, its plain version on the
  CPU) and reports pass or fail against the recorded trajectories.

One command each way: ``python -m tvc_ai_torch.pybullet_goldens
record|check|both [--fixture PATH] [--cpu]``. Contact-phase parity is out of
scope: penalty contact and PyBullet's LCP solver differ by design.
"""

from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

FIXTURE_VERSION = 1
DEFAULT_FIXTURE = Path(__file__).resolve().parents[2] / (
    "tests/fixtures/pybullet_goldens.npz"
)

MASS, LENGTH, RADIUS = 2.0, 1.0, 0.05
THRUST = 35.0
MAX_GIMBAL_RAD = math.radians(18.0)
FUEL_PER_STEP = 0.001


@dataclass(frozen=True)
class Scenario:
    """A recorded free-flight parity scenario.

    ``pos_tol`` is the absolute position tolerance (m) over the whole
    trajectory; attitude uses the sign-invariant quaternion dot
    (> ``quat_dot_min``). Tolerances widen with control activity because the
    two integrators split the 0.02 s step differently (4 substeps vs
    semi-implicit sub-integration)."""

    name: str
    steps: int
    pos_tol: float
    quat_dot_min: float = 0.999

    def actions(self) -> np.ndarray:
        n = self.steps
        if self.name == "ballistic_thrust":
            return np.zeros((n, 2))
        if self.name == "constant_gimbal":
            return np.full((n, 2), 0.2)
        if self.name == "oscillating_gimbal":
            return 0.3 * np.sin(np.arange(n)[:, None] * [0.1, 0.17])
        if self.name == "step_gimbal":
            a = np.zeros((n, 2))
            a[n // 2 :] = [0.4, -0.3]
            return a
        if self.name == "spin_up":
            return np.stack(
                [0.25 * np.cos(0.3 * np.arange(n)), 0.25 * np.sin(0.3 * np.arange(n))],
                axis=1,
            )
        raise KeyError(self.name)


SCENARIOS: tuple[Scenario, ...] = (
    Scenario("ballistic_thrust", steps=50, pos_tol=0.05),
    Scenario("constant_gimbal", steps=40, pos_tol=0.08),
    Scenario("oscillating_gimbal", steps=40, pos_tol=0.10),
    Scenario("step_gimbal", steps=40, pos_tol=0.10),
    Scenario("spin_up", steps=40, pos_tol=0.10),
)

START_POS = (0.0, 0.0, 10.0)


def has_pybullet() -> bool:
    return importlib.util.find_spec("pybullet") is not None


def pybullet_trajectory(
    actions: np.ndarray, start_pos=START_POS
) -> np.ndarray:
    """The reference scene's PyBullet rollout → (T, 13) [pos, quat, vel, ω]."""
    import pybullet as p

    cid = p.connect(p.DIRECT)
    try:
        p.setGravity(0, 0, -9.81)
        p.setPhysicsEngineParameter(fixedTimeStep=0.02, numSubSteps=4)
        col = p.createCollisionShape(p.GEOM_CYLINDER, radius=RADIUS, height=LENGTH)
        body = p.createMultiBody(
            baseMass=MASS, baseCollisionShapeIndex=col, basePosition=start_pos
        )
        i_xx = (1 / 12) * MASS * (3 * RADIUS**2 + LENGTH**2)
        i_zz = 0.5 * MASS * RADIUS**2
        p.changeDynamics(
            body,
            -1,
            localInertiaDiagonal=[i_xx, i_xx, i_zz],
            linearDamping=0.01,
            angularDamping=0.02,
        )
        traj = []
        fuel = 1.0
        for action in np.asarray(actions):
            pos, orn = p.getBasePositionAndOrientation(body)
            vel, ang = p.getBaseVelocity(body)
            traj.append(np.array(list(pos) + list(orn) + list(vel) + list(ang)))
            # manual gravity (the reference's double-apply quirk)
            p.applyExternalForce(
                body, -1, [0, 0, -9.81 * MASS], pos, p.WORLD_FRAME
            )
            if fuel > 0:
                fuel = max(0.0, fuel - FUEL_PER_STEP)
                pitch, yaw = np.asarray(action) * MAX_GIMBAL_RAD
                local = np.array(
                    [
                        THRUST * math.sin(yaw),
                        THRUST * math.sin(pitch),
                        THRUST * math.cos(pitch) * math.cos(yaw),
                    ]
                )
                rot = np.array(p.getMatrixFromQuaternion(orn)).reshape(3, 3)
                world = rot @ local
                at = np.array(pos) + rot @ np.array([0, 0, -0.5])
                p.applyExternalForce(
                    body, -1, world.tolist(), at.tolist(), p.WORLD_FRAME
                )
            v = np.array(vel)
            speed = np.linalg.norm(v)
            rho = 1.225 * math.exp(-pos[2] / 8400)
            if speed > 0.1:
                drag = 0.5 * rho * speed**2 * 0.47 * math.pi * RADIUS**2
                p.applyExternalForce(
                    body, -1, (-drag * v / speed).tolist(), pos, p.WORLD_FRAME
                )
            p.applyExternalTorque(
                body, -1, (-0.02 * rho * np.array(ang)).tolist(), p.WORLD_FRAME
            )
            p.stepSimulation()
        return np.stack(traj)
    finally:
        p.disconnect(cid)


def torch_trajectory(
    actions: np.ndarray, start_pos=START_POS, device: str | torch.device = DEFAULT_DEVICE
) -> np.ndarray:
    """The same scene through the port's physics → (T, 13) float32
    [pos, quat, vel, ω], the state before each step.

    One body as an N = 1 batch through ``ops.step_kernel.step_kernel`` with
    ``RocketParams(double_gravity=True)``, the nominal mass, thrust scale 1,
    no CG offset and no wind. The thrust is on while the fuel, which drops by
    0.001 a step from 1, is above 0. Every K1 input is a fresh contiguous
    (1, k) tensor (K1's 16-byte alignment rule); the rows stay on the device
    and are copied to the host once."""
    from tvc_ai_torch.ops.step_kernel import step_kernel
    from tvc_ai_torch.physics.integrator import ThrustControl
    from tvc_ai_torch.physics.types import RigidBodyState, RocketParams

    dev = resolve_device(device)
    params = RocketParams(double_gravity=True)
    actions = np.asarray(actions)
    gimbals = torch.as_tensor(actions * MAX_GIMBAL_RAD, dtype=torch.float32).to(dev)
    thrust_on, fuel = [], 1.0
    for _ in range(len(actions)):
        thrust_on.append(fuel > 0)
        fuel = max(0.0, fuel - FUEL_PER_STEP)
    thrust_on = torch.tensor(thrust_on, dtype=torch.bool).to(dev)

    def zeros(k: int) -> torch.Tensor:
        return torch.zeros((1, k), dtype=torch.float32, device=dev)

    state = RigidBodyState(
        pos=torch.tensor([start_pos], dtype=torch.float32).to(dev),
        quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32).to(dev),
        vel=zeros(3), omega=zeros(3),
    )
    mass = torch.full((1,), params.mass, dtype=torch.float32, device=dev)
    thrust_scale = torch.ones(1, dtype=torch.float32, device=dev)
    cg_offset, wind = zeros(3), zeros(3)
    rows = torch.empty((len(actions), 13), dtype=torch.float32, device=dev)
    for t in range(len(actions)):
        torch.cat([state.pos[0], state.quat[0], state.vel[0], state.omega[0]], out=rows[t])
        control = ThrustControl(gimbal=gimbals[t:t + 1].clone(),
                                thrust_active=thrust_on[t:t + 1].clone())
        state = step_kernel(state, control, params, mass, thrust_scale, cg_offset, wind)
    return rows.cpu().numpy()


def write_goldens(path: str | Path, trajectories: dict[str, np.ndarray]) -> Path:
    """Write a golden fixture whose recorded side is ``trajectories`` (by
    scenario name; the scenarios it names, in ``SCENARIOS`` order)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload: dict[str, np.ndarray] = {
        "fixture_version": np.int64(FIXTURE_VERSION),
        "start_pos": np.asarray(START_POS),
    }
    names = []
    for sc in SCENARIOS:
        if sc.name not in trajectories:
            continue
        payload[f"{sc.name}/actions"] = sc.actions()
        payload[f"{sc.name}/trajectory"] = trajectories[sc.name]
        payload[f"{sc.name}/pos_tol"] = np.float64(sc.pos_tol)
        payload[f"{sc.name}/quat_dot_min"] = np.float64(sc.quat_dot_min)
        names.append(sc.name)
    payload["scenarios"] = np.asarray(names)
    np.savez_compressed(path, **payload)
    return path


def record_goldens(path: str | Path = DEFAULT_FIXTURE) -> Path:
    """Run PyBullet for every scenario and write the golden fixture."""
    if not has_pybullet():
        raise RuntimeError(
            "pybullet is not importable here — run this on a machine with "
            "pybullet installed (pip install pybullet)"
        )
    return write_goldens(
        path, {sc.name: pybullet_trajectory(sc.actions()) for sc in SCENARIOS})


def compare_trajectories(
    ours: np.ndarray, ref: np.ndarray, pos_tol: float, quat_dot_min: float
) -> dict:
    """Tolerance comparison → metrics dict with a ``passed`` flag."""
    pos_err = float(np.max(np.abs(ours[:, :3] - ref[:, :3])))
    quat_dot = float(
        np.min(np.abs(np.sum(ours[:, 3:7] * ref[:, 3:7], axis=1)))
    )
    return {
        "max_pos_err_m": pos_err,
        "pos_tol_m": pos_tol,
        "min_quat_dot": quat_dot,
        "quat_dot_min": quat_dot_min,
        "passed": pos_err <= pos_tol and quat_dot >= quat_dot_min,
    }


def check_goldens(
    path: str | Path = DEFAULT_FIXTURE, device: str | torch.device = DEFAULT_DEVICE
) -> dict:
    """Replay recorded goldens through ``torch_trajectory`` → report dict."""
    dev = resolve_device(device)
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"no golden fixture at {path} — record one with "
            "`python -m tvc_ai_torch.pybullet_goldens record` on a pybullet machine"
        )
    data = np.load(path, allow_pickle=False)
    version = int(data["fixture_version"])
    if version != FIXTURE_VERSION:
        raise ValueError(
            f"fixture version {version} != supported {FIXTURE_VERSION}"
        )
    report: dict = {"fixture": str(path), "scenarios": {}, "passed": True}
    start_pos = tuple(data["start_pos"])
    for name in data["scenarios"]:
        name = str(name)
        result = compare_trajectories(
            torch_trajectory(data[f"{name}/actions"], start_pos=start_pos, device=dev),
            data[f"{name}/trajectory"],
            float(data[f"{name}/pos_tol"]),
            float(data[f"{name}/quat_dot_min"]),
        )
        report["scenarios"][name] = result
        report["passed"] &= result["passed"]
    return report
