"""The PyBullet-parity harness of tvc_ai_torch against the JAX package (CPU).

``torch_trajectory`` (the port's physics through K1's wrapper, which on the
CPU is its plain version) against ``jax_trajectory`` for all five scenarios
at 2e-5 + 2e-4·|ref|; one fixture format for both packages (the reference's
trajectories pass the port's ``check_goldens``, the port's pass the
reference's); a perturbed fixture fails; the fixture errors; the
``pybullet_goldens`` command; and the live and ``DEFAULT_FIXTURE`` cases,
which skip exactly where the reference's do (no pybullet, no recorded
fixture in the repository).
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

from tvc_ai_torch import pybullet_goldens
from tvc_ai_torch.eval import pybullet_parity as t_pp
from tvc_ai_tpu.eval import pybullet_parity as j_pp

TRAJ = dict(atol=2e-5, rtol=2e-4)
ROUND_TRIP = ("constant_gimbal", "spin_up")   # the port's fixture, replayed by JAX


@pytest.fixture(scope="module")
def jax_trajectories() -> dict[str, np.ndarray]:
    return {sc.name: j_pp.jax_trajectory(sc.actions()) for sc in j_pp.SCENARIOS}


@pytest.fixture(scope="module")
def torch_trajectories() -> dict[str, np.ndarray]:
    return {sc.name: t_pp.torch_trajectory(sc.actions(), device="cpu")
            for sc in t_pp.SCENARIOS}


def write_fixture(path, trajectories: dict[str, np.ndarray], version=t_pp.FIXTURE_VERSION):
    """``write_goldens``'s fixture, its version replaced by ``version``."""
    t_pp.write_goldens(path, trajectories)
    if version != t_pp.FIXTURE_VERSION:
        payload = dict(np.load(path))
        payload["fixture_version"] = np.int64(version)
        np.savez_compressed(path, **payload)
    return path


def test_harness_constants_match_jax():
    assert t_pp.SCENARIOS == tuple(
        t_pp.Scenario(s.name, s.steps, s.pos_tol, s.quat_dot_min) for s in j_pp.SCENARIOS)
    for a, b in zip(t_pp.SCENARIOS, j_pp.SCENARIOS):
        np.testing.assert_array_equal(a.actions(), b.actions())
    assert (t_pp.FIXTURE_VERSION, t_pp.START_POS, t_pp.MASS, t_pp.LENGTH, t_pp.RADIUS,
            t_pp.THRUST, t_pp.MAX_GIMBAL_RAD) == (
        j_pp.FIXTURE_VERSION, j_pp.START_POS, j_pp.MASS, j_pp.LENGTH, j_pp.RADIUS,
        j_pp.THRUST, j_pp.MAX_GIMBAL_RAD)
    assert t_pp.DEFAULT_FIXTURE == j_pp.DEFAULT_FIXTURE


@pytest.mark.parametrize("name", [sc.name for sc in t_pp.SCENARIOS])
def test_torch_trajectory_matches_jax(name, jax_trajectories, torch_trajectories):
    got, want = torch_trajectories[name], jax_trajectories[name]
    steps = next(sc.steps for sc in t_pp.SCENARIOS if sc.name == name)
    assert got.shape == want.shape == (steps, 13) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TRAJ)
    assert got[:, 2].min() > 8.0   # free flight, clear of the ground


def test_one_fixture_serves_both_packages(tmp_path, jax_trajectories, torch_trajectories):
    """The reference's trajectories pass the port's check; a fixture the
    port writes from its own passes the reference's; each package's own
    pass exactly."""
    ref_fixture = write_fixture(tmp_path / "jax.npz", jax_trajectories)
    report = t_pp.check_goldens(ref_fixture, device="cpu")
    assert report["passed"], report
    assert set(report["scenarios"]) == {sc.name for sc in t_pp.SCENARIOS}
    for result in report["scenarios"].values():
        assert result["max_pos_err_m"] <= 1e-4 and result["min_quat_dot"] >= 1 - 1e-6

    port_fixture = write_fixture(tmp_path / "torch.npz",
                                 {k: torch_trajectories[k] for k in ROUND_TRIP})
    ref_report = j_pp.check_goldens(port_fixture)
    assert ref_report["passed"], ref_report
    self_report = t_pp.check_goldens(port_fixture, device="cpu")
    assert all(r["max_pos_err_m"] == 0.0 for r in self_report["scenarios"].values())


def test_perturbed_fixture_fails(tmp_path, torch_trajectories):
    bad = dict(torch_trajectories)
    name = t_pp.SCENARIOS[0].name
    bad[name] = bad[name] + 1.0
    report = t_pp.check_goldens(write_fixture(tmp_path / "bad.npz", bad), device="cpu")
    assert not report["passed"]
    assert not report["scenarios"][name]["passed"]
    assert all(r["passed"] for k, r in report["scenarios"].items() if k != name)


def test_fixture_errors(tmp_path, torch_trajectories):
    wrong = write_fixture(tmp_path / "v2.npz", torch_trajectories, version=2)
    with pytest.raises(ValueError, match="fixture version 2"):
        t_pp.check_goldens(wrong, device="cpu")
    with pytest.raises(FileNotFoundError, match="no golden fixture"):
        t_pp.check_goldens(tmp_path / "missing.npz", device="cpu")
    if not t_pp.has_pybullet():
        with pytest.raises(RuntimeError, match="pybullet is not importable"):
            t_pp.record_goldens(tmp_path / "new.npz")
        assert not (tmp_path / "new.npz").exists()


def test_goldens_command(tmp_path, torch_trajectories):
    good = write_fixture(tmp_path / "good.npz", torch_trajectories)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pybullet_goldens.main(["check", "--fixture", str(good), "--cpu"])
    assert rc == 0
    text = out.getvalue()
    assert text.rstrip().endswith("PARITY PASS")
    report = json.loads(text[:text.rindex("PARITY PASS")])
    assert report["passed"] and report["fixture"] == str(good)

    bad = dict(torch_trajectories)
    bad["spin_up"] = bad["spin_up"] * 1.5
    bad_path = write_fixture(tmp_path / "bad.npz", bad)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pybullet_goldens.main(["check", "--fixture", str(bad_path), "--cpu"])
    assert rc == 1 and "PARITY FAIL" in err.getvalue()
    assert "PARITY PASS" not in out.getvalue()


@pytest.mark.parametrize("scenario", t_pp.SCENARIOS, ids=lambda s: s.name)
@pytest.mark.skipif(not t_pp.has_pybullet(), reason="pybullet not installed")
def test_live_parity(scenario):
    actions = scenario.actions()
    result = t_pp.compare_trajectories(
        t_pp.torch_trajectory(actions, device="cpu"),
        t_pp.pybullet_trajectory(actions),
        scenario.pos_tol,
        scenario.quat_dot_min,
    )
    assert result["passed"], result


@pytest.mark.skipif(
    not t_pp.DEFAULT_FIXTURE.exists(),
    reason=(
        "no recorded golden fixture — run "
        "`python -m tvc_ai_torch.pybullet_goldens record` on a pybullet machine "
        "and check in tests/fixtures/pybullet_goldens.npz"
    ),
)
def test_golden_replay():
    report = t_pp.check_goldens(device="cpu")
    assert report["passed"], report
