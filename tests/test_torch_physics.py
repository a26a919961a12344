"""Physics core of tvc_ai_torch against the JAX reference (CPU).

The port's plain integrator (K1's plain version) is held against
``jax.vmap(integrator.step)`` and against the Pallas kernel run in interpret
mode, at the bars of ``tests/test_pallas_step.py``: atol 2e-5 / rtol 2e-4 in
flight, 5e-5 / 5e-4 in ground contact. K1 itself runs only on the card; its
wrapper's CPU route (the plain version) and its input checks are covered here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.ops.step_kernel import step_kernel
from tvc_ai_torch.physics import integrator as t_int
from tvc_ai_torch.physics import quaternion as t_quat
from tvc_ai_torch.physics.types import RigidBodyState as TState
from tvc_ai_torch.physics.types import RocketParams as TParams
from tvc_ai_tpu.ops.pallas_step import step_pallas
from tvc_ai_tpu.physics import RigidBodyState, RocketParams, ThrustControl
from tvc_ai_tpu.physics import quaternion as j_quat
from tvc_ai_tpu.physics.integrator import step as j_step

torch.set_num_threads(1)
FLIGHT = dict(atol=2e-5, rtol=2e-4)
CONTACT = dict(atol=5e-5, rtol=5e-4)


def random_batch(seed: int, n: int, ground: bool = False):
    """numpy state + per-env controls and domain draws."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0.3, 0.55 if ground else 10.0, size=n)
    return dict(
        pos=pos,
        quat=quat,
        vel=(rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
        omega=rng.normal(size=(n, 3)).astype(np.float32),
        gimbal=rng.uniform(-0.3, 0.3, size=(n, 2)).astype(np.float32),
        active=rng.uniform(size=n) > 0.3,
        mass=rng.uniform(1.5, 2.5, size=n).astype(np.float32),
        thrust_scale=rng.uniform(0.8, 1.2, size=n).astype(np.float32),
        cg=(rng.normal(size=(n, 3)) * 0.02).astype(np.float32),
        wind=rng.normal(size=(n, 3)).astype(np.float32),
    )


def jax_args(b):
    state = RigidBodyState(pos=jnp.asarray(b["pos"]), quat=jnp.asarray(b["quat"]),
                           vel=jnp.asarray(b["vel"]), omega=jnp.asarray(b["omega"]))
    ctrl = ThrustControl(gimbal=jnp.asarray(b["gimbal"]), thrust_active=jnp.asarray(b["active"]))
    dr = tuple(jnp.asarray(b[k]) for k in ("mass", "thrust_scale", "cg", "wind"))
    return state, ctrl, dr


def torch_args(b):
    state = TState(**{k: torch.from_numpy(b[k]) for k in ("pos", "quat", "vel", "omega")})
    ctrl = t_int.ThrustControl(gimbal=torch.from_numpy(b["gimbal"]),
                               thrust_active=torch.from_numpy(b["active"]))
    dr = tuple(torch.from_numpy(b[k]) for k in ("mass", "thrust_scale", "cg", "wind"))
    return state, ctrl, dr


def jax_vmap_step(b, params):
    state, ctrl, (m, t, c, w) = jax_args(b)
    return jax.vmap(
        lambda s, g, a, m, t, c, w: j_step(
            s, ThrustControl(g, a), params, mass=m, thrust_scale=t, cg_offset=c, wind=w
        )
    )(state, ctrl.gimbal, ctrl.thrust_active, m, t, c, w)


def assert_body_close(t_out, j_out, tol, names=("pos", "quat", "vel", "omega")):
    for name in names:
        np.testing.assert_allclose(
            getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name)),
            err_msg=name, **tol,
        )


# ------------------------------------------------------------- quaternion


QUAT_FNS = {
    "normalize": (lambda q, v: (q * 3.0,), lambda m, q: m.normalize(q)),
    "multiply": (lambda q, v: (q, q[::-1]), lambda m, a, b: m.multiply(a, b)),
    "rotate": (lambda q, v: (q, v), lambda m, q, v: m.rotate(q, v)),
    "rotate_inverse": (lambda q, v: (q, v), lambda m, q, v: m.rotate_inverse(q, v)),
    "from_axis_angle": (lambda q, v: (v / np.linalg.norm(v, axis=-1, keepdims=True), q[:, 0]),
                        lambda m, a, t: m.from_axis_angle(a, t)),
    "exp_map": (lambda q, v: (v * 0.05,), lambda m, w: m.exp_map(w)),
    "exp_map_tiny": (lambda q, v: (v * 1e-7,), lambda m, w: m.exp_map(w)),
    "integrate": (lambda q, v: (q, v), lambda m, q, w: m.integrate(q, w, 0.005)),
    "to_euler_zyx": (lambda q, v: (q,), lambda m, q: m.to_euler_zyx(q)),
    "tilt_angle": (lambda q, v: (q,), lambda m, q: m.tilt_angle(q)),
}


@pytest.mark.parametrize("name", sorted(QUAT_FNS))
def test_quaternion_matches_jax(name):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    make, call = QUAT_FNS[name]
    args = make(q, v)
    ref = np.asarray(call(j_quat, *(jnp.asarray(a) for a in args)))
    out = call(t_quat, *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------- integrator


@pytest.mark.parametrize("n", [4, 100, 77])
def test_integrator_matches_jax_and_pallas(n):
    """Plain integrator vs vmap(integrator.step) and the Pallas kernel
    (interpret mode); n = 77 is a ragged batch for the kernel's padding."""
    b = random_batch(n, n)
    params = RocketParams()
    ref = jax_vmap_step(b, params)
    state, ctrl, (m, t, c, w) = jax_args(b)
    pal = step_pallas(state, ctrl, params, m, t, c, w, block_envs=128, interpret=True)
    out = t_int.step(*torch_args(b)[:2], TParams(), *torch_args(b)[2])
    assert_body_close(out, ref, FLIGHT)
    assert_body_close(out, pal, FLIGHT)


def test_integrator_contact_matches_jax_and_pallas():
    """On-ground states exercise the contact terms."""
    b = random_batch(5, 32, ground=True)
    b["gimbal"][:] = 0.0
    b["active"][:] = False
    params = RocketParams()
    ref = jax_vmap_step(b, params)
    state, ctrl, (m, t, c, w) = jax_args(b)
    pal = step_pallas(state, ctrl, params, m, t, c, w, block_envs=128, interpret=True)
    out = t_int.step(*torch_args(b)[:2], TParams(), *torch_args(b)[2])
    assert_body_close(out, ref, CONTACT)
    assert_body_close(out, pal, CONTACT)


@pytest.mark.parametrize("term", ["magnus_effect", "ground_effect", "gyroscopic"])
def test_integrator_opt_in_terms_match_jax(term):
    b = random_batch(9, 64)
    b["pos"][:, 2] = np.random.default_rng(1).uniform(0.3, 1.5, size=64)  # ground effect range
    ref = jax_vmap_step(b, RocketParams(**{term: True}))
    out = t_int.step(*torch_args(b)[:2], TParams(**{term: True}), *torch_args(b)[2])
    assert_body_close(out, ref, FLIGHT)
    # the term changes the result, so the comparison sees it
    off = t_int.step(*torch_args(b)[:2], TParams(), *torch_args(b)[2])
    assert not torch.allclose(off.vel if term != "gyroscopic" else off.omega,
                              out.vel if term != "gyroscopic" else out.omega, atol=1e-6)


def test_integrator_thrust_offset_matches_jax():
    """K1 takes thrust_offset as a parameter; the plain version honours it."""
    b = random_batch(11, 16)
    ref = jax_vmap_step(b, RocketParams(thrust_offset=jnp.array([0.01, -0.02, -0.4], jnp.float32)))
    out = t_int.step(*torch_args(b)[:2], TParams(thrust_offset=(0.01, -0.02, -0.4)),
                     *torch_args(b)[2])
    assert_body_close(out, ref, FLIGHT)


# ------------------------------------------------------------- K1 wrapper


def test_step_kernel_cpu_route_is_the_plain_version():
    b = random_batch(13, 50)
    before = step_kernel.launches
    out = step_kernel(*torch_args(b)[:2], TParams(), *torch_args(b)[2])
    ref = t_int.step(*torch_args(b)[:2], TParams(), *torch_args(b)[2])
    assert_body_close(out, ref, dict(atol=0.0, rtol=0.0))
    assert step_kernel.launches == before  # the counter counts kernel launches only


@pytest.mark.parametrize("fault", ["float64", "shape", "noncontiguous", "opt_in"])
def test_step_kernel_rejects_bad_input(fault):
    b = random_batch(17, 8)
    state, ctrl, (m, t, c, w) = torch_args(b)
    params = TParams()
    err = ValueError
    if fault == "float64":
        m, err = m.double(), TypeError
    elif fault == "shape":
        c = c[:, :2]
    elif fault == "noncontiguous":
        w = torch.from_numpy(np.asfortranarray(b["wind"]))
        assert not w.is_contiguous()
    else:
        params = TParams(gyroscopic=True)
    with pytest.raises(err):
        step_kernel(state, ctrl, params, m, t, c, w)
