"""Physics core of tvc_ai_torch against the JAX reference (CPU).

The port's plain integrator (K1's plain version) is held against
``jax.vmap(integrator.step)`` and against the Pallas kernel run in interpret
mode, at the bars of ``tests/test_pallas_step.py``: atol 2e-5 / rtol 2e-4 in
flight, 5e-5 / 5e-4 in ground contact. K1 itself runs only on the card; its
wrapper's CPU route (the plain version), its input checks and its launch path
(the packed parameters, the argument order against the CUDA source, the
output buffer's layout, the alignment of what the env path hands it) are
covered here.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.env import types as t_types
from tvc_ai_torch.ops import step_kernel as k1
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


@pytest.mark.parametrize("fault", ["float64", "shape", "noncontiguous", "opt_in", "misaligned"])
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
    elif fault == "misaligned":
        # a contiguous view one float into its storage
        m = torch.cat([torch.zeros(1), m])[1:]
        assert m.is_contiguous() and m.data_ptr() % 16 == 4
    else:
        params = TParams(gyroscopic=True)
    with pytest.raises(err, match="aligned" if fault == "misaligned" else None):
        step_kernel(state, ctrl, params, m, t, c, w)


# ------------------------------------------------------------- K1 launch path

CU_SOURCE = Path(k1.SOURCE).read_text()
CTYPES_OF_C = {"float": ctypes.c_float, "int": ctypes.c_int}


def test_step_params_mirror_the_cuda_struct():
    """The ctypes structure has the CUDA struct's fields, types and order."""
    body = re.search(r"struct StepParams \{(.*?)\};", CU_SOURCE, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"(float|int)\s+([^;]+);", body):
        fields += [(name.strip(), CTYPES_OF_C[ctype]) for name in names.split(",")]
    assert [(n, t) for n, t in k1.StepParams._fields_] == fields


def test_pack_params_fills_every_field_in_order():
    """A RocketParams with a distinct value in every field the kernel reads
    lands in StepParams field by field, in order."""
    params = TParams(
        thrust=31.0, gravity=9.5, double_gravity=True, drag_coeff=0.41, rho0=1.19,
        atmosphere_scale_height=8300.0, aero_angular_damping=0.031, drag_min_speed=0.17,
        linear_damping=0.013, angular_damping=0.027, dt=0.021, contact_stiffness=4100.0,
        contact_damping=61.0, contact_friction=0.83, radius=0.057, length=1.07,
        thrust_offset=(0.011, -0.023, -0.47), substeps=5,
    )
    want = [31.0, 9.5, 1.0, 0.41, 1.19, 8300.0, 0.031, 0.17, 0.013, 0.027, 0.021,
            4100.0, 61.0, 0.83, 0.057, 1.07, 0.011, -0.023, -0.47, 5]
    assert len(set(want)) == len(want) == len(k1.StepParams._fields_)
    packed = k1.pack_params(params)
    got = [getattr(packed, name) for name, _ in k1.StepParams._fields_]
    np.testing.assert_array_equal(np.float32(got[:-1]), np.float32(want[:-1]))
    assert got[-1] == want[-1]
    assert k1.pack_params(TParams(**{**vars(params)})) is packed  # cached on the values
    off = k1.pack_params(TParams(double_gravity=False))
    assert off.double_g == 0.0


def test_entry_argtypes_follow_the_cuda_signatures():
    """The ctypes argument list of each C entry point matches its signature in
    the CUDA source: one pointer per tensor in INPUTS order then the outputs,
    StepParams by value, n, the stream."""
    c_types = {"float*": ctypes.c_void_p, "unsigned char*": ctypes.c_void_p,
               "void*": ctypes.c_void_p, "int*": ctypes.c_void_p, "int": ctypes.c_int,
               "StepParams": k1.StepParams}
    for name, argtypes in k1.ENTRY_ARGTYPES.items():
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', CU_SOURCE, re.S).group(1)
        params = [re.sub(r"\s*\*\s*", "* ", p.strip().removeprefix("const ")).rsplit(" ", 1)
                  for p in sig.split(",")]
        assert [c_types[t.strip()] for t, _ in params] == argtypes, name
    kernel = re.search(r'extern "C" int tvc_step_kernel\((.*?)\)', CU_SOURCE, re.S).group(1)
    names = [p.strip().rsplit(" ", 1)[-1].lstrip("*") for p in kernel.split(",")]
    inputs = [n for n, _, _ in k1.INPUTS]
    renamed = {"thrust_active": "active", "cg_offset": "cg"}
    assert names[:len(inputs)] == [renamed.get(n, n) for n in inputs]
    assert names[len(inputs):len(inputs) + 4] == ["pos_out", "quat_out", "vel_out", "omega_out"]


def test_check_inputs_returns_pointers_in_kernel_order():
    state, ctrl, dr = torch_args(random_batch(19, 24))
    ptrs = k1.check_inputs(state, ctrl, *dr)
    tensors = (state.pos, state.quat, state.vel, state.omega, *ctrl, *dr)
    assert ptrs == [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("n", [1, 4096, 4099])
def test_output_spans_are_disjoint_and_aligned(n):
    out = k1.alloc_outputs(n, torch.device("cpu"))
    views = (out.pos, out.quat, out.vel, out.omega)
    spans = []
    for view, k in zip(views, (3, 4, 3, 3)):
        assert view.shape == (n, k) and view.dtype == torch.float32
        assert view.is_contiguous()
        assert view.data_ptr() % 16 == 0
        spans.append((view.data_ptr(), view.data_ptr() + view.numel() * 4))
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1  # one allocation
    spans.sort()
    assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))


def test_env_path_hands_k1_aligned_tensors(monkeypatch):
    """batched_step_autoreset over 12 steps with autoresets at N = 37: every
    tensor that reaches K1's wrapper passes its checks, alignment included."""
    seen = []

    def spy(state, control, params, mass, thrust_scale, cg_offset, wind):
        seen.append((state.pos, state.quat, state.vel, state.omega, *control,
                     mass, thrust_scale, cg_offset, wind))
        return step_kernel(state, control, params, mass, thrust_scale, cg_offset, wind)

    monkeypatch.setattr(t_env, "step_kernel", spy)
    params = t_types.EnvParams(
        randomization=t_types.RandomizationConfig(enabled=True, sensor_noise_enabled=True),
        max_episode_steps=5,
    )
    gen = torch.Generator().manual_seed(3)
    states, _ = t_env.reset(params, 37, device="cpu", generator=gen)
    dones = 0
    for _ in range(12):
        actions = torch.rand((37, 2), generator=gen) * 2.0 - 1.0
        states, out, _ = t_env.batched_step_autoreset(states, actions, params, generator=gen)
        dones += int((out.terminated | out.truncated).sum())
    assert len(seen) == 12 and dones >= 37
    assert all(t.data_ptr() % 16 == 0 for call in seen for t in call)


def test_env_path_hands_k1_fresh_aligned_tensors_with_every_option(monkeypatch):
    """As above with every robust-training option on: the gathered feasible
    candidate, the mixture-gated plant and wind and the delayed gimbal reach
    K1 as fresh contiguous aligned tensors, never as views of the reset's
    draws (whose storages are checked against every K1 input)."""
    seen = []

    def spy(state, control, params, mass, thrust_scale, cg_offset, wind):
        seen.append((state.pos, state.quat, state.vel, state.omega, *control,
                     mass, thrust_scale, cg_offset, wind))
        return step_kernel(state, control, params, mass, thrust_scale, cg_offset, wind)

    monkeypatch.setattr(t_env, "step_kernel", spy)
    rnd = t_types.RandomizationConfig(
        enabled=True, sensor_noise_enabled=True, sensor_noise_uniform=True,
        progress_rate_randomized=True, progress_rate_min=0.5, feasible_only=True,
        feasible_tries=3, dr_mixture_enabled=True, dr_prob=0.6, sensor_dropout_enabled=True,
        sensor_dropout_prob=0.3, actuator_delay=True)
    reward = t_types.RewardConfig(survival_normalized_success=True,
                                  equilibrium_relative_shaping=True)
    params = t_types.EnvParams(randomization=rnd, reward=reward, max_episode_steps=5,
                               drift_obs_enabled=True)
    gen = torch.Generator().manual_seed(3)
    cpu = torch.device("cpu")
    draws = [t_env.draw_reset(params, 37, cpu, gen) for _ in range(13)]
    storages = {t.untyped_storage().data_ptr() for d in draws
                for t in (d.u_init, d.u_dr, d.u_feas, d.n_feas, d.n_imu)}
    states, _ = t_env.reset(params, 37, device="cpu", draws=draws[0])
    dones = 0
    for reset_draws in draws[1:]:
        actions = torch.rand((37, 2), generator=gen) * 2.0 - 1.0
        states, out, _ = t_env.batched_step_autoreset(states, actions, params, generator=gen,
                                                      reset_draws=reset_draws)
        dones += int((out.terminated | out.truncated).sum())
    assert len(seen) == 12 and dones >= 37
    assert all(t.data_ptr() % 16 == 0 and t.is_contiguous() for call in seen for t in call)
    assert not storages & {t.untyped_storage().data_ptr() for call in seen for t in call}
