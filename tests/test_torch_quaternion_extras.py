"""The quaternion names the port adds (``to_matrix``, ``tilt_from_up``,
``random_tilt_quaternion``) against the JAX package (CPU).

``to_matrix`` on 256 random unit quaternions at 1e-6; ``tilt_from_up`` at
1e-5 for tilts of 0.05 rad and more, and at the reference's own 1e-3
upright (arccos near 1 is ill-conditioned); ``random_tilt_quaternion`` on
the uniforms JAX's key split draws at 1e-6, and bounded by ``max_tilt``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.physics import quaternion as t_quat
from tvc_ai_tpu.physics import quaternion as j_quat

TIGHT = dict(atol=1e-6, rtol=0.0)
MAX_TILT = 0.3


def _unit_quaternions(n: int, seed: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_to_matrix_matches_jax():
    q = _unit_quaternions(256, 0)
    got = t_quat.to_matrix(torch.from_numpy(q))
    want = np.array(j_quat.to_matrix(jnp.asarray(q)))
    assert got.shape == (256, 3, 3)
    torch.testing.assert_close(got, torch.from_numpy(want), **TIGHT)
    # a rotation: orthonormal, and it rotates as ``rotate`` does
    eye = torch.eye(3).expand(256, 3, 3)
    torch.testing.assert_close(got @ got.transpose(1, 2), eye, atol=1e-5, rtol=0.0)
    v = torch.from_numpy(np.random.default_rng(1).normal(size=(256, 3)).astype(np.float32))
    torch.testing.assert_close((got @ v[:, :, None])[..., 0],
                               t_quat.rotate(torch.from_numpy(q), v), atol=1e-5, rtol=0.0)


@pytest.mark.parametrize("case", ["tilted", "upright"])
def test_tilt_from_up_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "tilted":
        tilt = rng.uniform(0.05, 3.0, size=128).astype(np.float32)
        tol = 1e-5
    else:
        tilt = np.zeros(4, np.float32)
        tol = 1e-3
    az = rng.uniform(0.0, 2 * np.pi, size=tilt.shape).astype(np.float32)
    axis = np.stack([np.cos(az), np.sin(az), np.zeros_like(az)], axis=-1)
    q = np.array(j_quat.from_axis_angle(jnp.asarray(axis), jnp.asarray(tilt)))
    got = t_quat.tilt_from_up(torch.from_numpy(q))
    want = np.array(j_quat.tilt_from_up(jnp.asarray(q)))
    torch.testing.assert_close(got, torch.from_numpy(want), atol=tol, rtol=0.0)
    torch.testing.assert_close(got, torch.from_numpy(tilt), atol=tol, rtol=0.0)
    # a spin about the body axis alone tilts nothing
    if case == "upright":
        spin = t_quat.from_axis_angle(torch.tensor([0.0, 0.0, 1.0]), torch.tensor(1.2))
        assert float(t_quat.tilt_from_up(spin)) == pytest.approx(0.0, abs=tol)


@pytest.fixture(scope="module")
def jax_tilts():
    """64 of the reference's draws and the two uniforms each consumed."""
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    qs = jax.vmap(lambda k: j_quat.random_tilt_quaternion(k, jnp.float32(MAX_TILT)))(keys)

    def uniforms(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k1, ()), jax.random.uniform(k2, ())])

    return np.array(qs), np.array(jax.vmap(uniforms)(keys))


def test_random_tilt_quaternion_replays_jax(jax_tilts):
    want, u = jax_tilts
    got = t_quat.random_tilt_quaternion(MAX_TILT, u=torch.from_numpy(u))
    torch.testing.assert_close(got, torch.from_numpy(want), **TIGHT)


def test_random_tilt_quaternion_bounded():
    gen = torch.Generator().manual_seed(0)
    qs = torch.stack([t_quat.random_tilt_quaternion(MAX_TILT, generator=gen)
                      for _ in range(64)])
    torch.testing.assert_close(torch.linalg.vector_norm(qs, dim=-1), torch.ones(64))
    tilts = t_quat.tilt_from_up(qs)
    assert float(tilts.max()) <= MAX_TILT + 1e-5
    assert float(tilts.min()) >= 0.0 and len(set(tilts.tolist())) == 64
    # a batch of pairs gives a batch of quaternions
    u = torch.rand((5, 2), generator=gen)
    assert t_quat.random_tilt_quaternion(torch.tensor(MAX_TILT), u=u).shape == (5, 4)
