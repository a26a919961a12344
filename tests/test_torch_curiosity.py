"""The ICM, the physics-informed loss and RND of tvc_ai_torch against the JAX
package (CPU).

Each JAX state is carried across with ``convert``; both sides then see the
same seeded numpy inputs. Bars: the ICM's intrinsic reward and the
physics-informed loss 1e-6 absolute / 1e-5 relative; after five ICM updates
(with and without the physics-informed term) and five RND updates every
parameter, Adam moment and the normalizer within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree
from tvc_ai_torch.agents import physics_informed as t_pi
from tvc_ai_torch.convert import curiosity_state_from_numpy, rnd_state_from_numpy
from tvc_ai_torch.models import curiosity as t_icm
from tvc_ai_torch.models import rnd as t_rnd
from tvc_ai_tpu.agents import physics_informed as j_pi
from tvc_ai_tpu.models import curiosity as j_icm
from tvc_ai_tpu.models import rnd as j_rnd

torch.set_num_threads(1)
B, FRAME, ACT = 64, 10, 2
UPDATES = 5
CLOSE = dict(atol=1e-6, rtol=1e-5)
STATE = dict(atol=1e-5, rtol=0.0)
ICM_CFG = dict(hidden_dim=32, lr=1e-3)
RND_CFG = dict(hidden_dims=(32, 16), embed_dim=8, lr=1e-3)


def _inputs(seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, FRAME)).astype(np.float32)
    obs[:, :4] /= np.linalg.norm(obs[:, :4], axis=1, keepdims=True)   # a quaternion
    act = rng.uniform(-1.0, 1.0, size=(B, ACT)).astype(np.float32)
    nxt = (obs + 0.1 * rng.normal(size=obs.shape)).astype(np.float32)
    return obs, act, nxt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_modules_close(a: torch.nn.Module, b: torch.nn.Module, what: str) -> None:
    for (name, p), q in zip(a.named_parameters(), b.parameters(), strict=True):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE,
                                   err_msg=f"{what}.{name}")


def _assert_adam_close(a, b, what: str) -> None:
    assert a.count == b.count, what
    for moment in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(getattr(a, moment), getattr(b, moment), strict=True)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **STATE,
                                       err_msg=f"{what}.{moment}[{i}]")


def test_physics_informed_loss_matches_jax():
    obs, act, nxt = _inputs(1)
    cfg = j_pi.PhysicsInformedConfig(physics_weight=0.3)
    j_total, j_terms = j_pi.physics_informed_loss(*_j(obs, act, nxt), cfg)
    t_total, t_terms = t_pi.physics_informed_loss(*_t(obs, act, nxt),
                                                  t_pi.PhysicsInformedConfig(physics_weight=0.3))
    np.testing.assert_allclose(t_total.numpy(), np.asarray(j_total), **CLOSE)
    assert sorted(t_terms) == sorted(j_terms)
    for k in t_terms:
        np.testing.assert_allclose(t_terms[k].numpy(), np.asarray(j_terms[k]), **CLOSE, err_msg=k)
    adapter = t_pi.make_icm_physics_loss()(*_t(nxt, obs, act))
    np.testing.assert_allclose(adapter.numpy(),
                               np.asarray(j_pi.make_icm_physics_loss()(*_j(nxt, obs, act))),
                               **CLOSE)


def test_icm_intrinsic_reward_matches_jax():
    cfg = j_icm.CuriosityConfig(**ICM_CFG)
    state = j_icm.init(jax.random.PRNGKey(0), cfg)
    port = curiosity_state_from_numpy(np_tree(state), t_icm.CuriosityConfig(**ICM_CFG), "cpu")
    obs, act, nxt = _inputs(2)
    want = j_icm.intrinsic_reward(state, *_j(obs, act, nxt), cfg)
    got = t_icm.intrinsic_reward(port, *_t(obs, act, nxt), t_icm.CuriosityConfig(**ICM_CFG))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


@pytest.mark.parametrize("physics", [False, True], ids=["plain", "physics"])
def test_icm_updates_match_jax(physics):
    j_cfg, t_cfg = j_icm.CuriosityConfig(**ICM_CFG), t_icm.CuriosityConfig(**ICM_CFG)
    state = j_icm.init(jax.random.PRNGKey(1), j_cfg)
    port = curiosity_state_from_numpy(np_tree(state), t_cfg, "cpu")
    j_fn = j_pi.make_icm_physics_loss() if physics else None
    t_fn = t_pi.make_icm_physics_loss() if physics else None
    j_update = jax.jit(lambda s, o, a, n: j_icm.update(s, o, a, n, j_cfg, physics_loss_fn=j_fn))
    for i in range(UPDATES):
        obs, act, nxt = _inputs(10 + i)
        state, j_metrics = j_update(state, *_j(obs, act, nxt))
        port, metrics = t_icm.update(port, *_t(obs, act, nxt), t_cfg, physics_loss_fn=t_fn)
    ref = curiosity_state_from_numpy(np_tree(state), t_cfg, "cpu")
    _assert_modules_close(port.nets, ref.nets, "icm")
    _assert_adam_close(port.opt, ref.opt, "icm.opt")
    assert port.step == ref.step == UPDATES
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    assert (float(metrics["icm_physics_loss"]) > 0.0) == physics


def test_rnd_updates_match_jax():
    j_cfg, t_cfg = j_rnd.RNDConfig(**RND_CFG), t_rnd.RNDConfig(**RND_CFG)
    state = j_rnd.init(jax.random.PRNGKey(2), j_cfg)
    port = rnd_state_from_numpy(np_tree(state), t_cfg, "cpu")
    j_update = jax.jit(lambda s, o: j_rnd.update(s, o, j_cfg))
    j_reward = jax.jit(lambda s, o: j_rnd.intrinsic_reward(s, o, j_cfg))
    for i in range(UPDATES):
        obs = _inputs(20 + i)[0]
        np.testing.assert_allclose(t_rnd.intrinsic_reward(port, *_t(obs), t_cfg).numpy(),
                                   np.asarray(j_reward(state, *_j(obs))), **CLOSE,
                                   err_msg=f"reward before update {i}")
        state, j_metrics = j_update(state, *_j(obs))
        port, metrics = t_rnd.update(port, *_t(obs), t_cfg)
    ref = rnd_state_from_numpy(np_tree(state), t_cfg, "cpu")
    _assert_modules_close(port.predictor, ref.predictor, "rnd.predictor")
    _assert_modules_close(port.target, ref.target, "rnd.target")
    _assert_adam_close(port.opt, ref.opt, "rnd.opt")
    for name in ("bonus_mean", "bonus_var"):
        np.testing.assert_allclose(getattr(port, name).numpy(), getattr(ref, name).numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert port.step == ref.step == UPDATES
    assert float(port.bonus_var) != 1.0   # the normalizer moved
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    # the target is frozen: not a parameter anything steps
    assert all(not p.requires_grad for p in port.target.parameters())


def test_seeded_inits():
    icm = t_icm.init(t_icm.CuriosityConfig(), "cpu", seed=3)
    assert sum(p.numel() for p in icm.nets.parameters()) == (
        (10 * 256 + 256) + (256 * 256 + 256) + (256 * 8 + 8)
        + (16 * 256 + 256) + (256 * 256 + 256) + (256 * 2 + 2))
    r = t_rnd.init(t_rnd.RNDConfig(), "cpu", seed=3)
    assert not torch.equal(r.target.Dense_0.weight, r.predictor.Dense_0.weight)
    assert float(r.bonus_mean) == 0.0 and float(r.bonus_var) == 1.0
