"""The hierarchical module of tvc_ai_torch against the JAX package (CPU).

The goal draw: ``jax.random.categorical`` is the Gumbel-max trick, which the
first test asserts under the installed JAX, so the port's ``sample_goal``
fed ``jax.random.gumbel(key, (N, num_goals))`` must pick exactly the JAX
goals. Then the fused loop's masked REINFORCE step with some finished
episodes and with none (the skip: nothing moves, the Adam count included),
and the module's other API (``select_goal``, ``get_action``,
``update_high_level``) on a transformer low level. Bars: goals exact;
parameters, Adam moments, baseline 1e-5; the low level's forward 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree, to_torch
from tvc_ai_torch.convert import _adam_state, _dense_layers, high_level_state_from_numpy
from tvc_ai_torch.models import hierarchical as t_hier
from tvc_ai_tpu.models import hierarchical as j_hier

torch.set_num_threads(1)
N, FRAME, ACT, RING = 64, 10, 2, 32
CFG = dict(high_level_lr=1e-3, d_model=32, num_layers=2)
STATE = dict(atol=1e-5, rtol=0.0)


def _obs(seed: int, n: int = N) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, FRAME)) * 2.0).astype(np.float32)


def gumbel_draws(key, n: int, goals: int) -> torch.Tensor:
    return to_torch(jax.random.gumbel(key, (n, goals)))


def test_categorical_is_gumbel_argmax():
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = jax.random.categorical(key, logits, axis=-1)
        got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _high_pair(seed: int):
    cfg = j_hier.HierarchicalConfig(**CFG)
    state = j_hier.init_high(jax.random.PRNGKey(seed), FRAME, cfg)
    port = high_level_state_from_numpy(np_tree(state), FRAME, t_hier.HierarchicalConfig(**CFG),
                                       "cpu")
    return cfg, state, port


def test_sample_goal_matches_jax_exactly():
    cfg, state, port = _high_pair(1)
    t_cfg = t_hier.HierarchicalConfig(**CFG)
    obs = _obs(2)
    for seed in range(3):
        key = jax.random.PRNGKey(10 + seed)
        want = np.asarray(j_hier.sample_goal(state, jnp.asarray(obs), key, cfg))
        got = t_hier.sample_goal(port, torch.from_numpy(obs), t_cfg,
                                 gumbel_draws(key, N, cfg.num_goals))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    want = np.asarray(j_hier.sample_goal(state, jnp.asarray(obs), None, cfg, deterministic=True))
    got = t_hier.sample_goal(port, torch.from_numpy(obs), t_cfg, deterministic=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # the generator path: valid goals, all of them drawn at this size
    drawn = t_hier.sample_goal(port, torch.from_numpy(obs).repeat(20, 1), t_cfg,
                               generator=torch.Generator().manual_seed(0))
    assert set(drawn.tolist()) == set(range(cfg.num_goals))


@pytest.mark.parametrize("finished", [9, 0], ids=["some", "none"])
def test_update_high_masked_matches_jax(finished):
    cfg, state, port = _high_pair(3)
    t_cfg = t_hier.HierarchicalConfig(**CFG)
    j_update = jax.jit(lambda s, o, g, r, m: j_hier.update_high_masked(s, o, g, r, m, cfg))
    rng = np.random.default_rng(4)
    before = [p.detach().clone() for p in port.policy.parameters()]
    for it in range(3):
        obs = _obs(5 + it, RING)
        goal = rng.integers(0, cfg.num_goals, size=RING).astype(np.int32)
        ret = (rng.normal(size=RING) * 50.0).astype(np.float32)
        mask = (np.arange(RING) < finished).astype(np.float32)
        state, j_metrics = j_update(state, *(jnp.asarray(x) for x in (obs, goal, ret, mask)))
        port, metrics = t_hier.update_high_masked(
            port, *(torch.from_numpy(x) for x in (obs, goal, ret, mask)), t_cfg)
    ref = high_level_state_from_numpy(np_tree(state), FRAME, t_cfg, "cpu")
    for (name, p), q in zip(port.policy.named_parameters(), ref.policy.parameters(), strict=True):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE, err_msg=name)
    for moment in ("mu", "nu"):
        for x, y in zip(getattr(port.opt, moment), getattr(ref.opt, moment), strict=True):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **STATE, err_msg=moment)
    assert int(port.opt.count) == int(ref.opt.count) == (3 if finished else 0)
    assert int(port.step) == int(ref.step) == (3 if finished else 0)
    np.testing.assert_allclose(port.baseline.numpy(), ref.baseline.numpy(), atol=1e-5, rtol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    moved = any(not torch.equal(a, b) for a, b in zip(before, port.policy.parameters()))
    assert moved == bool(finished)
    assert port.opt.count.dtype == torch.int32 and port.opt.count.device.type == "cpu"


def _full_pair(seed: int):
    cfg = j_hier.HierarchicalConfig(**CFG)
    state = jax.jit(lambda k: j_hier.init(k, FRAME, ACT, cfg))(jax.random.PRNGKey(seed))
    t_cfg = t_hier.HierarchicalConfig(**CFG)
    tree = np_tree(state)
    port = t_hier.init(FRAME, ACT, t_cfg, "cpu")
    port.high.load_state_dict(_dense_layers(tree.high_params))
    port.low.load_state_dict(_dense_layers(tree.low_params))
    port.high_opt = _adam_state(tree.high_opt, port.high, torch.device("cpu"))
    port.low_opt = _adam_state(tree.low_opt, port.low, torch.device("cpu"))
    return cfg, state, t_cfg, port


def test_select_goal_and_get_action_match_jax():
    cfg, state, t_cfg, port = _full_pair(6)
    obs = _obs(7)
    key = jax.random.PRNGKey(8)
    want = np.asarray(j_hier.select_goal(state, jnp.asarray(obs), key, cfg))
    goal = t_hier.select_goal(port, torch.from_numpy(obs), t_cfg,
                              gumbel_draws(key, N, cfg.num_goals))
    np.testing.assert_array_equal(goal.numpy(), want)
    j_out = jax.jit(lambda s, o, g: j_hier.get_action(s, o, g, cfg))(
        state, jnp.asarray(obs), jnp.asarray(want))
    t_out = t_hier.get_action(port, torch.from_numpy(obs), goal, t_cfg)
    for got, ref, what in zip(t_out, j_out, ("mean", "log_std", "value")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5,
                                   err_msg=what)


def test_update_high_level_matches_jax():
    cfg, state, t_cfg, port = _full_pair(9)
    j_update = jax.jit(lambda s, o, g, r: j_hier.update_high_level(s, o, g, r, cfg))
    rng = np.random.default_rng(10)
    for it in range(3):
        obs = _obs(11 + it)
        goal = rng.integers(0, cfg.num_goals, size=N).astype(np.int32)
        ret = (rng.normal(size=N) * 20.0).astype(np.float32)
        state, j_metrics = j_update(state, jnp.asarray(obs), jnp.asarray(goal), jnp.asarray(ret))
        port, metrics = t_hier.update_high_level(
            port, torch.from_numpy(obs), torch.from_numpy(goal), torch.from_numpy(ret), t_cfg)
    tree = np_tree(state)
    want = _dense_layers(tree.high_params)
    for name, p in port.high.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **STATE, err_msg=name)
    assert port.high_opt.count == int(tree.high_opt[0].count) == 3
    np.testing.assert_allclose(port.baseline.numpy(), np.asarray(tree.baseline), atol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
