"""TD3 of tvc_ai_torch against the JAX package (CPU).

``DeterministicActor`` and ``select_action`` against flax, and ``td3.update``
from one JAX ``TD3State`` carried across with ``convert.td3_state_from_numpy``,
on the same batches, with the target-smoothing noise the JAX key draws.
Bars: the actor and actions 1e-5; the update's parameters 1e-5 after 1 and
after 10 updates, its metrics 1e-4 relative; the delay exact (the actor and
both targets move only on every ``policy_delay``-th update).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree, to_torch
from tvc_ai_torch.agents import td3 as t_td3
from tvc_ai_torch.convert import deterministic_actor_from_flax, td3_state_from_numpy
from tvc_ai_torch.models.mlp import DeterministicActor as TActor
from tvc_ai_tpu.agents import td3 as j_td3
from tvc_ai_tpu.models.mlp import DeterministicActor as JActor

torch.set_num_threads(1)
OBS, ACT, HIDDEN, BATCH = 10, 2, (32, 32), 16
UPDATES = 10
TOL = dict(atol=1e-5, rtol=1e-5)


def random_batch(rng: np.random.Generator) -> dict[str, np.ndarray]:
    f32 = np.float32
    return {
        "obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "action": rng.uniform(-1.0, 1.0, size=(BATCH, ACT)).astype(f32),
        "reward": (rng.normal(size=BATCH) * 3.0).astype(f32),
        "next_obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "done": (rng.uniform(size=BATCH) < 0.2).astype(f32),
    }


def test_deterministic_actor_matches_flax():
    actor = JActor(action_dim=ACT, hidden_dims=HIDDEN)
    params = actor.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    ported = TActor(OBS, ACT, HIDDEN, device="cpu")
    ported.load_state_dict(deterministic_actor_from_flax(np_tree(params)))
    obs = np.random.default_rng(0).normal(size=(64, OBS)).astype(np.float32) * 3.0
    with torch.no_grad():
        out = ported(torch.from_numpy(obs))
    np.testing.assert_allclose(out.numpy(), np.asarray(actor.apply(params, jnp.asarray(obs))),
                               **TOL)
    assert [n for n, _ in ported.named_parameters()] == [
        "hidden_0.weight", "hidden_0.bias", "hidden_1.weight", "hidden_1.bias",
        "action_head.weight", "action_head.bias"]
    # seeded orthogonal √2 init, zero biases
    again = TActor(OBS, ACT, HIDDEN, device="cpu", seed=5)
    w = again.hidden_1.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(32), atol=1e-4)
    assert torch.equal(w, TActor(OBS, ACT, HIDDEN, device="cpu", seed=5).hidden_1.weight)
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in again.named_parameters()
               if n.endswith("bias"))


@pytest.mark.parametrize("deterministic", [False, True], ids=["noisy", "deterministic"])
def test_select_action_bounds_and_noise(deterministic):
    cfg_j, cfg_t = j_td3.TD3Config(hidden_dims=HIDDEN), t_td3.TD3Config(hidden_dims=HIDDEN)
    j_state = j_td3.init(jax.random.PRNGKey(1), OBS, ACT, cfg_j)
    port = td3_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT, device="cpu")
    obs = np.random.default_rng(1).normal(size=(256, OBS)).astype(np.float32) * 4.0
    key = jax.random.PRNGKey(3)
    ref = j_td3.select_action(j_state, jnp.asarray(obs), key, cfg_j, ACT, deterministic)
    n_act = to_torch(jax.random.normal(key, (256, ACT)))
    out = t_td3.select_action(port.actor, torch.from_numpy(obs), cfg_t, n_act, deterministic)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(out.abs().max()) <= 1.0
    det = t_td3.select_action(port.actor, torch.from_numpy(obs), cfg_t, deterministic=True)
    drawn = t_td3.select_action(port.actor, torch.from_numpy(obs), cfg_t,
                                generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(det, drawn)
    # the exploration noise is exploration_noise × a standard normal, clipped
    inside = (det.abs() < 0.5).all(dim=-1)
    spread = ((drawn - det)[inside] / cfg_t.exploration_noise).std()
    assert 0.8 < float(spread) < 1.2


def _assert_state_close(port: t_td3.TD3State, ref: t_td3.TD3State, what: str) -> None:
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for (name, p), q in zip(getattr(port, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **TOL,
                                       err_msg=f"{what}: {net}.{name}")
    for opt in ("actor_opt", "critic_opt"):
        a, b = getattr(port, opt), getattr(ref, opt)
        assert a.count == b.count, (what, opt)
        for x, y in zip(a.nu, b.nu):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-12,
                                       err_msg=f"{what}: {opt}.nu")
    assert port.step == ref.step


@pytest.mark.parametrize("delay", [2, 3], ids=["delay2", "delay3"])
def test_update_matches_jax(delay):
    kwargs = dict(hidden_dims=HIDDEN, batch_size=BATCH, policy_delay=delay)
    j_cfg, t_cfg = j_td3.TD3Config(**kwargs), t_td3.TD3Config(**kwargs)
    j_state = j_td3.init(jax.random.PRNGKey(4), OBS, ACT, j_cfg)
    port = td3_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    j_update = jax.jit(lambda s, b, k: j_td3.update(s, b, k, j_cfg, OBS, ACT))
    rng = np.random.default_rng(6)
    moved = []
    for i in range(UPDATES):
        batch = random_batch(rng)
        key = jax.random.PRNGKey(100 + i)
        j_state, j_metrics = j_update(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        before = {net: [p.detach().clone() for p in getattr(port, net).parameters()]
                  for net in ("actor", "target_actor", "target_critic")}
        port, metrics = t_td3.update(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     t_cfg, to_torch(jax.random.normal(key, (BATCH, ACT))))
        moved.append({net: any(not torch.equal(a, b) for a, b in zip(
            old, getattr(port, net).parameters())) for net, old in before.items()})
        if i in (0, UPDATES - 1):
            what = f"delay {delay} after {i + 1} update(s)"
            _assert_state_close(port, td3_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT,
                                                           device="cpu"), what)
            assert sorted(metrics) == sorted(j_metrics) == ["actor_loss", "critic_loss"]
            for k, v in metrics.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{what}: {k}")
    # the delay: the actor and both targets move on every delay-th update only
    for i, m in enumerate(moved):
        due = (i + 1) % delay == 0
        assert m == {"actor": due, "target_actor": due, "target_critic": due}, (i, m)
    assert port.critic_opt.count == UPDATES and port.actor_opt.count == UPDATES // delay
    assert port.step == UPDATES


def test_update_draws_from_generator_and_options():
    cfg = t_td3.TD3Config(hidden_dims=(8, 8), batch_size=BATCH)
    state = t_td3.init(OBS, ACT, cfg, device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in random_batch(np.random.default_rng(7)).items()}
    for _ in range(2):
        state, metrics = t_td3.update(state, batch, cfg,
                                      generator=torch.Generator().manual_seed(1))
    assert state.step == 2 and all(torch.isfinite(v) and v.shape == () for v in metrics.values())
    assert all(p.grad is None for p in state.actor.parameters())  # autograd.grad only
    assert not any(p.requires_grad for p in state.target_actor.parameters())
    # data parallel needs a process group (tests/test_torch_parallel.py has one)
    with pytest.raises(RuntimeError, match="process group"):
        t_td3.update(state, batch, cfg, axis_name="data")
