"""The SAC learner of tvc_ai_torch against the JAX package (CPU).

``TwinQ``, the replay ring, the optimizer chain (global-norm clip, Adam, the
five LR schedules against optax) and ``sac.update``. The update runs from
one JAX ``SACState`` carried across with ``convert.sac_state_from_numpy``,
on the same batches, with the noise the JAX key chain draws
(``test_torch_parity_utils.update_draws``). Bars: TwinQ 1e-5; the replay
exact; the optimizers 1e-6; the update's parameters 1e-5 after 1 update and
after 10, its metrics 1e-4 relative.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity_utils import np_tree, sample_idx, to_torch, update_draws
from tvc_ai_torch.agents import optim as t_optim
from tvc_ai_torch.agents import replay as t_replay
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import critic_from_flax, sac_state_from_numpy
from tvc_ai_torch.models.mlp import TwinQ as TTwinQ
from tvc_ai_tpu.agents import replay as j_replay
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.models.mlp import TwinQ as JTwinQ

torch.set_num_threads(1)
OBS, ACT, HIDDEN, BATCH = 10, 2, (32, 32), 16
UPDATES = 10


def random_batch(rng: np.random.Generator, demo: bool = False) -> dict[str, np.ndarray]:
    f32 = np.float32
    batch = {
        "obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "action": rng.uniform(-1.0, 1.0, size=(BATCH, ACT)).astype(f32),
        "reward": (rng.normal(size=BATCH) * 30.0).astype(f32),
        "next_obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "done": (rng.uniform(size=BATCH) < 0.2).astype(f32),
    }
    if demo:
        batch["demo_mask"] = (np.arange(BATCH) >= BATCH // 2).astype(f32)
    return batch


def test_twinq_matches_flax():
    critic = JTwinQ(hidden_dims=HIDDEN)
    params = critic.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    ported = TTwinQ(OBS, ACT, HIDDEN, device="cpu")
    ported.load_state_dict(critic_from_flax(np_tree(params)))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, OBS)).astype(np.float32)
    act = rng.uniform(-1.0, 1.0, size=(64, ACT)).astype(np.float32)
    j_q1, j_q2 = critic.apply(params, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        q1, q2 = ported(torch.from_numpy(obs), torch.from_numpy(act))
    assert q1.shape == (64,) and q2.shape == (64,)
    np.testing.assert_allclose(q1.numpy(), np.asarray(j_q1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(q2.numpy(), np.asarray(j_q2), atol=1e-5, rtol=1e-5)
    # seeded orthogonal √2 init, zero biases, two distinct networks
    again = TTwinQ(OBS, ACT, HIDDEN, device="cpu", seed=0)
    w = again.q1.hidden_1.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(32), atol=1e-4)
    assert not torch.equal(again.q1.hidden_1.weight, again.q2.hidden_1.weight)
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in again.named_parameters()
               if n.endswith("bias"))


def test_replay_ring_wraps_like_jax():
    """Six batches of 16 into a 64-row ring: rows, ptr and size after each
    write, then ``sample`` at given rows, all exact."""
    rng = np.random.default_rng(1)
    example = {"obs": np.zeros(OBS, np.float32), "done": np.zeros((), np.float32)}
    j_buf = j_replay.ReplayBuffer.create(64, {k: jnp.asarray(v) for k, v in example.items()})
    t_buf = t_replay.ReplayBuffer.create(64, {k: torch.from_numpy(v) for k, v in example.items()},
                                         device="cpu")
    for _ in range(6):
        batch = {"obs": rng.normal(size=(16, OBS)).astype(np.float32),
                 "done": (rng.uniform(size=16) < 0.5).astype(np.float32)}
        j_buf = j_replay.add_batch(j_buf, {k: jnp.asarray(v) for k, v in batch.items()})
        t_buf = t_replay.add_batch(t_buf, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert (t_buf.ptr, t_buf.size) == (int(j_buf.ptr), int(j_buf.size))
        for k in example:
            np.testing.assert_array_equal(t_buf.data[k].numpy(), np.asarray(j_buf.data[k]))
    assert (t_buf.ptr, t_buf.size) == (32, 64)  # wrapped once
    key = jax.random.PRNGKey(5)
    j_rows = j_replay.sample(j_buf, key, BATCH)
    t_rows = t_replay.sample(t_buf, BATCH, idx=sample_idx(key, BATCH, t_buf.size))
    for k in example:
        np.testing.assert_array_equal(t_rows[k].numpy(), np.asarray(j_rows[k]))
    drawn = t_replay.sample(t_buf, BATCH, generator=torch.Generator().manual_seed(0))
    assert drawn["obs"].shape == (BATCH, OBS)
    with pytest.raises(ValueError, match="multiple"):
        t_replay.add_batch(t_buf, {"obs": torch.zeros(24, OBS), "done": torch.zeros(24)})


def _grads(seed: int, scale: float) -> tuple[list[np.ndarray], dict]:
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((5, 3), (3,), (7,))]
    return leaves, {"a": jnp.asarray(leaves[0]), "b": jnp.asarray(leaves[1]),
                    "c": jnp.asarray(leaves[2])}


@pytest.mark.parametrize("scale", [0.1, 3.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    leaves, tree = _grads(2, scale)
    max_norm = 5.0
    norm = float(optax.global_norm(tree))
    assert (norm < max_norm) == (scale < 1.0)
    ref, _ = optax.clip_by_global_norm(max_norm).update(tree, optax.EmptyState())
    out = t_optim.clip_by_global_norm([torch.from_numpy(x) for x in leaves], max_norm)
    for o, r in zip(out, (ref["a"], ref["b"], ref["c"])):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)
    if scale < 1.0:  # below the threshold the gradient passes unchanged
        assert all(torch.equal(o, torch.from_numpy(x)) for o, x in zip(out, leaves))


def _optax_schedule(name: str, lr: float, cfg: j_sac.SACConfig):
    return {
        "constant": lr,
        "linear": optax.linear_schedule(lr, 0.0, cfg.schedule_total_steps),
        "exponential": optax.exponential_decay(
            lr, max(cfg.schedule_total_steps // 10, 1), 0.5, staircase=True),
        "cosine": optax.cosine_decay_schedule(lr, cfg.schedule_total_steps),
        "warmup_cosine": optax.warmup_cosine_decay_schedule(
            init_value=lr * cfg.initial_lr_factor, peak_value=lr, warmup_steps=cfg.warmup_steps,
            decay_steps=max(cfg.schedule_total_steps, cfg.warmup_steps + 1)),
    }[name]


@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_cosine_decay_matches_optax(alpha):
    """``cosine_decay`` with its floor (``alpha``; the distillation CLIs'
    ``--lr_cosine`` uses 0.1) against optax's schedule across its range."""
    lr, steps = 3e-2, 40
    ref = optax.cosine_decay_schedule(lr, steps, alpha=alpha)
    sched = t_optim.cosine_decay(lr, steps, alpha=alpha)
    for count in (0, 1, 3, 7, 20, 39, 40, 41, 100):
        assert sched(count) == pytest.approx(float(ref(jnp.int32(count))), rel=1e-6, abs=1e-12), count

@pytest.mark.parametrize("name", t_optim.SCHEDULES)
def test_schedule_and_clipped_adam_match_optax(name):
    """Each schedule's value at counts across its range, then six steps of
    ``chain(clip_by_global_norm, adam(schedule))`` on the same gradients."""
    cfg = j_sac.SACConfig(lr_schedule=name, schedule_total_steps=40, warmup_steps=8,
                          gradient_clip_norm=5.0)
    lr, max_norm = 3e-2, cfg.gradient_clip_norm
    ref_sched = _optax_schedule(name, lr, cfg)
    sched = t_optim.make_schedule(name, lr, cfg.schedule_total_steps, cfg.warmup_steps,
                                  cfg.initial_lr_factor)
    for count in (0, 1, 3, 7, 8, 9, 20, 39, 40, 41, 100):
        want = float(ref_sched(jnp.int32(count))) if callable(ref_sched) else ref_sched
        assert sched(count) == pytest.approx(want, rel=1e-6, abs=1e-12), count

    opt = j_sac._optim(lr, cfg)  # the reference's own chain
    leaves, params = _grads(3, 1.0)
    j_state = opt.init(params)
    t_params = [torch.from_numpy(x.copy()) for x in leaves]
    t_state = t_optim.adam_init(t_params)
    for step in range(6):
        g_leaves, grads = _grads(10 + step, 4.0 if step % 2 else 0.5)
        updates, j_state = opt.update(grads, j_state, params)
        params = optax.apply_updates(params, updates)
        clipped = t_optim.clip_by_global_norm([torch.from_numpy(g) for g in g_leaves], max_norm)
        t_optim.adam_step(t_params, clipped, t_state, sched(t_state.count))
    assert t_state.count == int(j_state[1][0].count) == 6
    for t, k in zip(t_params, "abc"):
        np.testing.assert_allclose(t.numpy(), np.asarray(params[k]), atol=1e-6, rtol=1e-6)
    for t, k in zip(t_state.nu, "abc"):
        np.testing.assert_allclose(t.numpy(), np.asarray(j_state[1][0].nu[k]), rtol=1e-6)


def test_adam_matches_optax():
    """The temperature's optimizer: plain Adam on a scalar, five steps."""
    opt = optax.adam(3e-4)
    la = jnp.float32(np.log(0.2))
    j_state = opt.init(la)
    t_la = torch.tensor(float(la))
    t_state = t_optim.adam_init([t_la])
    for g in (0.3, -1.2, 1e-3, 0.0, 5.0):
        upd, j_state = opt.update(jnp.float32(g), j_state, la)
        la = optax.apply_updates(la, upd)
        t_optim.adam_step([t_la], [torch.tensor(g)], t_state, 3e-4)
    np.testing.assert_allclose(t_la.numpy(), np.asarray(la), atol=1e-6, rtol=1e-6)


UPDATE_CASES = {
    "default": dict(),
    "fixed_alpha": dict(automatic_entropy_tuning=False, alpha=0.1),
    "adaptive_tau": dict(adaptive_tau=True),
    "ema": dict(ema_decay=0.9),
    "bc": dict(bc_weight=2.0),
    "warmup_cosine": dict(lr_schedule="warmup_cosine", schedule_total_steps=20, warmup_steps=4),
}


def _assert_params_close(port: t_sac.SACState, ref: t_sac.SACState, what: str) -> None:
    """Every parameter within 1e-5; a failure names the element and its
    gradient (the bias-corrected first moment, as each side holds it)."""
    pairs = [("actor", port.actor, ref.actor, port.actor_opt, ref.actor_opt),
             ("critic", port.critic, ref.critic, port.critic_opt, ref.critic_opt),
             ("target_critic", port.target_critic, ref.target_critic, None, None)]
    if ref.ema_actor is not None:
        pairs.append(("ema_actor", port.ema_actor, ref.ema_actor, None, None))
    for net, a, b, a_opt, b_opt in pairs:
        for i, ((name, p), q) in enumerate(zip(a.named_parameters(), b.parameters())):
            err = (p.detach() - q.detach()).abs()
            if float(err.max()) <= 1e-5:
                continue
            j = int(err.argmax())
            msg = f"{what}: {net}.{name}[{j}] port {p.flatten()[j]:.8g} jax {q.flatten()[j]:.8g}"
            if a_opt is not None:
                bc = 1.0 - t_optim.B1 ** a_opt.count
                msg += (f"; gradient (mu / (1 - b1^t)) port {a_opt.mu[i].flatten()[j] / bc:.6g} "
                        f"jax {b_opt.mu[i].flatten()[j] / bc:.6g}")
            raise AssertionError(msg)
    np.testing.assert_allclose(port.log_alpha.numpy(), ref.log_alpha.numpy(), atol=1e-5,
                               err_msg=f"{what}: log_alpha")
    assert port.step == ref.step


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    kwargs = dict(hidden_dims=HIDDEN, batch_size=BATCH, gradient_clip_norm=5.0,
                  reward_scale=0.05, **UPDATE_CASES[case])
    j_cfg, t_cfg = j_sac.SACConfig(**kwargs), t_sac.SACConfig(**kwargs)
    j_state = j_sac.init(jax.random.PRNGKey(4), OBS, ACT, j_cfg)
    port = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    j_update = jax.jit(lambda s, b, k: j_sac.update(s, b, k, j_cfg, OBS, ACT))
    rng = np.random.default_rng(6)
    for i in range(UPDATES):
        batch = random_batch(rng, demo=case == "bc")
        key = jax.random.PRNGKey(100 + i)
        j_state, j_metrics = j_update(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        port, metrics = t_sac.update(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     t_cfg, update_draws(key, BATCH, ACT))
        if i in (0, UPDATES - 1):
            what = f"{case} after {i + 1} update(s)"
            ref = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
            _assert_params_close(port, ref, what)
            assert sorted(metrics) == sorted(j_metrics), what
            for k, v in metrics.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{what}: {k}")
    assert port.critic_opt.count == port.actor_opt.count == UPDATES
    if case == "bc":
        assert float(metrics["bc_loss"]) > 0.0


def test_update_draws_from_generator_and_views():
    cfg = t_sac.SACConfig(hidden_dims=(8, 8), batch_size=BATCH, ema_decay=0.5)
    state = t_sac.init(OBS, ACT, cfg, device="cpu", seed=3)
    before = state.actor.mean_head.weight.detach().clone()
    batch = {k: torch.from_numpy(v) for k, v in random_batch(np.random.default_rng(7)).items()}
    state, metrics = t_sac.update(state, batch, cfg, generator=torch.Generator().manual_seed(1))
    assert state.step == 1 and not torch.equal(before, state.actor.mean_head.weight)
    assert all(v.shape == () and torch.isfinite(v) for v in metrics.values())
    assert all(p.grad is None for p in state.actor.parameters())  # autograd.grad only
    assert t_sac.eval_actor_view(state, cfg).actor is state.ema_actor
    plain = dataclasses.replace(cfg, ema_decay=0.0)
    assert t_sac.eval_actor_view(state, plain).actor is state.actor
    for step in (0, 1, 500, 5000):
        j_cfg = j_sac.SACConfig(adaptive_tau=True)
        want = float(j_sac.effective_tau(j_cfg, jnp.int32(step)))
        assert t_sac.effective_tau(t_sac.SACConfig(adaptive_tau=True), step) == want
    assert t_sac.effective_tau(cfg, 7) == pytest.approx(0.005)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        t_sac.SACConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="lr_schedule"):
        t_sac.SACConfig(lr_schedule="step")
    cfg = t_sac.SACConfig(hidden_dims=(8, 8), batch_size=BATCH)
    state = t_sac.init(OBS, ACT, cfg, device="cpu")
    batch = {k: to_torch(v) for k, v in random_batch(np.random.default_rng(8)).items()}
    # data parallel needs a process group (tests/test_torch_parallel.py has one)
    with pytest.raises(RuntimeError, match="process group"):
        t_sac.update(state, batch, cfg, axis_name="data")
