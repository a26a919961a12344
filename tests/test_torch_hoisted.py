"""The hoisted-bookkeeping chunk path of the fused SAC iteration
(``TrainLoopConfig.hoist_bookkeeping``) against the JAX package (CPU) and
against the port's own per-step cadence.

JAX against the port: one JAX ``TrainCarry`` is carried across with
``convert.train_carry_from_numpy``; the JAX hoisted iteration (12 steps of 8
envs) runs under ``jit`` with the env keys recorded around
``batched_step_autoreset``, and the port's hoisted iteration runs on the same
draws, the reference's hoisted key layout replayed by
``test_torch_parity_utils.hoisted_iteration_draws``. Episodes last at most 3
steps, so they span chunks, and a chunk finishes more envs than the 4-slot
ring holds. Cases: K = 4 with the learning gate opening at the second chunk
and the replay wrapping at the third; K = 2 with ``history_len`` 2; K = 2
with a demo-mixed batch (Q-filtered BC, 2 updates an event). Bars: the
loop's (obs 5e-5 / 5e-4, reward and returns 1e-3, flags and counts exact,
SAC parameters 1e-5, metrics 1e-3 relative).

The port against itself: the hoisted iteration equals the per-step cadence
(``update_interval`` K, not hoisted) on the same draws with learning on, and
the per-step path (K = 1) with a deterministic ``act_fn`` and the updates
gated off (the counterpart of ``tests/test_loop.py::
test_hoisted_chunk_parity_with_per_step_path``), at ``np.allclose(atol=1e-6)``
(rtol 1e-5, as the reference's test): the chunk's cumulative sums reorder the
float adds of the returns.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    KeyChain,
    assert_state_close,
    hoisted_iteration_draws,
    np_tree,
    recording_batched_keys,
)
from test_torch_train_loop import DEMO_ROWS, demo_buffer
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import env_params_from_numpy, sac_state_from_numpy, train_carry_from_numpy
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.training import loop as j_loop

torch.set_num_threads(1)
N, STEPS, RING = 8, 12, 4
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
SAME = dict(atol=1e-6)   # np.allclose's rtol 1e-5 stays
SAC = dict(hidden_dims=(16, 16), batch_size=16, buffer_size=64, learning_starts=48,
           gradient_clip_norm=5.0, reward_scale=0.05)
LOOP = dict(num_envs=N, rollout_steps=STEPS, use_safety_layer=True, episode_ring_size=RING,
            hoist_bookkeeping=True)
JAX_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
    max_episode_steps=3,
)
CASES = {
    "k4_gate_wrap_ring": (dict(update_interval=4), dict()),
    "k2_history2": (dict(update_interval=2, history_len=2), dict()),
    "k2_demo_bc": (dict(update_interval=2, updates_per_step=2, demo_fraction=0.25),
                   dict(bc_weight=1.0)),
}
CARRY_FIELDS = ("episodes", "successes", "ep_return", "ep_length", "return_sum", "length_sum",
                "ep_ring_return", "ep_ring_length", "ep_ring_success", "ep_ring_seq",
                "ep_ring_ptr", "env_steps")


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    loop_kw, sac_kw = CASES[request.param]
    j_sac_cfg, t_sac_cfg = j_sac.SACConfig(**SAC, **sac_kw), t_sac.SACConfig(**SAC, **sac_kw)
    j_loop_cfg = j_loop.TrainLoopConfig(**LOOP, **loop_kw)
    t_loop_cfg = t_loop.TrainLoopConfig(**LOOP, **loop_kw)
    carry0 = jax.jit(lambda k: j_loop.init_carry(k, JAX_PARAMS, j_sac_cfg, j_loop_cfg))(
        jax.random.PRNGKey(7))
    if j_loop_cfg.demo_fraction > 0:
        carry0 = carry0.replace(demo_buffer=demo_buffer(j_loop_cfg))
    t_carry0 = train_carry_from_numpy(np_tree(carry0), t_sac_cfg, t_loop_cfg, device="cpu")
    with recording_batched_keys() as keys:
        j_it = j_loop.make_train_iteration(j_sac_cfg, j_loop_cfg)
        assert j_it.hoisted
        j_carry, j_metrics = jax.jit(j_it)(carry0, JAX_PARAMS)
        jax.effects_barrier()
    assert len(keys) == STEPS
    size0, cap = int(carry0.buffer.size), int(carry0.buffer.capacity)
    sizes = [min(size0 + (t + 1) * N, cap) for t in range(STEPS)]
    draws = hoisted_iteration_draws(KeyChain(JAX_PARAMS), carry0.key, keys, sizes, t_sac_cfg,
                                    t_loop_cfg, demo_size=DEMO_ROWS)
    t_it = t_loop.make_train_iteration(t_sac_cfg, t_loop_cfg)
    assert t_it.hoisted
    t_carry, t_metrics = t_it(t_carry0, env_params_from_numpy(JAX_PARAMS), draws)
    return dict(case=request.param, j=j_carry, jm=j_metrics, t=t_carry, tm=t_metrics,
                t_cfg=t_sac_cfg, t_loop=t_loop_cfg, sizes=sizes)


def test_hoisted_env_state_and_obs_match_jax(run):
    t, j = run["t"], run["j"]
    assert_state_close(t.env_states, j.env_states, what=run["case"])
    np.testing.assert_allclose(t.obs.numpy(), np.asarray(j.obs), **OBS)
    if run["t_loop"].history_len > 1:
        np.testing.assert_allclose(t.obs_window.numpy(), np.asarray(j.obs_window), **OBS)


def test_hoisted_replay_rows_match_jax(run):
    t, j = run["t"].buffer, run["j"].buffer
    assert (t.ptr, t.size, t.capacity) == (int(j.ptr), int(j.size), j.capacity)
    assert t.ptr == (STEPS * N) % t.capacity != 0   # the block write wrapped
    for k in ("obs", "next_obs", "action"):
        np.testing.assert_allclose(t.data[k].numpy(), np.asarray(j.data[k]), **OBS, err_msg=k)
    np.testing.assert_allclose(t.data["reward"].numpy(), np.asarray(j.data["reward"]), **REWARD)
    np.testing.assert_array_equal(t.data["done"].numpy(), np.asarray(j.data["done"]))


def test_hoisted_counters_and_ring_match_jax(run):
    t, j = run["t"], np_tree(run["j"])
    for name in ("env_steps", "episodes", "successes", "ep_length", "ep_ring_length",
                 "ep_ring_success", "ep_ring_seq", "ep_ring_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)
        assert getattr(t, name).numpy().dtype == getattr(j, name).dtype, name
    for name in ("ep_return", "return_sum", "length_sum", "ep_ring_return"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name), **REWARD,
                                   err_msg=name)
    assert t.env_steps_host == STEPS
    # the 3-step episodes: every env finished at least 4 in 12 steps, more
    # than the ring holds in all
    assert int(t.episodes.min()) >= STEPS // 3 and int(t.episodes.sum()) > RING


def test_hoisted_params_and_metrics_match_jax(run):
    t, cfg, loop_cfg = run["t"], run["t_cfg"], run["t_loop"]
    ref = sac_state_from_numpy(np_tree(run["j"].agent), cfg, t_loop.policy_obs_dim(loop_cfg),
                               2, device="cpu")
    for net in ("actor", "critic", "target_critic"):
        for (name, p), q in zip(getattr(t.agent, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-5,
                                       err_msg=f"{net}.{name}")
    np.testing.assert_allclose(t.agent.log_alpha.numpy(), ref.log_alpha.numpy(), atol=1e-5)
    k = loop_cfg.update_interval
    events = sum(1 for s, size in enumerate(run["sizes"])
                 if s % k == k - 1 and size >= cfg.learning_starts)
    assert t.agent.step == ref.step == loop_cfg.updates_per_step * events
    assert 0 < events < STEPS // k   # the gate opened mid-way
    assert sorted(run["tm"]) == sorted(run["jm"])
    for name, v in run["tm"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(run["jm"][name]), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_hoisted_drain_and_summarize_match_jax(run):
    t, j = run["t"], run["j"]
    t_eps, t_last = t_loop.drain_episodes(t, -1)
    j_eps, j_last = j_loop.drain_episodes(j, -1)
    assert t_last == j_last and len(t_eps) == len(j_eps) == RING
    for (tr, tl, ts), (jr, jl, js) in zip(t_eps, j_eps):
        assert (tl, ts) == (jl, js)
        assert tr == pytest.approx(jr, rel=1e-3, abs=1e-3)
    t_sum, j_sum = t_loop.summarize(t), j_loop.summarize(j)
    assert sorted(t_sum) == sorted(j_sum)
    for name, v in j_sum.items():
        assert t_sum[name] == pytest.approx(v, rel=1e-3), name


# ---------------------------------------------------------------- the port against itself
PORT_SAC = dict(hidden_dims=(16, 16), batch_size=16, buffer_size=64, learning_starts=40)
PORT_LOOP = dict(num_envs=N, rollout_steps=16, use_safety_layer=True, episode_ring_size=RING)
PORT_CASES = {
    "k4": dict(update_interval=4),
    "k4_history3": dict(update_interval=4, history_len=3),
    "k2_two_updates": dict(update_interval=2, updates_per_step=2),
}


def _generator_draws(loop_cfg: t_loop.TrainLoopConfig, sac_cfg: t_sac.SACConfig,
                     seed: int) -> list[t_loop.IterDraws]:
    """Explicit draws for every step (every step's ``SampleDraws`` given, so
    either path reads what its learning steps need), from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    n, a, b = loop_cfg.num_envs, loop_cfg.action_dim, sac_cfg.batch_size
    out = []
    for t in range(loop_cfg.rollout_steps):
        size = min((t + 1) * n, sac_cfg.buffer_size)
        samples = [t_loop.SampleDraws(
            idx=torch.randint(0, size, (b,), generator=gen),
            update=t_sac.UpdateDraws(n_next=torch.randn(b, a, generator=gen),
                                     n_pi=torch.randn(b, a, generator=gen)))
            for _ in range(loop_cfg.updates_per_step)]
        out.append(t_loop.IterDraws(step=t_loop.StepDraws(n_act=torch.randn(n, a, generator=gen)),
                                    samples=samples))
    return out


def _run_port(sac_cfg, loop_cfg, params, draws=None, act_fn=None, seed=3):
    carry = t_loop.init_carry(params, sac_cfg, loop_cfg, device="cpu", seed=seed)
    it = t_loop.make_train_iteration(sac_cfg, loop_cfg, act_fn=act_fn)
    carry, metrics = it(carry, params, draws)
    return it, carry, metrics


def _assert_same(a: t_loop.TrainCarry, b: t_loop.TrainCarry, ma: dict, mb: dict,
                 names: tuple[str, ...]) -> None:
    assert np.allclose(a.obs.numpy(), b.obs.numpy(), **SAME)
    for x, y in zip((a.env_states.body.pos, a.env_states.body.quat, a.env_states.body.vel,
                     a.env_states.body.omega),
                    (b.env_states.body.pos, b.env_states.body.quat, b.env_states.body.vel,
                     b.env_states.body.omega)):
        assert np.allclose(x.numpy(), y.numpy(), **SAME)
    assert (a.buffer.size, a.buffer.ptr) == (b.buffer.size, b.buffer.ptr)
    for k in a.buffer.data:
        assert np.allclose(a.buffer.data[k].numpy(), b.buffer.data[k].numpy(), **SAME), k
    for name in CARRY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.allclose(x.numpy(), y.numpy(), **SAME), name
    assert a.env_steps_host == b.env_steps_host
    for name in names:
        assert np.allclose(ma[name].numpy(), mb[name].numpy(), **SAME), name


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_hoisted_equals_per_step_cadence_on_same_draws(case):
    """Learning on: the same rows, updates, counters, ring and metrics."""
    params = env_params_from_numpy(JAX_PARAMS)
    sac_cfg = t_sac.SACConfig(**PORT_SAC)
    hoisted = t_loop.TrainLoopConfig(**PORT_LOOP, **PORT_CASES[case], hoist_bookkeeping=True)
    cadence = dataclasses.replace(hoisted, hoist_bookkeeping=None)
    draws = _generator_draws(hoisted, sac_cfg, seed=5)
    it_h, h, mh = _run_port(sac_cfg, hoisted, params, draws)
    it_c, c, mc = _run_port(sac_cfg, cadence, params, draws)
    assert it_h.hoisted and not it_c.hoisted
    _assert_same(h, c, mh, mc, tuple(mc))
    assert sorted(mh) == sorted(mc)
    assert h.agent.step == c.agent.step > 0
    for net in ("actor", "critic", "target_critic"):
        for p, q in zip(getattr(h.agent, net).parameters(), getattr(c.agent, net).parameters()):
            assert np.allclose(p.detach().numpy(), q.detach().numpy(), **SAME), net
    assert int(h.episodes.sum()) > RING


def test_hoisted_equals_per_step_path_with_fixed_actions():
    """The counterpart of the reference's test: a constant action and no
    update, K = 4 hoisted against K = 1 per step, the env draws from the
    carries' generators (the same seed; an act_fn draws nothing)."""
    params = env_params_from_numpy(EnvParams())
    sac_cfg = t_sac.SACConfig(hidden_dims=(16, 16), buffer_size=8 * 8 * 4,
                              learning_starts=10**9, batch_size=16)
    base = t_loop.TrainLoopConfig(num_envs=8, rollout_steps=8, updates_per_step=1,
                                  episode_ring_size=16)

    def det_act(agent, obs, n_act, generator):
        return torch.tensor([[0.3, -0.1]]).expand(obs.shape[0], 2)

    it4, c4, m4 = _run_port(sac_cfg, dataclasses.replace(base, update_interval=4,
                                                         hoist_bookkeeping=True),
                            params, act_fn=det_act)
    it1, c1, m1 = _run_port(sac_cfg, dataclasses.replace(base, update_interval=1), params,
                            act_fn=det_act)
    assert it4.hoisted and not it1.hoisted
    _assert_same(c4, c1, m4, m1, ("reward_mean", "done_frac"))
    assert c4.buffer.size == c1.buffer.size == 8 * 8
    assert c4.agent.step == c1.agent.step == 0


GATE = {
    "k1": (dict(update_interval=1), dict()),
    "curiosity": (dict(use_curiosity=True), dict()),
    "rnd": (dict(use_rnd=True), dict()),
    "hierarchical": (dict(use_hierarchical=True), dict()),
    "buffer_not_whole_chunks": (dict(), dict(buffer_size=80)),   # 80 % (4 * 8) != 0
}


@pytest.mark.parametrize("name", sorted(GATE))
def test_hoisting_gate_raises_the_reference_error(name):
    loop_kw, sac_kw = GATE[name]
    kw = dict(num_envs=N, rollout_steps=8, update_interval=4, hoist_bookkeeping=True)
    sac_base = dict(hidden_dims=(8, 8), batch_size=8, buffer_size=64)
    j_loop_cfg = j_loop.TrainLoopConfig(**{**kw, **loop_kw})
    t_loop_cfg = t_loop.TrainLoopConfig(**{**kw, **loop_kw})
    j_sac_cfg = j_sac.SACConfig(**{**sac_base, **sac_kw})
    t_sac_cfg = t_sac.SACConfig(**{**sac_base, **sac_kw})
    with pytest.raises(ValueError) as j_err:
        j_loop.make_train_iteration(j_sac_cfg, j_loop_cfg)
    with pytest.raises(ValueError) as t_err:
        t_loop.make_train_iteration(t_sac_cfg, t_loop_cfg)
    assert str(t_err.value) == str(j_err.value)
    # None and False keep the per-step paths
    for off in (None, False):
        for mod, s_cfg, l_cfg in ((j_loop, j_sac_cfg, j_loop_cfg), (t_loop, t_sac_cfg, t_loop_cfg)):
            assert not mod.make_train_iteration(
                s_cfg, dataclasses.replace(l_cfg, hoist_bookkeeping=off)).hoisted
