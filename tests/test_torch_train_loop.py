"""The fused train iteration of tvc_ai_torch against the JAX package (CPU).

One JAX ``TrainCarry`` (``init_carry``) is carried across with
``convert.train_carry_from_numpy``; the JAX ``make_train_iteration`` runs one
iteration of 8 steps under ``jit`` on the CPU with its auto physics choice
(the XLA path, as ``tests/test_loop.py`` runs it), and the port runs one
iteration of 8 steps on the same draws: the env keys are recorded as the JAX
iteration runs (a debug callback wrapped around ``batched_step_autoreset``;
the computation is unchanged) and the carry's key chain is replayed by
``test_torch_parity_utils.iteration_draws``. The port runs free.

Cases: ``update_interval`` 1 with the ``learning_starts`` gate opening at
the third step, the replay wrapping at the seventh, and a truncation wave
finishing more envs in one step than the 8-slot episode ring holds;
``update_interval`` 2 with 2 updates per event and a demo-mixed batch
(Q-filtered BC on); ``history_len`` 2; and the first case's shape with
every robust-training env option on (feasible-only draws, the mixture,
sensor noise and dropout, actuator delay, the survival payout and
equilibrium shaping). Bars: obs 5e-5 / 5e-4, reward and
returns 1e-3, flags and counts exact, parameters 1e-4, metrics 1e-3
relative.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    EVERY_OPTION,
    KeyChain,
    assert_state_close,
    iteration_draws,
    np_tree,
    option_params,
)
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import env_params_from_numpy, sac_state_from_numpy, train_carry_from_numpy
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_tpu.agents import replay as j_replay
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.training import loop as j_loop

torch.set_num_threads(1)
N, STEPS, RING, DEMO_ROWS = 16, 8, 8, 32
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
SAC = dict(hidden_dims=(32, 32), batch_size=16, buffer_size=96, learning_starts=48,
           gradient_clip_norm=5.0, reward_scale=0.05)
LOOP = dict(num_envs=N, rollout_steps=STEPS, use_safety_layer=True, episode_ring_size=RING)
JAX_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
    max_episode_steps=4,
)
# every option with the loop's 10-wide observation (no drift channels)
ROBUST_PARAMS = option_params({k: v for k, v in EVERY_OPTION.items() if k != "drift_obs_enabled"},
                              max_episode_steps=4)
CASES = {
    "k1_gate_wrap_ring": (dict(), dict(), JAX_PARAMS),
    "k2_demo_bc": (dict(update_interval=2, updates_per_step=2, demo_fraction=0.25),
                   dict(bc_weight=1.0), JAX_PARAMS),
    "history2": (dict(history_len=2), dict(), JAX_PARAMS),
    "robust_options": (dict(), dict(), ROBUST_PARAMS),
}


def demo_buffer(loop_cfg: j_loop.TrainLoopConfig) -> j_replay.ReplayBuffer:
    rng = np.random.default_rng(11)
    dim = j_loop.policy_obs_dim(loop_cfg)
    shapes = {"obs": (dim,), "action": (2,), "reward": (), "next_obs": (dim,), "done": ()}
    data = {k: jnp.asarray(rng.normal(size=(DEMO_ROWS, *s)).astype(np.float32))
            for k, s in shapes.items()}
    data["action"] = jnp.tanh(data["action"])
    data["done"] = (data["done"] > 1.0).astype(jnp.float32)
    return j_replay.ReplayBuffer(data=data, ptr=jnp.int32(0), size=jnp.int32(DEMO_ROWS),
                                 capacity=DEMO_ROWS)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    loop_kw, sac_kw, params = CASES[request.param]
    j_sac_cfg, t_sac_cfg = j_sac.SACConfig(**SAC, **sac_kw), t_sac.SACConfig(**SAC, **sac_kw)
    j_loop_cfg = j_loop.TrainLoopConfig(**LOOP, **loop_kw)
    t_loop_cfg = t_loop.TrainLoopConfig(**LOOP, **loop_kw)
    carry0 = jax.jit(lambda k: j_loop.init_carry(k, params, j_sac_cfg, j_loop_cfg))(
        jax.random.PRNGKey(7))
    if j_loop_cfg.demo_fraction > 0:
        carry0 = carry0.replace(demo_buffer=demo_buffer(j_loop_cfg))
    t_carry0 = train_carry_from_numpy(np_tree(carry0), t_sac_cfg, t_loop_cfg, device="cpu")

    keys, original = [], j_env.batched_step_autoreset

    def recording_step(states, actions, params, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), states.key, ordered=True)
        return original(states, actions, params, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, "batched_step_autoreset", recording_step)
        j_it = jax.jit(j_loop.make_train_iteration(j_sac_cfg, j_loop_cfg))
        j_carry, j_metrics = j_it(carry0, params)
        jax.effects_barrier()
    assert len(keys) == STEPS
    size0, cap = int(carry0.buffer.size), int(carry0.buffer.capacity)
    sizes = [min(size0 + (t + 1) * N, cap) for t in range(STEPS)]
    draws = iteration_draws(KeyChain(params), carry0.key, keys, sizes, t_sac_cfg,
                            t_loop_cfg, demo_size=DEMO_ROWS)
    t_it = t_loop.make_train_iteration(t_sac_cfg, t_loop_cfg)
    t_carry, t_metrics = t_it(t_carry0, env_params_from_numpy(params), draws)
    return dict(case=request.param, j=j_carry, jm=j_metrics, t=t_carry, tm=t_metrics,
                t_cfg=t_sac_cfg, t_loop=t_loop_cfg, sizes=sizes)


def test_iteration_env_state_and_obs_match(run):
    t, j = run["t"], run["j"]
    assert_state_close(t.env_states, j.env_states, what=run["case"])
    np.testing.assert_allclose(t.obs.numpy(), np.asarray(j.obs), **OBS)
    if run["t_loop"].history_len > 1:
        assert t.obs_window.shape == (N, 2, 10)
        np.testing.assert_allclose(t.obs_window.numpy(), np.asarray(j.obs_window), **OBS)


def test_iteration_replay_rows_match(run):
    t, j = run["t"].buffer, run["j"].buffer
    assert (t.ptr, t.size, t.capacity) == (int(j.ptr), int(j.size), j.capacity)
    for k in ("obs", "next_obs", "action"):
        np.testing.assert_allclose(t.data[k].numpy(), np.asarray(j.data[k]), **OBS, err_msg=k)
    np.testing.assert_allclose(t.data["reward"].numpy(), np.asarray(j.data["reward"]), **REWARD)
    np.testing.assert_array_equal(t.data["done"].numpy(), np.asarray(j.data["done"]))


def test_iteration_counters_and_ring_match(run):
    t, j = run["t"], np_tree(run["j"])
    for name in ("env_steps", "episodes", "successes", "ep_length", "ep_ring_length",
                 "ep_ring_success", "ep_ring_seq", "ep_ring_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)
        assert getattr(t, name).numpy().dtype == getattr(j, name).dtype, name
    for name in ("ep_return", "return_sum", "length_sum", "ep_ring_return"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name), **REWARD,
                                   err_msg=name)
    if run["case"] == "k1_gate_wrap_ring":
        # the last step finished more envs than the ring has slots: every
        # slot holds an episode of that step
        assert int((t.ep_length == 0).sum()) > RING
        assert set(t.ep_ring_seq.tolist()) == {STEPS - 1}


def test_iteration_params_and_metrics_match(run):
    t, cfg = run["t"], run["t_cfg"]
    ref = sac_state_from_numpy(np_tree(run["j"].agent), cfg, t_loop.policy_obs_dim(run["t_loop"]),
                               2, device="cpu")
    for net in ("actor", "critic", "target_critic"):
        for (name, p), q in zip(getattr(t.agent, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-4,
                                       err_msg=f"{net}.{name}")
    np.testing.assert_allclose(t.agent.log_alpha.numpy(), ref.log_alpha.numpy(), atol=1e-4)
    loop_cfg = run["t_loop"]
    every = max(loop_cfg.update_interval, 1)
    updates = loop_cfg.updates_per_step * sum(
        1 for s, size in enumerate(run["sizes"])
        if s % every == every - 1 and size >= cfg.learning_starts)
    assert t.agent.step == ref.step == updates
    assert 0 < updates < loop_cfg.updates_per_step * STEPS // every  # the gate opened mid-way
    assert sorted(run["tm"]) == sorted(run["jm"])
    for k, v in run["tm"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(run["jm"][k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_drain_episodes_and_summarize_match(run):
    t, j = run["t"], run["j"]
    t_eps, t_last = t_loop.drain_episodes(t, -1)
    j_eps, j_last = j_loop.drain_episodes(j, -1)
    assert t_last == j_last and len(t_eps) == len(j_eps) > 0
    for (tr, tl, ts), (jr, jl, js) in zip(t_eps, j_eps):
        assert (tl, ts) == (jl, js)
        assert tr == pytest.approx(jr, rel=1e-3, abs=1e-3)
    assert t_loop.drain_episodes(t, t_last) == ([], t_last)
    t_sum, j_sum = t_loop.summarize(t), j_loop.summarize(j)
    assert sorted(t_sum) == sorted(j_sum)
    for k, v in j_sum.items():
        assert t_sum[k] == pytest.approx(v, rel=1e-3), k


@pytest.mark.parametrize("ptr,p_done", [(0, 0.9), (5, 0.9), (3, 0.3), (7, 0.0)])
def test_ring_write_matches_jax_scatter(ptr, p_done):
    """More finishers than slots (duplicate slots in the reference's scatter,
    where the last writer wins), fewer, and none."""
    rng = np.random.default_rng(ptr)
    done = rng.uniform(size=40) < p_done
    values = rng.normal(size=40).astype(np.float32)
    ring = rng.normal(size=RING).astype(np.float32)
    finished_before = np.cumsum(done.astype(np.int32)) - 1
    slot = np.where(done, (ptr + finished_before) % RING, RING)
    want = jnp.asarray(ring).at[jnp.asarray(slot)].set(jnp.asarray(values), mode="drop")
    t_slot, total = t_loop.ring_slots(torch.from_numpy(done), torch.tensor(ptr, dtype=torch.int32),
                                      RING)
    got = t_loop.ring_set(torch.from_numpy(ring), t_slot, torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(total) == int(done.sum())
    kept = t_slot[t_slot < RING]
    assert len(set(kept.tolist())) == len(kept) == min(int(done.sum()), RING)


def test_iteration_options():
    tp = env_params_from_numpy(JAX_PARAMS)
    cfg = t_sac.SACConfig(hidden_dims=(8, 8), batch_size=8, buffer_size=64, learning_starts=8)
    base = t_loop.TrainLoopConfig(num_envs=8, rollout_steps=2)
    with pytest.raises(ValueError, match="axis_name"):
        t_loop.make_train_iteration(cfg, base, axis_name="model")
    with pytest.raises(ValueError, match="multiple"):
        t_loop.make_train_iteration(cfg, dataclasses.replace(base, update_interval=3))
    # use_pallas_physics=False on CPU tensors: the same batched step, whose
    # CPU route is the plain integrator, from the generator's draws
    plain = dataclasses.replace(base, use_pallas_physics=False)
    carry = t_loop.init_carry(tp, cfg, plain, device="cpu", seed=1)
    carry, metrics = t_loop.make_train_iteration(cfg, plain)(carry, tp)
    assert carry.agent.step == 2 and all(torch.isfinite(v) for v in metrics.values())
    magnus = dataclasses.replace(tp, rocket=dataclasses.replace(tp.rocket, magnus_effect=True))
    forced = dataclasses.replace(base, use_pallas_physics=True)
    with pytest.raises(ValueError, match="parity physics"):
        t_loop.make_train_iteration(cfg, forced)(carry, magnus)
