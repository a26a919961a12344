"""The transformer policy and the observation-history rollout against the
benchmark's plain reference (``portbench/reference``), on the CPU with seeded
random weights, and the window logic that the trainer and ``collect`` share.

- ``TransformerActor`` (d_model 32, 4 heads, 2 layers, token 12) and the
  network at sequence length 4 against ``reference.transformer.actor`` in
  float32. The reference computes attention in full; the port takes the
  value projection itself over one key. Bar 2e-5 absolute and relative, as
  the JAX parity tests': float32 rounding that differs in order (the bias
  fused into the product or added after it, the GELU's and the position
  encoding's own roundings) through a dozen layers, LayerNorms included. The
  reference one precision lower (bfloat16 floats) misses the bar by orders.
- ``collect(history_len=4)`` over a chunk of 8 steps at 64 envs (episodes
  truncated after 5 steps, so every window is refilled) against
  ``reference.history.chunk`` from the same reset, draws and weights:
  terminations, truncations and the discrete state equal;
  every float, the windows included, within 1e-3 of (1 + |reference|): the
  actors' float32 differences (under 2e-5) pass through the tanh, the
  safety projection and eight integrator steps.
- ``next_window`` is the trainer's window update of before, bit for bit;
  the train iteration calls it through the module (where the benchmark's
  span wraps it); ``collect`` at history 1 launches the same operations and
  returns the same as before its window.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import check, harness
from portbench.entries import collect_history
from portbench.entries._env import flat
from portbench.reference import history as ref_history, transformer as ref_tf
from tvc_ai_torch.agents import sac
from tvc_ai_torch.config import build, loader
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.models import transformer as t_tf
from tvc_ai_torch.models.safety import apply_safety
from tvc_ai_torch.training import loop
from tvc_ai_torch.utils import profiling
from tvc_ai_torch.utils.checkpoint import diff_states

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG_DIR = Path(loop.__file__).resolve().parent.parent / "config"
SMALL = SimpleNamespace(token_dim=12, d_model=32, num_heads=4, num_layers=2,
                        feed_forward_dim=64, head_hidden_dims=(64, 64), squeezed=2,
                        sequence_length=1, action_dim=2)
FORWARD = dict(atol=2e-5, rtol=2e-5)
CHUNK_GAP = 1e-3


def _small_net(seq: int, seed: int):
    """The port's network at SMALL widths with the benchmark's seeded
    weights; its token is the observation over ``seq`` positions."""
    s = SimpleNamespace(**{**vars(SMALL), "token_dim": SMALL.token_dim // seq})
    w = collect_history.weights(s, seed, CPU)
    net = t_tf.TransformerPolicyNetwork(s.token_dim, 2, s.d_model, s.num_heads, s.num_layers,
                                        s.feed_forward_dim, s.head_hidden_dims, device=CPU)
    params = dict(net.named_parameters())
    with torch.no_grad():
        for name, t in w.items():
            params[name].copy_(t)
    return net, w


@pytest.mark.parametrize("seq", [1, 4], ids=["actor_seq1", "network_seq4"])
def test_port_matches_the_plain_reference(seq):
    net, w = _small_net(seq, 2**31 + seq)
    obs = torch.randn((256, SMALL.token_dim), generator=torch.Generator().manual_seed(seq)) * 2
    with torch.no_grad():
        if seq == 1:
            actor = t_tf.TransformerActor(SMALL.token_dim, 2, SMALL.d_model, SMALL.num_heads,
                                          SMALL.num_layers, SMALL.feed_forward_dim,
                                          SMALL.head_hidden_dims, device=CPU)
            actor.TransformerPolicyNetwork_0.load_state_dict(net.state_dict())
            mean, log_std = actor(obs)
        else:
            mean, log_std, _ = net(obs, sequence_length=seq, with_value=False)
        r_mean, r_log_std = ref_tf.actor(w, obs, SMALL.num_heads, seq)
        l_mean, l_log_std = ref_tf.actor(w, obs, SMALL.num_heads, seq, lower=True)
    torch.testing.assert_close(mean, r_mean, **FORWARD)
    torch.testing.assert_close(log_std, r_log_std, **FORWARD)
    lower_off = max(float((l_mean.float() - r_mean).abs().max()),
                    float((l_log_std.float() - r_log_std).abs().max()))
    assert lower_off > 50 * FORWARD["atol"]


def test_reference_leaves_tf32_as_it_found_it():
    net, w = _small_net(1, 5)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    ref_tf.actor(w, torch.zeros((2, SMALL.token_dim)), SMALL.num_heads, lower=True)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


@pytest.fixture(scope="module")
def history_run():
    """The benchmark entry's program at 64 envs on the CPU, episodes
    truncated after 5 steps."""
    spec = harness.load_cell("transformer_r3.history_rollout_4m")
    run = collect_history.Run(spec, 2**33 + 11, CPU, 64)
    run.port.env_params = dataclasses.replace(run.port.env_params, max_episode_steps=5)
    run.p.max_episode_steps = 5
    return run


def test_collect_history_matches_the_reference_chunk(history_run):
    run = history_run
    run.start()
    state0 = {k: v.clone() for k, v in flat(run.state).items()}
    window0 = run.obs.clone()
    made = list(run._draws(0))
    state, window, (rew, term, trunc) = run.program_chunk(run.state, run.obs, iter(made))
    r_state, r_window, r_rew, r_term, r_trunc = ref_history.chunk(
        run.p, lambda p, o, d: run.ref_action(p, o, d, False), state0, window0, made)
    assert (r_term | r_trunc).any(0).all(), "every env ends an episode in the chunk"
    assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
    prog = {"state": flat(state), "obs": window, "reward": rew, "terminated": term,
            "truncated": trunc}
    ref = {"state": r_state, "obs": r_window, "reward": r_rew, "terminated": r_term,
           "truncated": r_trunc}
    numbers, _ = check.chunk_numbers(prog, ref)
    assert numbers["departed_pct"] == 0.0
    assert numbers["gap_max"] <= CHUNK_GAP, numbers


def _parent_next_window(history):
    """The train iteration's window update as it was, a closure over the
    history length."""
    def next_window(window, out, next_obs, done):
        if history <= 1:
            return window, out.obs, next_obs
        shifted = torch.cat([window[:, 1:], out.obs[:, None, :]], dim=1)
        fresh = next_obs[:, None, :].expand(-1, history, -1)
        window = torch.where(done[:, None, None], fresh, shifted)
        return window, shifted.reshape(shifted.shape[0], -1), window.reshape(window.shape[0], -1)
    return next_window


@pytest.mark.parametrize("history", [1, 4])
def test_next_window_is_the_former_closure(history):
    gen = torch.Generator().manual_seed(history)
    n = 32
    window = torch.randn((n, history, 10), generator=gen) if history > 1 else None
    out_obs, next_obs = torch.randn((n, 10), generator=gen), torch.randn((n, 10), generator=gen)
    done = torch.rand(n, generator=gen) < 0.3
    got = loop.next_window(window, out_obs, next_obs, done)
    want = _parent_next_window(history)(window, SimpleNamespace(obs=out_obs), next_obs, done)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def _tiny_iteration(history: int):
    fc = loader.load_config(CONFIG_DIR / "transformer_r3.yaml", [
        "training.num_envs=16", "training.rollout_steps=3", "training.updates_per_step=1",
        f"network.history_len={history}", "network.transformer.d_model=16",
        "network.transformer.num_heads=2", "network.transformer.num_layers=1",
        "algorithms.sac.buffer_size=96", "algorithms.sac.batch_size=8",
        "algorithms.sac.learning_starts=16", "env.max_episode_steps=2"])
    params, loop_cfg, sac_cfg = (build.build_env_params(fc), build.build_loop_config(fc),
                                 build.build_sac_config(fc))
    carry = loop.init_carry(params, sac_cfg, loop_cfg, CPU, seed=3)
    return carry, params, loop.make_train_iteration(sac_cfg, loop_cfg)


@pytest.mark.parametrize("history", [1, 4])
def test_train_iteration_windows_as_before(history, monkeypatch):
    """The iteration through the hoisted ``next_window`` equals the one
    through the former closure, carry and metrics bit for bit; it calls the
    module's function once a step."""
    carry, params, iterate = _tiny_iteration(history)
    hoisted = iterate(carry, params)
    calls = []
    former = _parent_next_window(history)

    def parent(window, out_obs, next_obs, done):
        calls.append(window is not None)
        return former(window, SimpleNamespace(obs=out_obs), next_obs, done)

    carry, params, iterate = _tiny_iteration(history)
    monkeypatch.setattr(loop, "next_window", parent)
    before = iterate(carry, params)
    assert calls == [history > 1] * 3
    assert diff_states(hoisted, before) == []


def _parent_collect(actor, env_states, obs, env_params, steps, safety, draws):
    """``collect`` as it was before its window: history 1 only."""
    rewards, terminated, truncated = [], [], []
    for t in range(steps):
        d = draws[t]
        actions = sac.select_action(actor, obs, d.n_act)
        if safety is not None:
            actions, _ = apply_safety(obs, actions, safety)
        env_states, out, obs = rocket_env.batched_step_autoreset(
            env_states, actions, env_params, n_imu=d.n_imu, reset_draws=d.reset,
            u_drop=d.u_drop)
        rewards.append(out.reward)
        terminated.append(out.terminated)
        truncated.append(out.truncated)
    return loop.Rollout(states=env_states, obs=obs, reward=torch.stack(rewards),
                        terminated=torch.stack(terminated), truncated=torch.stack(truncated))


def _aten_ops(prof) -> list[str]:
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


@pytest.mark.parametrize("config", ["default", "robust_full_r4d"])
def test_collect_at_history_1_is_as_before(config):
    spec = harness.load_cell(f"{config}.rollout_4m")
    run = harness.entry(spec["traffic"]["entry"]).Run(spec, 2**32 + 1, CPU, 48)
    run.start()
    made = list(run._draws(0))
    sd = [loop.StepDraws(n_act=d["n_act"], n_imu=d.get("n_imu"), u_drop=d.get("u_drop"),
                         reset=run.port.reset_draws(d["reset"])) for d in made]
    results, ops = [], []
    for fn in (lambda: loop.collect(run.actor, run.state, run.obs, run.port.env_params, len(sd),
                                    safety=run.safety, draws=sd),
               lambda: _parent_collect(run.actor, run.state, run.obs, run.port.env_params,
                                       len(sd), run.safety, sd)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            results.append(fn())
        ops.append(_aten_ops(prof))
        profiling.counters()
    assert diff_states(results[0], results[1]) == []
    assert ops[0] == ops[1] and ops[0]
    assert math.isfinite(float(results[0].reward.sum()))
