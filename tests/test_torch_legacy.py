"""The legacy ``SACAgent`` class API of tvc_ai_torch against the JAX package
(CPU).

The JAX agent's state is carried across with ``convert.sac_state_from_numpy``;
both agents then store the same seeded transitions. The reference splits its
key on every ``select_action`` and ``train`` (``train`` splits again into the
sample's and the update's keys); the test replays those keys into the port's
explicit draws. Bars: deterministic and sampled actions 1e-6; after each
replayed ``train()`` the metrics 1e-5 relative and, after the last, every
parameter and ``log_alpha`` 1e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree, sample_idx, to_torch, update_draws
from tvc_ai_torch.agents import legacy as t_legacy
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import sac_state_from_numpy
from tvc_ai_torch.eval.evaluate import load_agent_state
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import legacy as j_legacy
from tvc_ai_tpu.agents import sac as j_sac

torch.set_num_threads(1)
OBS, ACT = 10, 2
CFG = dict(hidden_dims=(32, 24), batch_size=16, buffer_size=256, learning_starts=40,
           gradient_clip_norm=5.0)
CLOSE = dict(atol=1e-6, rtol=1e-6)
STATE = dict(atol=1e-5, rtol=0.0)


def _transitions(n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        obs = rng.normal(size=OBS).astype(np.float32)
        yield (obs, rng.uniform(-1, 1, size=ACT).astype(np.float32), float(rng.normal()),
               (obs + 0.1 * rng.normal(size=OBS)).astype(np.float32), bool(rng.uniform() < 0.1))


def _pair(seed: int = 3):
    j_agent = j_legacy.SACAgent(OBS, ACT, j_sac.SACConfig(**CFG), seed=seed)
    t_cfg = t_sac.SACConfig(**CFG)
    t_agent = t_legacy.SACAgent(OBS, ACT, t_cfg, seed=seed, device="cpu")
    t_agent.state = sac_state_from_numpy(np_tree(j_agent.state), t_cfg, OBS, ACT, device="cpu")
    return j_agent, t_agent


def _next_key(j_agent):
    """The key the JAX agent's next ``_next_key()`` returns."""
    return jax.random.split(j_agent._key)[1]


def test_select_action_matches_jax():
    j_agent, t_agent = _pair()
    for obs, *_ in _transitions(4, 0):
        want = j_agent.select_action(obs, deterministic=True)
        np.testing.assert_allclose(t_agent.select_action(obs, deterministic=True), want, **CLOSE)
        noise = jax.random.normal(_next_key(j_agent), (ACT,))
        want = j_agent.select_action(obs)
        got = t_agent.select_action(obs, n_act=to_torch(noise))
        assert got.shape == (ACT,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **CLOSE)
    free = t_agent.select_action(obs)
    assert free.shape == (ACT,) and np.all(np.abs(free) <= 1.0)


def test_replayed_train_matches_jax():
    j_agent, t_agent = _pair()
    data = list(_transitions(64, 1))
    for i, tr in enumerate(data):
        j_agent.store_transition(*tr)
        t_agent.store_transition(*tr)
        size = i + 1
        if size < CFG["learning_starts"]:
            assert j_agent.train() == t_agent.train() == {}   # the gate
            continue
        k_s, k_u = jax.random.split(_next_key(j_agent))
        want = j_agent.train()
        got = t_agent.train(sample_idx(k_s, CFG["batch_size"], size),
                            update_draws(k_u, CFG["batch_size"], ACT))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert t_agent.total_steps == j_agent.total_steps == len(data)
    assert len(t_agent.replay_buffer) == len(j_agent.replay_buffer) == len(data)
    ref = sac_state_from_numpy(np_tree(j_agent.state), t_agent.config, OBS, ACT, device="cpu")
    assert t_agent.state.step == ref.step == len(data) - CFG["learning_starts"] + 1
    for net in ("actor", "critic", "target_critic"):
        for (name, p), q in zip(getattr(t_agent.state, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE,
                                       err_msg=f"{net}.{name}")
    np.testing.assert_allclose(t_agent.log_alpha.numpy(), ref.log_alpha.numpy(), **STATE)


def test_train_gate_needs_a_full_batch():
    agent = t_legacy.SACAgent(OBS, ACT, t_sac.SACConfig(**dict(CFG, learning_starts=4)),
                              device="cpu")
    for tr in _transitions(CFG["batch_size"] - 1, 2):
        agent.store_transition(*tr)
        assert agent.train() == {}
    agent.store_transition(*next(_transitions(1, 3)))
    metrics = agent.train()
    assert agent.state.step == 1 and all(np.isfinite(v) for v in metrics.values())


def test_members_and_save_load_round_trip(tmp_path):
    agent = t_legacy.SACAgent(OBS, ACT, t_sac.SACConfig(**dict(CFG, learning_starts=16)),
                              seed=5, device="cpu")
    for tr in _transitions(24, 4):
        agent.store_transition(*tr)
        agent.train()
    assert agent.actor is agent.state.actor and agent.critic2 is agent.state.critic.q2
    assert agent.target_critic1 is agent.state.target_critic.q1
    assert float(agent.log_alpha.exp()) == pytest.approx(np.exp(float(agent.log_alpha)))
    assert all(p.shape for p in agent.critic1.parameters())
    agent.eval_mode()
    assert not agent.actor.training and not agent.critic1.training
    path = tmp_path / "agent.pt"
    agent.save(path)
    other = t_legacy.SACAgent(OBS, ACT, agent.config, seed=9, device="cpu")
    other.load(path)
    assert other.total_steps == agent.total_steps == 24
    assert not diff_states(other.state, agent.state)
    obs = next(_transitions(1, 6))[0]
    np.testing.assert_array_equal(other.select_action(obs, deterministic=True),
                                  agent.select_action(obs, deterministic=True))
    # the evaluation loader reads the same file, the whole state
    loaded = load_agent_state(path, OBS, ACT, agent.config, device="cpu")
    assert not diff_states(loaded, agent.state)


def test_flax_msgpack_file_is_refused(tmp_path):
    """The JAX package's ``SACAgent.save`` file is read whole (the bars of
    ``tests/test_torch_jax_artifacts.py``); a cut one, or a file that is
    neither a zip nor msgpack, is refused with ``ValueError``."""
    j_agent = j_legacy.SACAgent(OBS, ACT, j_sac.SACConfig(**CFG))
    path = tmp_path / "agent.msgpack"
    j_agent.save(path)
    agent = t_legacy.SACAgent(OBS, ACT, t_sac.SACConfig(**CFG), device="cpu")
    agent.load(path)
    obs = next(_transitions(1, 7))[0]
    np.testing.assert_allclose(agent.select_action(obs, deterministic=True),
                               j_agent.select_action(obs, deterministic=True), **CLOSE)
    assert not diff_states(load_agent_state(path, OBS, ACT, agent.config, device="cpu"),
                           agent.state)
    (tmp_path / "cut.msgpack").write_bytes(path.read_bytes()[:-9])
    with pytest.raises(ValueError, match="truncated"):
        agent.load(tmp_path / "cut.msgpack")
    (tmp_path / "text.pt").write_text("not an agent")
    with pytest.raises(ValueError, match="neither"):
        load_agent_state(tmp_path / "text.pt", OBS, ACT, agent.config, device="cpu")
    torch.save({"state": {}}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a SACAgent.save payload"):
        agent.load(tmp_path / "other.pt")
