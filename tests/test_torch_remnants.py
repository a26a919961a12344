"""The reference's remaining API names in tvc_ai_torch, against the JAX
package where it has them (CPU).

``training.stability.make_lr_schedule`` for all six schedules (scheduling
off, linear, exponential, cosine, warmup_cosine, plateau), plain and
conservative, against the reference's optax schedules at relative 1e-6;
``create_stability_manager``'s config and its state after the same step
sequence; ``utils.devices.DeviceManager`` as the reference's test drives
it; ``agents.ppo.select_action`` on weights carried across by ``convert``
(deterministic at 1e-6, stochastic with the replayed normals at 1e-5); and
the ``act_fn`` hook of ``training.loop.make_train_iteration`` (port only,
to keep JAX compiles out of these tests): the default action passed as the
hook changes nothing bit for bit, a constant action lands in the replay.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import ppo_state_from_numpy
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.training import stability as t_stab
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_torch.utils.devices import DeviceManager, get_device_manager
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.training import stability as j_stab

torch.set_num_threads(1)
TOTAL = 100_000
SCHEDULES = ("off", "linear", "exponential", "cosine", "warmup_cosine", "plateau")
OBS, ACT, ROWS = 10, 2, 64


def _configs(kind: str, conservative: bool):
    port = t_stab.create_stability_manager(TOTAL, conservative).cfg
    ref = j_stab.create_stability_manager(TOTAL, conservative).cfg
    fields = (dict(enable_lr_scheduling=False) if kind == "off"
              else dict(scheduler_type=kind))
    return dataclasses.replace(port, **fields), dataclasses.replace(ref, **fields)


@pytest.mark.parametrize("conservative", [False, True], ids=["plain", "conservative"])
@pytest.mark.parametrize("kind", SCHEDULES)
def test_make_lr_schedule_matches_optax(kind, conservative):
    port_cfg, ref_cfg = _configs(kind, conservative)
    base = 3e-4
    got = t_stab.make_lr_schedule(port_cfg, base, TOTAL)
    want = j_stab.make_lr_schedule(ref_cfg, base, TOTAL)
    w = port_cfg.warmup_steps
    counts = [0, 1, w - 1, w, TOTAL // 2, TOTAL - 1, TOTAL, TOTAL + 10,
              port_cfg.plateau_patience, TOTAL // 10 + 1]
    for c in counts:
        assert got(c) == pytest.approx(float(want(c)), rel=1e-6, abs=0.0), (kind, c)
    if kind == "off":
        assert {got(c) for c in counts} == {base}


def test_make_lr_schedule_rejects_unknown_type():
    cfg = dataclasses.replace(t_stab.StabilityConfig(), scheduler_type="step")
    with pytest.raises(ValueError, match="unknown scheduler_type 'step'"):
        t_stab.make_lr_schedule(cfg, 1e-3, TOTAL)


@pytest.mark.parametrize("conservative", [False, True], ids=["plain", "conservative"])
def test_create_stability_manager_matches_reference(conservative):
    port = t_stab.create_stability_manager(TOTAL, conservative)
    ref = j_stab.create_stability_manager(TOTAL, conservative)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert port.total_steps == ref.total_steps == TOTAL
    port.register_initial_params(GaussianActor(OBS, ACT, (8, 8), device="cpu"))
    ref.register_initial_params({"w": jnp.zeros(3)})
    due = []
    for n in (1000, 4000, 1, 20_000, 30_000, 5_000, 60_000):
        port.step(n)
        ref.step(n)
        due.append(((port.due_primacy_reset(), port.due_dormant_check()),
                    (ref.due_primacy_reset(), ref.due_dormant_check())))
        assert port.state_dict() == ref.state_dict()
    assert all(a == b for a, b in due) and any(any(a) for a, _ in due)
    assert port.should_stop_training(0.95) and not port.should_stop_training(0.5)


def test_device_manager_cpu():
    """The reference's ``test_device_manager``, on the CPU the port is asked for."""
    dm = get_device_manager("cpu")
    assert dm is get_device_manager()  # singleton
    assert isinstance(dm, DeviceManager)
    assert (dm.platform, dm.device.type, dm.is_tpu, dm.requested) == ("cpu", "cpu", False, "cpu")
    x = np.ones((4, 4), np.float32)
    dev = dm.to_device(x)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    back = dm.to_numpy(dev)
    assert np.allclose(back, x)
    tree = dm.to_numpy(dm.to_device({"a": x, "b": [x, (2 * x,)]}))
    assert np.allclose(tree["b"][1][0], 2 * x)
    dm.synchronize()
    info = dm.get_memory_info()
    assert isinstance(info, dict) and "bytes_in_use" not in info   # no allocator to read
    assert dm.device_count() >= 1
    assert get_device_manager("cpu") is dm


@pytest.fixture(scope="module")
def ppo_case():
    """A JAX PPO state, its port, observations and the reference's actions:
    deterministic, and stochastic with the normals its key draws."""
    cfg_j = j_ppo.PPOConfig(hidden_dims=(32, 32))
    cfg_t = t_ppo.PPOConfig(hidden_dims=(32, 32))
    j_state = j_ppo.init(jax.random.PRNGKey(3), OBS, ACT, cfg_j)
    obs = np.random.default_rng(3).normal(size=(ROWS, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    det = np.array(j_ppo.select_action(j_state, jnp.asarray(obs), key, cfg_j, ACT, True))
    sto = np.array(j_ppo.select_action(j_state, jnp.asarray(obs), key, cfg_j, ACT))
    normals = np.array(jax.random.normal(key, (ROWS, ACT), jnp.float32))
    port = ppo_state_from_numpy(np_tree(j_state), cfg_t, OBS, ACT, device="cpu")
    return port, torch.from_numpy(obs), det, sto, torch.from_numpy(normals)


def test_ppo_select_action_matches_jax(ppo_case):
    port, obs, det, sto, normals = ppo_case
    got = t_ppo.select_action(port, obs, deterministic=True)
    torch.testing.assert_close(got, torch.from_numpy(det), atol=1e-6, rtol=0.0)
    got = t_ppo.select_action(port, obs, n_act=normals)
    torch.testing.assert_close(got, torch.from_numpy(sto), atol=1e-5, rtol=0.0)
    # the noise convention of ``ppo.act``: the same draw gives the same action
    torch.testing.assert_close(got, t_ppo.act(port, obs, n_act=normals)[0])
    gen_a, gen_b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    torch.testing.assert_close(t_ppo.select_action(port, obs, generator=gen_a),
                               t_ppo.select_action(port, obs, n_act=torch.randn(
                                   (ROWS, ACT), generator=gen_b)))


SAC_SMALL = t_sac.SACConfig(hidden_dims=(16, 16), batch_size=8, buffer_size=64,
                            learning_starts=16)
LOOP_SMALL = t_loop.TrainLoopConfig(num_envs=8, rollout_steps=8, episode_ring_size=16)
CONSTANT = (0.3, -0.1)


def _carry():
    return t_loop.init_carry(EnvParams(), SAC_SMALL, LOOP_SMALL, device="cpu", seed=7)


def test_act_fn_default_changes_nothing():
    """The default act path passed as ``act_fn`` gives the same iteration bit
    for bit: carry, generator state and metrics."""
    def default(agent, policy_input, n_act, generator):
        return t_sac.select_action(agent.actor, policy_input, n_act, generator=generator)

    runs = []
    for hook in (None, default):
        carry = _carry()
        it = t_loop.make_train_iteration(SAC_SMALL, LOOP_SMALL, act_fn=hook)
        metrics = []
        for _ in range(2):   # the second iteration learns
            carry, m = it(carry, EnvParams())
            metrics.append(m)
        runs.append((carry, metrics))
    (a, ma), (b, mb) = runs
    assert a.buffer.size == a.buffer.capacity and a.agent.step > 0
    assert not diff_states({"carry": a, "metrics": ma}, {"carry": b, "metrics": mb})


def test_act_fn_constant_actions_reach_the_replay():
    """The reference's ``det_act``: every stored action is the constant."""
    seen = []

    def det_act(agent, policy_input, n_act, generator):
        seen.append((policy_input.shape, n_act))
        return torch.tensor([CONSTANT]).expand(policy_input.shape[0], 2)

    carry = _carry()
    carry, _ = t_loop.make_train_iteration(SAC_SMALL, LOOP_SMALL, act_fn=det_act)(
        carry, EnvParams())
    actions = carry.buffer.data["action"][:carry.buffer.size]
    assert carry.buffer.size == 64
    torch.testing.assert_close(actions, torch.tensor([CONSTANT]).expand(64, 2),
                               atol=0.0, rtol=0.0)
    assert seen == [((8, OBS), None)] * 8


def test_act_fn_leaves_hoisting_unported():
    with pytest.raises(NotImplementedError, match="hoist_bookkeeping"):
        t_loop.make_train_iteration(
            SAC_SMALL, dataclasses.replace(LOOP_SMALL, hoist_bookkeeping=True),
            act_fn=lambda *a: None)
