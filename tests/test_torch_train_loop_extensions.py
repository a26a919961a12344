"""The fused train iteration's extensions of tvc_ai_torch against the JAX
package (CPU): the ICM (with and without the physics-informed loss) and RND
here; hierarchical RL and all four together in
``test_torch_train_loop_hierarchical.py``; the ICM under ``update_interval``
2 and ICM + RND with ``history_len`` 4 in ``test_torch_train_loop_cadence.py``.
Those files run the same checks.

As in ``test_torch_train_loop.py``: one JAX ``TrainCarry`` is carried across
with ``convert.train_carry_from_numpy``, the JAX ``make_train_iteration``
runs one 8-step iteration under ``jit`` with the env keys recorded, and the
port runs one iteration on the replayed draws (the fresh goals' Gumbel draws
included). RND updates at env steps 0, 3 and 6 (``update_frequency`` 3).
Bars: the loop's (obs 5e-5 / 5e-4, reward and returns 1e-3, flags, counts
and goals exact, SAC parameters 1e-4, metrics 1e-3 relative), and the new
carry fields (ICM, RND, high level: parameters, Adam moments, normalizer,
baseline) within 1e-4.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, assert_state_close, iteration_draws, np_tree
from tvc_ai_torch.agents import physics_informed as t_pi
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import (
    curiosity_state_from_numpy,
    env_params_from_numpy,
    high_level_state_from_numpy,
    rnd_state_from_numpy,
    sac_state_from_numpy,
    train_carry_from_numpy,
)
from tvc_ai_torch.models import curiosity as t_icm
from tvc_ai_torch.models import hierarchical as t_hier
from tvc_ai_torch.models import rnd as t_rnd
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_tpu.agents import physics_informed as j_pi
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.models import curiosity as j_icm
from tvc_ai_tpu.models import hierarchical as j_hier
from tvc_ai_tpu.models import rnd as j_rnd
from tvc_ai_tpu.training import loop as j_loop

torch.set_num_threads(1)
N, STEPS, RING = 16, 8, 8
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
STATE = dict(atol=1e-4, rtol=0.0)
SAC = dict(hidden_dims=(32, 32), batch_size=16, buffer_size=96, learning_starts=48,
           gradient_clip_norm=5.0, reward_scale=0.05)
LOOP = dict(num_envs=N, rollout_steps=STEPS, use_safety_layer=True, episode_ring_size=RING)
SUB = dict(curiosity=dict(hidden_dim=32, lr=1e-3), rnd=dict(hidden_dims=(32, 16), embed_dim=8,
           lr=1e-3, update_frequency=3), physics_informed=dict(physics_weight=0.2),
           hierarchical=dict(high_level_lr=1e-3))
J_SUB = dict(curiosity=j_icm.CuriosityConfig, rnd=j_rnd.RNDConfig,
             physics_informed=j_pi.PhysicsInformedConfig, hierarchical=j_hier.HierarchicalConfig)
T_SUB = dict(curiosity=t_icm.CuriosityConfig, rnd=t_rnd.RNDConfig,
             physics_informed=t_pi.PhysicsInformedConfig, hierarchical=t_hier.HierarchicalConfig)
JAX_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
    max_episode_steps=4,
)
ALL = dict(use_curiosity=True, use_physics_informed=True, use_rnd=True, use_hierarchical=True)
# every case, and the file that runs it (each file under a minute serial:
# one JAX compile of the iteration per case)
ALL_CASES = {
    "icm": dict(use_curiosity=True),
    "icm_physics": dict(use_curiosity=True, use_physics_informed=True),
    "rnd": dict(use_rnd=True),
    # test_torch_train_loop_hierarchical.py
    "hierarchical": dict(use_hierarchical=True),
    "all_four": ALL,
    # test_torch_train_loop_cadence.py
    "icm_interval2": dict(use_curiosity=True, update_interval=2, updates_per_step=2),
    "icm_rnd_history4": dict(use_curiosity=True, use_rnd=True, history_len=4),
}
CASES = ("icm", "icm_physics", "rnd")


def loop_configs(case: str):
    kw = dict(LOOP, **ALL_CASES[case])
    j = j_loop.TrainLoopConfig(**kw, **{k: J_SUB[k](**v) for k, v in SUB.items()})
    t = t_loop.TrainLoopConfig(**kw, **{k: T_SUB[k](**v) for k, v in SUB.items()})
    return j, t


@functools.lru_cache(maxsize=None)
def _initial_carry(hierarchical: bool, history_len: int):
    """``init_carry`` with every extension on (hierarchical or not): the
    ICM's, RND's and high level's keys fold out of the agent's key, so a
    case's carry is this one with the extensions it leaves off set to None
    (one JAX compile of the init for several cases)."""
    kw = dict(LOOP, **ALL)
    kw.update(use_hierarchical=hierarchical, history_len=history_len)
    j_loop_cfg = j_loop.TrainLoopConfig(**kw, **{k: J_SUB[k](**v) for k, v in SUB.items()})
    return jax.jit(lambda k: j_loop.init_carry(k, JAX_PARAMS, j_sac.SACConfig(**SAC),
                                               j_loop_cfg))(jax.random.PRNGKey(7))


@functools.lru_cache(maxsize=1)
def _key_chain() -> KeyChain:
    return KeyChain(JAX_PARAMS)


def run_case(case: str) -> dict:
    """One JAX iteration of ``case`` and the port's on the replayed draws."""
    j_sac_cfg, t_sac_cfg = j_sac.SACConfig(**SAC), t_sac.SACConfig(**SAC)
    j_loop_cfg, t_loop_cfg = loop_configs(case)
    params = JAX_PARAMS
    full = _initial_carry(j_loop_cfg.use_hierarchical, j_loop_cfg.history_len)
    carry0 = full.replace(icm=full.icm if j_loop_cfg.use_curiosity else None,
                          rnd=full.rnd if j_loop_cfg.use_rnd else None)
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
    draws = iteration_draws(_key_chain(), carry0.key, keys, sizes, t_sac_cfg, t_loop_cfg)
    t_it = t_loop.make_train_iteration(t_sac_cfg, t_loop_cfg)
    t_carry, t_metrics = t_it(t_carry0, env_params_from_numpy(params), draws)
    return dict(case=case, j0=carry0, j=j_carry, jm=j_metrics, t=t_carry,
                tm=t_metrics, t_cfg=t_sac_cfg, t_loop=t_loop_cfg)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    return run_case(request.param)


def check_convert(run):
    """The initial carry's ICM, RND and high-level states, goals and goal
    ring as ``train_carry_from_numpy`` carries them; ``env_steps_host``. (The
    iteration steps the carried states in place, so the JAX carry is
    converted again here.)"""
    cfg, j = run["t_loop"], np_tree(run["j0"])
    t = train_carry_from_numpy(j, run["t_cfg"], cfg, device="cpu")
    assert t.env_steps_host == int(j.env_steps[0]) == 0
    for name, on in (("icm", cfg.use_curiosity), ("rnd", cfg.use_rnd),
                     ("hier", cfg.use_hierarchical), ("goal", cfg.use_hierarchical),
                     ("goal_obs", cfg.use_hierarchical), ("ep_ring_goal", cfg.use_hierarchical),
                     ("ep_ring_goal_obs", cfg.use_hierarchical)):
        assert (getattr(t, name) is not None) == on == (getattr(j, name) is not None), name
    if cfg.use_curiosity:
        assert t.icm.step == 0 and t.icm.opt.count == 0
        w = j.icm.params["params"]["forward_model"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(t.icm.nets.forward_model.Dense_0.weight.detach().numpy().T, w)
    if cfg.use_rnd:
        w = j.rnd.target_params["params"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(t.rnd.target.Dense_0.weight.numpy().T, w)
        assert float(t.rnd.bonus_var) == 1.0
    if cfg.use_hierarchical:
        np.testing.assert_array_equal(t.goal.numpy(), j.goal)
        assert t.goal.dtype == torch.int32
        np.testing.assert_array_equal(t.goal_obs.numpy(), j.goal_obs)
        assert t.ep_ring_goal.shape == (RING,) and t.ep_ring_goal_obs.shape == (RING, 10)
        assert int(t.hier.opt.count) == 0 and t.hier.opt.count.dtype == torch.int32
        assert t.obs.shape == (N, 10 * cfg.history_len)   # the goal is not in the carried obs


def check_env_state_and_obs_match(run):
    t, j = run["t"], run["j"]
    assert_state_close(t.env_states, j.env_states, what=run["case"])
    np.testing.assert_allclose(t.obs.numpy(), np.asarray(j.obs), **OBS)
    if run["t_loop"].history_len > 1:
        np.testing.assert_allclose(t.obs_window.numpy(), np.asarray(j.obs_window), **OBS)


def check_replay_rows_match(run):
    """Rows written with the intrinsic rewards, and in hierarchical mode the
    goal-augmented views."""
    t, j = run["t"].buffer, run["j"].buffer
    assert (t.ptr, t.size, t.capacity) == (int(j.ptr), int(j.size), j.capacity)
    assert t.data["obs"].shape[1] == t_loop.policy_obs_dim(run["t_loop"])
    for k in ("obs", "next_obs", "action"):
        np.testing.assert_allclose(t.data[k].numpy(), np.asarray(j.data[k]), **OBS, err_msg=k)
    np.testing.assert_allclose(t.data["reward"].numpy(), np.asarray(j.data["reward"]), **REWARD)
    np.testing.assert_array_equal(t.data["done"].numpy(), np.asarray(j.data["done"]))


def check_counters_ring_and_goals_match(run):
    t, j = run["t"], np_tree(run["j"])
    for name in ("env_steps", "episodes", "successes", "ep_length", "ep_ring_length",
                 "ep_ring_success", "ep_ring_seq", "ep_ring_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)
    for name in ("ep_return", "return_sum", "length_sum", "ep_ring_return"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name), **REWARD,
                                   err_msg=name)
    assert t.env_steps_host == int(j.env_steps[0]) == STEPS
    if run["t_loop"].use_hierarchical:
        np.testing.assert_array_equal(t.goal.numpy(), j.goal)
        np.testing.assert_array_equal(t.ep_ring_goal.numpy(), j.ep_ring_goal)
        np.testing.assert_allclose(t.goal_obs.numpy(), j.goal_obs, **OBS)
        np.testing.assert_allclose(t.ep_ring_goal_obs.numpy(), j.ep_ring_goal_obs, **OBS)
        assert int(t.episodes.sum()) > 0 and len(set(t.goal.tolist())) > 1


def check_sac_params_and_metrics_match(run):
    t, cfg = run["t"], run["t_cfg"]
    ref = sac_state_from_numpy(np_tree(run["j"].agent), cfg, t_loop.policy_obs_dim(run["t_loop"]),
                               2, device="cpu")
    for net in ("actor", "critic", "target_critic"):
        for (name, p), q in zip(getattr(t.agent, net).named_parameters(),
                                getattr(ref, net).parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE,
                                       err_msg=f"{net}.{name}")
    np.testing.assert_allclose(t.agent.log_alpha.numpy(), ref.log_alpha.numpy(), atol=1e-4)
    assert t.agent.step == ref.step > 0
    assert sorted(run["tm"]) == sorted(run["jm"])
    for k, v in run["tm"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(run["jm"][k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def _assert_modules_close(a, b, what):
    for (name, p), q in zip(a.named_parameters(), b.parameters(), strict=True):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE,
                                   err_msg=f"{what}.{name}")


def _assert_adam_close(a, b, what):
    assert int(a.count) == int(b.count), what
    for moment in ("mu", "nu"):
        for x, y in zip(getattr(a, moment), getattr(b, moment), strict=True):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **STATE, err_msg=f"{what}.{moment}")


def check_extension_states_match(run):
    t, j, cfg = run["t"], np_tree(run["j"]), run["t_loop"]
    every = max(cfg.update_interval, 1)
    if cfg.use_curiosity:
        ref = curiosity_state_from_numpy(j.icm, cfg.curiosity, "cpu")
        _assert_modules_close(t.icm.nets, ref.nets, "icm")
        _assert_adam_close(t.icm.opt, ref.opt, "icm.opt")
        assert t.icm.step == ref.step == STEPS   # every step, the sim-only ones included
    if cfg.use_rnd:
        ref = rnd_state_from_numpy(j.rnd, cfg.rnd, "cpu")
        _assert_modules_close(t.rnd.predictor, ref.predictor, "rnd.predictor")
        _assert_adam_close(t.rnd.opt, ref.opt, "rnd.opt")
        for name in ("bonus_mean", "bonus_var"):
            np.testing.assert_allclose(getattr(t.rnd, name).numpy(), getattr(ref, name).numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        assert t.rnd.step == ref.step == 3   # env steps 0, 3, 6
    if cfg.use_hierarchical:
        ref = high_level_state_from_numpy(j.hier, cfg.obs_dim, cfg.hierarchical, "cpu")
        _assert_modules_close(t.hier.policy, ref.policy, "hier")
        _assert_adam_close(t.hier.opt, ref.opt, "hier.opt")
        np.testing.assert_allclose(t.hier.baseline.numpy(), ref.baseline.numpy(), **REWARD)
        assert int(t.hier.step) == int(ref.step) == 1
    assert every in (1, 2)


def test_convert_carries_extension_fields(run):
    check_convert(run)


def test_iteration_env_state_and_obs_match(run):
    check_env_state_and_obs_match(run)


def test_iteration_replay_rows_match(run):
    check_replay_rows_match(run)


def test_iteration_counters_ring_and_goals_match(run):
    check_counters_ring_and_goals_match(run)


def test_iteration_sac_params_and_metrics_match(run):
    check_sac_params_and_metrics_match(run)


def test_iteration_extension_states_match(run):
    check_extension_states_match(run)
