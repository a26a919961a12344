"""Population training of tvc_ai_torch against the JAX package (CPU).

The reference vmaps one train iteration over a leading agent axis; the port
runs the same iteration on each agent's carry in turn. So the test first
holds, in JAX alone, the vmapped population iteration equal to the unbatched
iteration run on each agent's slice (1e-6). The unbatched runs record the
env keys each step uses (a debug callback around
``batched_step_autoreset``, as ``test_torch_train_loop`` does), and the
port's population iteration, started from ``convert.population_from_numpy``
of the JAX population, runs on those draws and is held per agent at the
loop's bars (obs 5e-5 / 5e-4, reward and returns 1e-3, counters exact,
parameters 1e-4, metrics 1e-3 relative).

``clone_winners`` is held exact against the reference's on a population
whose returns tie and differ, with the winner draw replayed from the
reference's key; then one more iteration shows that no agent shares state
with another.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, assert_state_close, iteration_draws, np_tree
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import (
    env_params_from_numpy,
    population_from_numpy,
    sac_state_from_numpy,
)
from tvc_ai_torch.training import population as t_pop
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.training import loop as j_loop
from tvc_ai_tpu.training import population as j_pop

torch.set_num_threads(1)
P, N, STEPS = 3, 8, 8
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
SAC = dict(hidden_dims=(16, 16), batch_size=16, buffer_size=1024, learning_starts=32,
           gradient_clip_norm=5.0, reward_scale=0.05)
POP = dict(num_agents=P, envs_per_agent=N, rollout_steps=STEPS)
PARAMS = EnvParams(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
                   max_episode_steps=4)


def agent_slice(tree, i: int):
    return jax.tree.map(lambda x: x[i], tree)


def assert_trees_close(a, b, what: str, **tol) -> None:
    leaves_a, tree_a = jax.tree.flatten(np_tree(a))
    leaves_b, tree_b = jax.tree.flatten(np_tree(b))
    assert tree_a == tree_b, what
    for k, (x, y) in enumerate(zip(leaves_a, leaves_b)):
        np.testing.assert_allclose(x, y, err_msg=f"{what} leaf {k}", **tol)


@pytest.fixture(scope="module")
def run():
    j_cfg, t_cfg = j_sac.SACConfig(**SAC), t_sac.SACConfig(**SAC)
    j_pcfg, t_pcfg = j_pop.PopulationConfig(**POP), t_pop.PopulationConfig(**POP)
    carry0 = jax.jit(lambda k: j_pop.init_population(k, PARAMS, j_cfg, j_pcfg))(
        jax.random.PRNGKey(7))
    vm_carry, vm_metrics = jax.jit(j_pop.make_population_iteration(j_cfg, j_pcfg))(
        carry0, PARAMS)

    keys, original = [], j_env.batched_step_autoreset

    def recording_step(states, actions, params, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), states.key, ordered=True)
        return original(states, actions, params, **kw)

    loop_cfg = j_loop.TrainLoopConfig(num_envs=N, rollout_steps=STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, "batched_step_autoreset", recording_step)
        it = jax.jit(j_loop.make_train_iteration(j_cfg, loop_cfg))
        single = [it(agent_slice(carry0, i), PARAMS) for i in range(P)]
        jax.effects_barrier()
    assert len(keys) == P * STEPS

    t_loop_cfg = t_pop.loop_config(t_pcfg)
    cap = int(carry0.buffer.capacity)
    draws = []
    for i in range(P):
        size0 = int(carry0.buffer.size[i])
        sizes = [min(size0 + (t + 1) * N, cap) for t in range(STEPS)]
        draws.append(iteration_draws(KeyChain(PARAMS), carry0.key[i],
                                     keys[i * STEPS:(i + 1) * STEPS], sizes, t_cfg, t_loop_cfg))
    t_carries = population_from_numpy(np_tree(carry0), t_cfg, t_pcfg, device="cpu")
    t_out, t_metrics = t_pop.make_population_iteration(t_cfg, t_pcfg)(
        t_carries, env_params_from_numpy(PARAMS), draws)
    return dict(carry0=carry0, vm=vm_carry, vm_metrics=vm_metrics, single=single, t=t_out,
                tm=t_metrics, t_cfg=t_cfg, t_pcfg=t_pcfg)


def test_vmapped_population_equals_each_agent_alone(run):
    for i, (carry, metrics) in enumerate(run["single"]):
        assert_trees_close(agent_slice(run["vm"], i), carry, f"agent {i}", rtol=1e-6, atol=1e-6)
        for k, v in metrics.items():
            np.testing.assert_allclose(np.asarray(run["vm_metrics"][k])[i], np.asarray(v),
                                       rtol=1e-6, atol=1e-6, err_msg=f"agent {i} {k}")


def test_population_iteration_matches_jax_per_agent(run):
    cfg = run["t_cfg"]
    assert {k: tuple(v.shape) for k, v in run["tm"].items()} == {
        k: (P,) for k in run["vm_metrics"]}
    for i, (j, j_metrics) in enumerate(run["single"]):
        t = run["t"][i]
        what = f"agent {i}"
        assert_state_close(t.env_states, j.env_states, what=what)
        np.testing.assert_allclose(t.obs.numpy(), np.asarray(j.obs), **OBS, err_msg=what)
        for k in ("obs", "next_obs", "action"):
            np.testing.assert_allclose(t.buffer.data[k].numpy(), np.asarray(j.buffer.data[k]),
                                       **OBS, err_msg=f"{what} {k}")
        np.testing.assert_allclose(t.buffer.data["reward"].numpy(),
                                   np.asarray(j.buffer.data["reward"]), **REWARD)
        for name in ("env_steps", "episodes", "successes", "ep_length", "ep_ring_seq",
                     "ep_ring_ptr"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=f"{what} {name}")
        np.testing.assert_allclose(t.return_sum.numpy(), np.asarray(j.return_sum), **REWARD)
        ref = sac_state_from_numpy(np_tree(j.agent), cfg, 10, 2, device="cpu")
        assert t.agent.step == ref.step > 0
        for net in ("actor", "critic", "target_critic"):
            for (name, p), q in zip(getattr(t.agent, net).named_parameters(),
                                    getattr(ref, net).parameters()):
                np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-4,
                                           err_msg=f"{what} {net}.{name}")
        for k, v in j_metrics.items():
            np.testing.assert_allclose(run["tm"][k][i].numpy(), np.asarray(v), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{what} {k}")
    assert int(sum(c.episodes.sum() for c in run["t"])) > 0
    np.testing.assert_allclose(t_pop.population_returns(run["t"]).numpy(),
                               np.asarray(j_pop.population_returns(run["vm"])), **REWARD)


@pytest.mark.parametrize("fraction,seed", [(0.5, 3), (0.25, 4), (0.75, 5)])
def test_clone_winners_equals_the_reference(run, fraction, seed):
    """Returns (agents 0 and 2 tie at 0, agent 3 is the lowest): the stable
    order, the replayed draw and the copies equal the reference's."""
    base = run["carry0"]
    four = jax.tree.map(lambda x: jnp.concatenate([x, x[:1]]), base)   # 4 agents
    four = four.replace(
        return_sum=four.return_sum.at[1, 0].set(5.0).at[3, 1].set(-2.0),
        episodes=four.episodes.at[1, 0].set(1).at[3, 1].set(1),
        # tell the agents apart: agent 3 is a copy of agent 0
        agent=four.agent.replace(log_alpha=jnp.asarray([0.1, 0.2, 0.3, 0.4])))
    key = jax.random.PRNGKey(seed)
    n_cut = max(int(4 * fraction), 1)
    pick = np.asarray(jax.random.randint(key, (n_cut,), 0, n_cut))
    want = j_pop.clone_winners(four, key, fraction)
    pcfg = dataclasses.replace(run["t_pcfg"], num_agents=4)
    t_four = population_from_numpy(np_tree(four), run["t_cfg"], pcfg, device="cpu")
    np.testing.assert_array_equal(t_pop.population_returns(t_four).numpy(),
                                  np.asarray(j_pop.population_returns(four)))
    got = t_pop.clone_winners(t_four, fraction, pick=pick)
    ref = population_from_numpy(np_tree(want), run["t_cfg"], pcfg, device="cpu")
    for i in range(4):
        assert not diff_states(got[i].agent, ref[i].agent), i
        # env, replay, counters and generator stay
        assert got[i].buffer is t_four[i].buffer and got[i].generator is t_four[i].generator
        assert got[i].env_states is t_four[i].env_states
    assert [float(g.agent.log_alpha) for g in got] != [0.1, 0.2, 0.3, 0.4]


def test_ties_keep_agent_order_and_the_draw_comes_from_the_generator():
    cfg = t_sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8)
    pcfg = t_pop.PopulationConfig(num_agents=4, envs_per_agent=4, rollout_steps=2)
    carries = t_pop.init_population(env_params_from_numpy(PARAMS), cfg, pcfg, device="cpu")
    assert torch.equal(t_pop.population_returns(carries), torch.zeros(4))
    got = t_pop.clone_winners(carries, 0.5, pick=[1, 0])   # losers 0, 1; winners 2, 3
    for loser, winner in ((0, 3), (1, 2), (2, 2), (3, 3)):
        assert not diff_states(got[loser].agent, carries[winner].agent), (loser, winner)
    drawn = t_pop.clone_winners(carries, 0.5, generator=torch.Generator().manual_seed(1))
    pick = torch.randint(0, 2, (2,), generator=torch.Generator().manual_seed(1)).tolist()
    for loser, j in zip((0, 1), pick):
        assert not diff_states(drawn[loser].agent, carries[(2, 3)[j]].agent)
    with pytest.raises(ValueError, match="pick"):
        t_pop.clone_winners(carries, 0.5, pick=[0, 2])


def test_no_agent_shares_state_after_the_clone():
    cfg = t_sac.SACConfig((8, 8), batch_size=8, buffer_size=64, learning_starts=8)
    pcfg = t_pop.PopulationConfig(num_agents=3, envs_per_agent=4, rollout_steps=3)
    params = env_params_from_numpy(PARAMS)
    it = t_pop.make_population_iteration(cfg, pcfg)
    carries, _ = it(t_pop.init_population(params, cfg, pcfg, device="cpu", seed=2), params)
    steps = [c.agent.step for c in carries]
    # two losers drawing the same winner must not share it either
    cloned = t_pop.clone_winners(carries, 2 / 3, pick=[1, 1])
    storages = [{p.untyped_storage().data_ptr() for p in [
        *c.agent.actor.parameters(), *c.agent.critic.parameters(),
        *c.agent.target_critic.parameters(), *c.agent.actor_opt.mu, *c.agent.critic_opt.nu,
        c.agent.log_alpha]} for c in cloned]
    for a in range(3):
        for b in range(a + 1, 3):
            assert not storages[a] & storages[b], (a, b)
    after, _ = it(cloned, params)
    for c, before in zip(after, [steps[2], steps[2], steps[2]]):
        # every agent stepped once per update: a shared module would be stepped twice
        assert c.agent.step == c.agent.actor_opt.count == c.agent.critic_opt.count \
            == before + 3
    w = next(iter(after[2].agent.actor.parameters()))
    for loser in (0, 1):
        assert not torch.equal(next(iter(after[loser].agent.actor.parameters())), w)


def test_init_population_gives_distinct_seeded_agents():
    cfg = t_sac.SACConfig((8, 8), batch_size=8, buffer_size=64)
    pcfg = t_pop.PopulationConfig(num_agents=3, envs_per_agent=4)
    params = env_params_from_numpy(PARAMS)
    a = t_pop.init_population(params, cfg, pcfg, device="cpu", seed=0)
    b = t_pop.init_population(params, cfg, pcfg, device="cpu", seed=0)
    assert len(a) == 3 and all(c.obs.shape == (4, 10) for c in a)
    kernels = [c.agent.actor.hidden_0.weight for c in a]
    assert not torch.equal(kernels[0], kernels[1]) and not torch.equal(kernels[1], kernels[2])
    assert all(torch.equal(x.agent.actor.hidden_0.weight, y.agent.actor.hidden_0.weight)
               for x, y in zip(a, b))
    assert not torch.equal(a[0].obs, a[1].obs)
    with pytest.raises(ValueError, match="carries"):
        t_pop.make_population_iteration(cfg, pcfg)(a[:2], params)
