"""The whole slice: ``training.loop.collect`` against the JAX composition (CPU).

The JAX side is the act-and-simulate body of
``tvc_ai_tpu/training/loop.py::make_train_iteration`` with ``history_len=1``:
``sac.select_action`` (the actor plus a tanh-Gaussian sample), ``apply_safety``,
then ``batched_step_autoreset`` through the Pallas kernel in interpret mode.
The port runs ``collect`` for the same 16 steps from the same reset, with the
same actor weights (``actor_from_flax``) and the draws JAX consumed (the
exploration noise of each step's action key and the env key chain's draws).
The port runs free, never re-synced from JAX. Bars as the env tests: obs
5e-5 / 5e-4, reward 1e-3 / 1e-3, terminated and truncated exactly equal.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_parity_utils import KeyChain, assert_state_close
from tvc_ai_torch.convert import actor_from_flax, env_params_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.models.mlp import GaussianActor as TActor
from tvc_ai_torch.models.safety import SafetyConstraints as TSafety
from tvc_ai_torch.training.loop import collect
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.models.mlp import GaussianActor as JActor
from tvc_ai_tpu.models.safety import SafetyConstraints, apply_safety

torch.set_num_threads(1)
N, STEPS, HIDDEN = 64, 16, (64, 64)


def test_collect_matches_jax_composition():
    jp = EnvParams(
        randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
        max_episode_steps=8,
    )
    tp = env_params_from_numpy(jp)
    chain = KeyChain(jp)
    params = JActor(action_dim=2, hidden_dims=HIDDEN).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 10))
    )
    cfg = j_sac.SACConfig(hidden_dims=HIDDEN)
    agent = j_sac.SACState(actor_params=params, critic_params=None, target_critic_params=None,
                           log_alpha=jnp.float32(0.0), actor_opt=None, critic_opt=None,
                           alpha_opt=None, step=jnp.int32(0))

    @jax.jit
    def j_body(states, obs, k_act):
        actions = j_sac.select_action(agent, obs, k_act, cfg, 2)
        actions, _ = apply_safety(obs, actions, SafetyConstraints())
        states, out, next_obs = j_env.batched_step_autoreset(
            states, actions, jp, use_pallas=True, block_envs=N, interpret=True
        )
        return states, next_obs, out

    keys = jax.random.split(jax.random.PRNGKey(31), N)
    j_states, j_obs = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    t_states, t_obs = t_env.reset(tp, N, device="cpu", draws=chain.reset(keys))

    draws, rewards, terminated, truncated = [], [], [], []
    key = jax.random.PRNGKey(32)
    for _ in range(STEPS):
        key, k_act = jax.random.split(key)
        n_act = torch.from_numpy(np.array(jax.random.normal(k_act, (N, 2))))
        draws.append(dataclasses.replace(chain.step(j_states.key), n_act=n_act))
        j_states, j_obs, out = j_body(j_states, j_obs, k_act)
        rewards.append(np.asarray(out.reward))
        terminated.append(np.asarray(out.terminated))
        truncated.append(np.asarray(out.truncated))

    actor = TActor(10, 2, HIDDEN, device="cpu")
    actor.load_state_dict(actor_from_flax(jax.tree.map(np.asarray, params)))
    ro = collect(actor, t_states, t_obs, tp, STEPS, safety=TSafety(), draws=draws)

    np.testing.assert_allclose(ro.reward.numpy(), np.stack(rewards), atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(ro.terminated.numpy(), np.stack(terminated))
    np.testing.assert_array_equal(ro.truncated.numpy(), np.stack(truncated))
    np.testing.assert_allclose(ro.obs.numpy(), np.asarray(j_obs), atol=5e-5, rtol=5e-4)
    assert_state_close(ro.states, j_states, what="after collect")
    assert int((ro.terminated | ro.truncated).sum()) >= N  # autoresets fired
