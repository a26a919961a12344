"""The data-parallel ensemble (``mesh.make_sharded_ensemble_train``) against
the JAX package's at world 2, on the CPU.

The JAX side builds ``make_sharded_ensemble_train`` over ``make_mesh(2)`` (16
envs a shard, 8 steps, 2 SAC and 2 TD3 updates a step once the gate opens at
the second step, the shard's replay wrapping at the seventh) and runs one
iteration with sac acting and one with ppo acting (2 epochs x 2 minibatches),
each from the reference's sharded ``init_fn``. The port runs the same two
iterations on two gloo ranks (``test_torch_parallel.run_world``), each rank
from its shard of the JAX carry with its own folded key chain's draws
(``test_torch_parity_utils.ensemble_draws``; PPO's permutations come from the
replicated key, alike on both ranks, as in the reference). Bars: each rank's
env shard, obs, replay rows and counters at the env bars, the three
replicated members against JAX at 1e-4 (their Adam moments plus 1e-5
relative), metrics 1e-3 relative; the members, the replay pointers and the
metrics bit for bit the same on both ranks. ``init_fn`` is held as in
``test_torch_parallel.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import (
    JAX_PARAMS,
    LEARNERS,
    OBS_BAR,
    SEED,
    WORLD,
    assert_flat_close,
    assert_metrics_close,
    assert_replicas_equal,
    run_world,
)
from test_torch_parity_utils import (
    KeyChain,
    ensemble_draws,
    permutations,
    record_env_keys_sharded,
    shard_of,
)
from tvc_ai_torch.agents import ensemble as t_ens
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.agents import td3 as t_td3
from tvc_ai_torch.convert import env_params_from_numpy, ensemble_carry_from_numpy, env_state_from_numpy
from tvc_ai_torch.parallel import mesh as t_mesh
from tvc_ai_torch.utils.checkpoint import flat_state
from tvc_ai_tpu.agents import ensemble as j_ens
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.agents import td3 as j_td3
from tvc_ai_tpu.parallel import mesh as j_mesh

torch.set_num_threads(1)
N, STEPS, UPDATES = 16, 8, 2
SAC = dict(hidden_dims=(32, 32), batch_size=16, buffer_size=192, learning_starts=64,
           gradient_clip_norm=5.0, reward_scale=0.05)
TD3 = dict(hidden_dims=(32, 32), batch_size=8)
PPO = dict(hidden_dims=(32, 32), n_epochs=2, num_minibatches=2)
WEIGHTS = np.array([0.2, 0.5, 0.3], np.float32)
ACTORS = ("sac", "ppo")
MEMBERS = ("sac.", "td3.", "ppo.")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    mesh = j_mesh.make_mesh(WORLD)
    params = JAX_PARAMS
    j_cfg = j_ens.EnsembleConfig(sac=j_sac.SACConfig(**SAC), td3=j_td3.TD3Config(**TD3),
                                 ppo=j_ppo.PPOConfig(**PPO))
    t_cfg = t_ens.EnsembleConfig(sac=t_sac.SACConfig(**SAC), td3=t_td3.TD3Config(**TD3),
                                 ppo=t_ppo.PPOConfig(**PPO))
    t_local, n_local = t_mesh.local_ensemble_config(t_cfg, WORLD * N, WORLD)
    assert n_local == N and (t_local.sac.buffer_size, t_local.sac.learning_starts) == (96, 32)
    key = jax.random.PRNGKey(SEED)

    def run():
        init_fn, train_fns = j_mesh.make_sharded_ensemble_train(
            mesh, params, j_cfg, WORLD * N, STEPS, UPDATES)
        out = {}
        for actor in ACTORS:
            carry0 = init_fn(key)
            shards0 = [shard_of(carry0, r) for r in range(WORLD)]   # before the donation
            out[actor] = (shards0, *train_fns[actor](carry0, jnp.asarray(WEIGHTS), params))
        return out

    results, env_keys = record_env_keys_sharded(run, WORLD, True)
    chain = KeyChain(params)
    cap = t_local.sac.buffer_size - t_local.sac.buffer_size % N
    sizes = [min((t + 1) * N, cap) for t in range(STEPS)]
    cases, refs = {}, {}
    for a, actor in enumerate(ACTORS):
        shards0, j_carry, j_m = results[actor]
        case = dict(kind="ensemble", actor=actor, cfg=t_cfg, n=N, steps=STEPS, updates=UPDATES,
                    weights=WEIGHTS, params=env_params_from_numpy(params), carry=[], draws=[],
                    init_draws=[], perms=None)
        ref = dict(carry=[], init_env=[], init_obs=[], metrics={k: float(v) for k, v in j_m.items()})
        for r in range(WORLD):
            carry = ensemble_carry_from_numpy(shards0[r], t_local, device="cpu")
            case["carry"].append(dataclasses.replace(carry, generator=None))
            draws, key_after = ensemble_draws(chain, shards0[r].key,
                                              env_keys[r][a * STEPS:(a + 1) * STEPS], sizes,
                                              actor, t_local, N, STEPS, UPDATES, rank=r)
            case["draws"].append(draws)
            if actor == "ppo":
                case["perms"] = permutations(key_after, STEPS * N, t_cfg.ppo.n_epochs)
            case["init_draws"].append(chain.reset(jax.random.split(jax.random.fold_in(key, r), N)))
            ref["init_env"].append(flat_state(env_state_from_numpy(shards0[r].env_states, "cpu")))
            ref["init_obs"].append(torch.from_numpy(np.array(shards0[r].obs)))
            done = ensemble_carry_from_numpy(shard_of(j_carry, r), t_local, device="cpu")
            ref["carry"].append(flat_state(dataclasses.replace(done, generator=None)))
        cases[f"ensemble_{actor}"], refs[f"ensemble_{actor}"] = case, ref
    outs = run_world(cases, tmp_path_factory.mktemp("world2_ensemble"))
    return refs, outs


@pytest.mark.parametrize("actor", ACTORS)
def test_ensemble_shards_match_jax(world2, actor):
    refs, outs = world2
    name = f"ensemble_{actor}"
    for r, out in enumerate(o[name] for o in outs):
        got = {p: v for p, v in out["carry"].items() if not p.startswith(LEARNERS)}
        want = {p: v for p, v in refs[name]["carry"][r].items() if not p.startswith(LEARNERS)}
        assert_flat_close(got, want, None, f"{name} rank {r}")
    assert int(outs[0][name]["carry"]["env_steps"].sum()) == N * STEPS


@pytest.mark.parametrize("actor", ACTORS)
def test_ensemble_members_match_jax(world2, actor):
    refs, outs = world2
    name = f"ensemble_{actor}"
    for r, out in enumerate(o[name] for o in outs):
        got = {p: v for p, v in out["carry"].items() if p.startswith(MEMBERS)}
        want = {p: v for p, v in refs[name]["carry"][r].items() if p.startswith(MEMBERS)}
        assert_flat_close(got, want, 1e-4, f"{name} rank {r}")
        assert_metrics_close({k: float(v) for k, v in out["metrics"].items()},
                             refs[name]["metrics"], f"{name} rank {r}")
    carry = outs[0][name]["carry"]
    assert carry["sac.step"] == carry["td3.step"] == UPDATES * (STEPS - 1)
    assert carry["ppo.step"] == (4 if actor == "ppo" else 0)


@pytest.mark.parametrize("actor", ACTORS)
def test_ensemble_replicas_bit_identical(world2, actor):
    a, b = (o[f"ensemble_{actor}"] for o in world2[1])
    assert_replicas_equal(a["carry"], b["carry"], MEMBERS + ("buffer.ptr", "buffer.size"), actor)
    assert all(torch.equal(a["metrics"][k], b["metrics"][k]) for k in a["metrics"])
    assert not torch.equal(a["carry"]["env_states.body.pos"], b["carry"]["env_states.body.pos"])


def test_sharded_ensemble_init_fn(world2):
    refs, outs = world2
    for r, out in enumerate(o["ensemble_sac"] for o in outs):
        assert_flat_close(out["init_env"], refs["ensemble_sac"]["init_env"][r], None,
                          f"init {r}")
        torch.testing.assert_close(out["init_obs"], refs["ensemble_sac"]["init_obs"][r],
                                   **OBS_BAR)
    assert_replicas_equal(outs[0]["ensemble_sac"]["init_members"],
                          outs[1]["ensemble_sac"]["init_members"], ("",), "init members")
