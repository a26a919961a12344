"""The hoisted-bookkeeping chunk path under data parallel, against the JAX
package's ``shard_map`` at world 2 (CPU).

The JAX side runs ``mesh.make_sharded_train`` over ``make_mesh(2)`` with
``hoist_bookkeeping`` and ``update_interval`` 2 (16 envs a shard, 8 steps:
the gate opens at the second chunk, each shard's replay wraps at the
fourth); the port runs the same through its ``make_sharded_train`` on two
gloo ranks (``test_torch_parallel.run_world``), each rank from its JAX shard
with the draws of its own folded key chain in the hoisted layout
(``test_torch_parity_utils.hoisted_iteration_draws`` with ``rank``). Bars
are ``test_torch_parallel.py``'s for the loop: every rank's env shard, obs,
replay rows, counters and ring at the env bars, the replicated agent at
1e-4 (Adam moments plus 1e-5 relative), metrics 1e-3 relative, ``summarize``
and ``drain_episodes`` against the JAX global ones, and the replicated
tensors bit for bit equal on both ranks.
"""

from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

from test_torch_parallel import (
    JAX_PARAMS,
    LEARNERS,
    LOOP,
    LOOP_SAC,
    N,
    SEED,
    STEPS,
    WORLD,
    assert_flat_close,
    assert_metrics_close,
    assert_replicas_equal,
    run_world,
)
from test_torch_parity_utils import (
    KeyChain,
    hoisted_iteration_draws,
    record_env_keys_sharded,
    shard_of,
)
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import env_params_from_numpy, env_state_from_numpy, train_carry_from_numpy
from tvc_ai_torch.parallel import mesh as t_mesh
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.utils.checkpoint import flat_state
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.parallel import mesh as j_mesh
from tvc_ai_tpu.training import loop as j_loop

torch.set_num_threads(1)
K = 2
HOISTED = dict(LOOP, update_interval=K, hoist_bookkeeping=True)


def hoisted_case(mesh):
    params = JAX_PARAMS
    j_sac_cfg, t_sac_cfg = j_sac.SACConfig(**LOOP_SAC), t_sac.SACConfig(**LOOP_SAC)
    j_loop_cfg, t_loop_cfg = j_loop.TrainLoopConfig(**HOISTED), t_loop.TrainLoopConfig(**HOISTED)
    t_local_sac, t_local_loop = t_mesh.local_configs(t_sac_cfg, t_loop_cfg, WORLD)
    j_local_sac = dataclasses.replace(j_sac_cfg, buffer_size=t_local_sac.buffer_size,
                                      learning_starts=t_local_sac.learning_starts)
    j_local_loop = dataclasses.replace(j_loop_cfg, num_envs=N)
    assert j_loop.make_train_iteration(j_local_sac, j_local_loop).hoisted
    init_fn, train_fn = j_mesh.make_sharded_train(mesh, params, j_sac_cfg, j_loop_cfg)
    key = jax.random.PRNGKey(SEED)
    carry0 = init_fn(key)
    shards0 = [shard_of(carry0, r) for r in range(WORLD)]
    (j_carry, j_m), env_keys = record_env_keys_sharded(lambda: train_fn(carry0, params),
                                                       WORLD, False)
    chain = KeyChain(params)
    cap = t_local_sac.buffer_size - t_local_sac.buffer_size % N
    sizes = [min((t + 1) * N, cap) for t in range(STEPS)]
    case = dict(kind="loop", params=env_params_from_numpy(params), sac_cfg=t_sac_cfg,
                loop_cfg=t_loop_cfg, carry=[], draws=[], init_draws=[])
    ref = dict(carry=[], init_env=[], sizes=sizes,
               metrics={k: float(v) for k, v in j_m.items()},
               summary=j_loop.summarize(j_carry), episodes=j_loop.drain_episodes(j_carry, -1))
    for r in range(WORLD):
        carry = train_carry_from_numpy(shards0[r], t_local_sac, t_local_loop, device="cpu")
        case["carry"].append(dataclasses.replace(carry, generator=None))
        case["draws"].append(hoisted_iteration_draws(chain, shards0[r].key, env_keys[r], sizes,
                                                     t_local_sac, t_local_loop, rank=r))
        case["init_draws"].append(chain.reset(jax.random.split(jax.random.fold_in(key, r), N)))
        ref["init_env"].append(flat_state(env_state_from_numpy(shards0[r].env_states, "cpu")))
        done = train_carry_from_numpy(shard_of(j_carry, r), t_local_sac, t_local_loop,
                                      device="cpu")
        ref["carry"].append(flat_state(dataclasses.replace(done, generator=None)))
    return case, ref


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    case, ref = hoisted_case(j_mesh.make_mesh(WORLD))
    outs = run_world({"hoisted": case}, tmp_path_factory.mktemp("world2_hoisted"))
    return case, ref, [o["hoisted"] for o in outs]


def test_hoisted_shards_match_jax(world2):
    _, ref, outs = world2
    for r, out in enumerate(outs):
        got = {p: v for p, v in out["carry"].items() if not p.startswith(LEARNERS)}
        want = {p: v for p, v in ref["carry"][r].items() if not p.startswith(LEARNERS)}
        assert_flat_close(got, want, None, f"hoisted rank {r}")
        assert_flat_close(out["init_env"], ref["init_env"][r], None, f"hoisted init {r}")
        assert out["carry"]["buffer.ptr"] == (STEPS * N) % int(out["carry"]["buffer.capacity"])


def test_hoisted_agent_matches_jax(world2):
    case, ref, outs = world2
    for r, out in enumerate(outs):
        got = {p: v for p, v in out["carry"].items() if p.startswith(LEARNERS)}
        want = {p: v for p, v in ref["carry"][r].items() if p.startswith(LEARNERS)}
        assert_flat_close(got, want, 1e-4, f"hoisted rank {r}")
    local_gate = case["sac_cfg"].learning_starts // WORLD
    events = sum(size >= local_gate for t, size in enumerate(ref["sizes"]) if t % K == K - 1)
    assert outs[0]["carry"]["agent.step"] == events
    assert 0 < events < STEPS // K


def test_hoisted_replicas_bit_identical(world2):
    a, b = world2[2]
    assert_replicas_equal(a["carry"], b["carry"], LEARNERS + ("buffer.ptr", "buffer.size",
                                                              "env_steps_host"), "hoisted")
    assert all(torch.equal(a["metrics"][k], b["metrics"][k]) for k in a["metrics"])
    assert not torch.equal(a["carry"]["env_states.body.pos"], b["carry"]["env_states.body.pos"])


def test_hoisted_metrics_summarize_and_drain_match_jax(world2):
    _, ref, outs = world2
    for r, out in enumerate(outs):
        assert_metrics_close({k: float(v) for k, v in out["metrics"].items()}, ref["metrics"],
                             f"hoisted rank {r}")
        for k, v in ref["summary"].items():
            assert out["summary"][k] == pytest.approx(v, rel=1e-3), k
        assert out["summary"]["env_steps"] == WORLD * N * STEPS
        episodes, last = out["episodes"]
        want, want_last = ref["episodes"]
        assert last == want_last and len(episodes) == len(want) > 0
        for (tr, tl, ts), (jr, jl, js) in zip(episodes, want):
            assert (tl, ts) == (jl, js)
            assert tr == pytest.approx(jr, rel=1e-3, abs=1e-3)


def test_hoisted_local_gate_uses_the_rank_buffer():
    """The gate reads the rank's ``buffer_size``: 192 over 2 ranks is 96
    rows, whole chunks of 2 × 16 but not of 4 × 16."""
    sac_cfg = t_sac.SACConfig(**LOOP_SAC)
    local_sac, local_loop = t_mesh.local_configs(
        sac_cfg, t_loop.TrainLoopConfig(**HOISTED), WORLD)
    assert t_loop.make_train_iteration(local_sac, local_loop).hoisted
    four = t_mesh.local_configs(sac_cfg, t_loop.TrainLoopConfig(**dict(HOISTED, update_interval=4)),
                                WORLD)
    with pytest.raises(ValueError, match="hoist_bookkeeping"):
        t_loop.make_train_iteration(*four)
