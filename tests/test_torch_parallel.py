"""Data parallel (``tvc_ai_torch/parallel/mesh.py``) against the JAX package's
``shard_map`` at world 2, on the CPU.

The JAX side runs each case over ``make_mesh(2)``, two of the virtual CPU
devices ``tests/conftest.py`` provides: three ``sac.update``s and four
``td3.update``s with ``axis_name`` (each shard its own batch and key), PPO's
fused iteration (``ppo.make_train_iteration``, one PPO phase of 2 epochs x 2
minibatches), and the fused SAC loop for one 8-step iteration of 16 envs a
shard, once plain (``mesh.make_sharded_train``: the gate opens mid-way, the
ring overflows) and once with ICM + the physics-informed loss + RND +
hierarchical RL (the reference's iteration under ``shard_map`` with its
``carry_specs``: ``make_sharded_train``'s metric specs name the plain loop's
metrics only).

The port runs the same cases in two processes joined by gloo
(``torch.multiprocessing`` spawn, a ``file://`` rendezvous, a join time
limit; ``run_world``, which ``test_torch_parallel_ensemble.py`` shares). Each
rank starts from its shard of the JAX state (``shard_of``) and takes the
draws of its own folded key chain, with the env keys each JAX shard consumed
recorded (``test_torch_parity_utils``). The loop and ensemble cases go
through ``mesh.make_sharded_train`` / ``make_sharded_ensemble_train``, whose
``init_fn`` is held too (each rank's reset on the replayed
``fold_in(key, rank)`` draws equals the JAX shard's, and its agent is the
same on both ranks).

Bars: every rank's env shard, obs and replay rows at the env bars (obs
5e-5 / 5e-4, reward 1e-3, flags and counts exact); the replicated learners
against JAX at 1e-5 after the SAC and TD3 updates, 1e-4 after the PPO phase
and the loop (the loop's bars), their Adam moments at the same absolute bar
plus 1e-5 relative; metrics 1e-3 relative; ``summarize`` against
the JAX global totals (1e-3 relative) and ``drain_episodes`` against the JAX
drain of the concatenated shards. Every replicated tensor (parameters,
optimizer moments, counts, metrics) is bit for bit the same on both ranks.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from test_torch_parity_utils import (
    DATA_AXIS,
    KeyChain,
    iteration_draws,
    np_tree,
    permutations,
    record_env_keys_sharded,
    shard_of,
    to_torch,
    update_draws,
)
from tvc_ai_torch.agents import ppo as t_ppo
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.agents import td3 as t_td3
from tvc_ai_torch.convert import (
    env_params_from_numpy,
    env_state_from_numpy,
    ppo_state_from_numpy,
    sac_state_from_numpy,
    td3_state_from_numpy,
    train_carry_from_numpy,
)
from tvc_ai_torch.parallel import mesh as t_mesh
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.utils.checkpoint import flat_state
from tvc_ai_tpu.agents import ppo as j_ppo
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.agents import td3 as j_td3
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.parallel import mesh as j_mesh
from tvc_ai_tpu.training import loop as j_loop

torch.set_num_threads(1)
WORLD, N, STEPS, OBS, ACT, SEED = 2, 16, 8, 10, 2, 7
JOIN_SECONDS = 240
OBS_BAR = dict(atol=5e-5, rtol=5e-4)
REWARD_BAR = dict(atol=1e-3, rtol=1e-3)
METRICS_BAR = dict(atol=1e-5, rtol=1e-3)
MOMENTS_RTOL = 1e-5
JAX_PARAMS = EnvParams(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True),
                       max_episode_steps=4)
UPDATE_SAC = dict(hidden_dims=(32, 32), batch_size=16, gradient_clip_norm=0.5,
                  reward_scale=0.05)
UPDATE_TD3 = dict(hidden_dims=(32, 32), batch_size=16, gradient_clip_norm=0.5)
PPO = dict(hidden_dims=(32, 32), n_epochs=2, num_minibatches=2)
LOOP_SAC = dict(hidden_dims=(32, 32), batch_size=16, buffer_size=192, learning_starts=96,
                gradient_clip_norm=5.0, reward_scale=0.05)
LOOP = dict(num_envs=WORLD * N, rollout_steps=STEPS, use_safety_layer=True, episode_ring_size=8)
EXTENSIONS = dict(use_curiosity=True, use_physics_informed=True, use_rnd=True,
                  use_hierarchical=True)
LEARNERS = ("agent.", "icm.", "rnd.", "hier.", "sac.", "td3.", "ppo.")   # replicated


# ---------------------------------------------------------------- the port's ranks
def _sac_updates(case, rank):
    state, metrics = case["state"], []
    for batch, draws in zip(case["batches"][rank], case["draws"][rank]):
        if case["algo"] == "sac":
            state, m = t_sac.update(state, batch, case["cfg"], draws, axis_name=DATA_AXIS)
        else:
            state, m = t_td3.update(state, batch, case["cfg"], draws, axis_name=DATA_AXIS)
        metrics.append({k: v.clone() for k, v in m.items()})
    return {"learner": flat_state(state), "metrics": metrics}


def _ppo_iteration(case, rank):
    it = t_ppo.make_train_iteration(case["cfg"], N, STEPS, OBS, ACT, axis_name=DATA_AXIS)
    state, env_states, obs, _, metrics = it(case["state"], case["env_states"][rank],
                                            case["obs"][rank], None, case["params"],
                                            case["draws"][rank], case["perms"][rank])
    return {"learner": flat_state(state), "env": flat_state(env_states), "obs": obs,
            "metrics": metrics}


def _loop_iteration(case, rank):
    init_fn, train_fn = t_mesh.make_sharded_train(case["params"], case["sac_cfg"],
                                                  case["loop_cfg"], "cpu")
    fresh = init_fn(SEED, reset_draws=case["init_draws"][rank])
    carry = dataclasses.replace(case["carry"][rank], generator=torch.Generator().manual_seed(rank))
    carry, metrics = train_fn(carry, case["params"], case["draws"][rank])
    return {"init_env": flat_state(fresh.env_states), "init_obs": fresh.obs,
            "init_agent": flat_state(fresh.agent),
            "carry": flat_state(dataclasses.replace(carry, generator=None)), "metrics": metrics,
            "summary": t_loop.summarize(carry, DATA_AXIS),
            "episodes": t_loop.drain_episodes(carry, -1, DATA_AXIS)}


def _ensemble_iteration(case, rank):
    init_fn, train_fns = t_mesh.make_sharded_ensemble_train(
        case["params"], case["cfg"], WORLD * case["n"], case["steps"], case["updates"], "cpu")
    fresh = init_fn(SEED, reset_draws=case["init_draws"][rank])
    carry = dataclasses.replace(case["carry"][rank], generator=torch.Generator().manual_seed(rank))
    carry, metrics = train_fns[case["actor"]](carry, case["weights"], case["params"],
                                              case["draws"][rank], case["perms"])
    return {"init_env": flat_state(fresh.env_states), "init_obs": fresh.obs,
            "init_members": flat_state([fresh.sac, fresh.td3, fresh.ppo]),
            "carry": flat_state(dataclasses.replace(carry, generator=None)), "metrics": metrics}


def _collectives(case, rank):
    """pmean_, psum_, all_gather_host and broadcast_object on rank-made values."""
    xs = [torch.full((3,), float(rank + 1)), torch.tensor(4.0 * rank)]
    t_mesh.pmean_(xs, DATA_AXIS)
    return {"pmean": xs,
            "psum": t_mesh.psum_host([torch.tensor(rank + 1), torch.tensor(0.5)], DATA_AXIS),
            "gather": t_mesh.all_gather_host(torch.tensor([[rank, 10 + rank]]), DATA_AXIS),
            "broadcast": t_mesh.broadcast_object({"from": rank}),
            "counts": dict(t_mesh.counts)}


RUNNERS = {"updates": _sac_updates, "ppo": _ppo_iteration, "loop": _loop_iteration,
           "ensemble": _ensemble_iteration, "collectives": _collectives}


def _worker(rank: int, root: str, world: int) -> None:
    torch.set_num_threads(1)
    t_mesh.init_data_parallel("cpu", backend="gloo", init_method=f"file://{root}/rendezvous",
                              rank=rank, world_size=world)
    cases = torch.load(Path(root) / "cases.pt", weights_only=False)
    out = {name: RUNNERS[case["kind"]](case, rank) for name, case in cases.items()}
    torch.save(out, Path(root) / f"out{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def run_world(cases: dict, root: Path, world: int = WORLD) -> list[dict]:
    """Run ``cases`` on ``world`` gloo ranks (spawned processes, one
    rendezvous, all cases in one spawn); each rank's outputs by case."""
    root.mkdir(parents=True, exist_ok=True)
    torch.save(cases, root / "cases.pt")
    ctx = mp.start_processes(_worker, args=(str(root), world), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"world-{world} ranks did not finish in {JOIN_SECONDS} s")
    return [torch.load(root / f"out{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- comparisons
def _bar(path: str, value, learner_atol: float | None):
    """None: exact; else the tolerance of ``path``: ``learner_atol`` for a
    learner's tensors (every float tensor when ``learner_atol`` is given and
    the path names no carry field), the env bars for the rest."""
    if not isinstance(value, torch.Tensor) or not value.is_floating_point():
        return None
    if path.startswith(LEARNERS):
        return dict(atol=learner_atol, rtol=0.0)
    if path.endswith(".done"):
        return None
    if ".dr." in path or path.startswith("dr."):
        return dict(atol=1e-6, rtol=1e-6)
    if any(k in path for k in ("reward", "return", "length_sum")):
        return REWARD_BAR
    return OBS_BAR


def assert_flat_close(port: dict, ref: dict, learner_atol: float | None, what: str,
                      learner: bool = False) -> None:
    """Two ``flat_state``s path by path: ``learner`` holds every float
    tensor at ``learner_atol``, otherwise ``_bar`` picks by path."""
    assert sorted(port) == sorted(ref), (what, sorted(set(port) ^ set(ref)))
    for path, want in ref.items():
        got = port[path]
        bar = _bar(path, want, learner_atol)
        if learner and bar is not None:
            bar = dict(atol=learner_atol, rtol=0.0)
        if bar is not None and (".mu[" in path or ".nu[" in path):
            # Adam's moments of the summed gradients reach ~300 (the ICM's
            # second moment), where float32's spacing is 3e-5
            bar = dict(atol=learner_atol, rtol=MOMENTS_RTOL)
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and got.shape == want.shape, (what, path)
            if bar is None:
                assert torch.equal(got, want), (what, path)
            else:
                torch.testing.assert_close(got, want, **bar, msg=lambda m: f"{what} {path}: {m}")
        else:
            assert got == want, (what, path, got, want)


def assert_replicas_equal(a: dict, b: dict, prefixes, what: str) -> None:
    """The replicated tensors of two ranks' ``flat_state`` bit for bit."""
    paths = [p for p in a if p.startswith(prefixes)]
    assert paths, what
    for path in paths:
        x, y = a[path], b[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, path)
        else:
            assert x == y, (what, path)


def assert_metrics_close(port: dict, ref: dict, what: str) -> None:
    assert sorted(port) == sorted(ref), what
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(port[k]), np.asarray(v), **METRICS_BAR,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------- the JAX cases
def _random_batch(rng, rows: int) -> dict[str, np.ndarray]:
    f32 = np.float32
    return {"obs": rng.normal(size=(rows, OBS)).astype(f32),
            "action": rng.uniform(-1.0, 1.0, size=(rows, ACT)).astype(f32),
            "reward": (rng.normal(size=rows) * 30.0).astype(f32),
            "next_obs": rng.normal(size=(rows, OBS)).astype(f32),
            "done": (rng.uniform(size=rows) < 0.2).astype(f32)}


def updates_case(mesh, algo: str, updates: int):
    """``updates`` SAC or TD3 updates with ``axis_name``: each shard its own
    batch rows and key, the state replicated."""
    j_mod, t_mod = (j_sac, t_sac) if algo == "sac" else (j_td3, t_td3)
    kw = UPDATE_SAC if algo == "sac" else UPDATE_TD3
    j_cfg = (j_sac.SACConfig if algo == "sac" else j_td3.TD3Config)(**kw)
    t_cfg = (t_sac.SACConfig if algo == "sac" else t_td3.TD3Config)(**kw)
    b = j_cfg.batch_size
    state0 = j_mod.init(jax.random.PRNGKey(1), OBS, ACT, j_cfg)
    rng = np.random.default_rng(3)
    batches = [_random_batch(rng, WORLD * b) for _ in range(updates)]
    stacked = {k: np.stack([bt[k] for bt in batches]) for k in batches[0]}
    keys = jax.random.split(jax.random.PRNGKey(2), WORLD * updates).reshape(WORLD, updates, 2)

    def local(state, batch, keys):
        ms = []
        for u in range(updates):
            state, m = j_mod.update(state, {k: v[u] for k, v in batch.items()}, keys[0, u],
                                    j_cfg, OBS, ACT, axis_name=DATA_AXIS)
            ms.append(m)
        return state, jax.tree.map(lambda *x: jnp.stack(x)[None], *ms)

    j_state, j_m = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(None, DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P(DATA_AXIS))))(state0, stacked, keys)
    convert = sac_state_from_numpy if algo == "sac" else td3_state_from_numpy
    port_batches, draws = [], []
    for r in range(WORLD):
        rows = slice(r * b, (r + 1) * b)
        port_batches.append([{k: torch.from_numpy(bt[k][rows]) for k in bt} for bt in batches])
        if algo == "sac":
            draws.append([update_draws(keys[r, u], b, ACT) for u in range(updates)])
        else:
            draws.append([to_torch(jax.random.normal(keys[r, u], (b, ACT)))
                          for u in range(updates)])
    case = dict(kind="updates", algo=algo, cfg=t_cfg, batches=port_batches, draws=draws,
                state=convert(np_tree(state0), t_cfg, OBS, ACT, device="cpu"))
    ref = dict(learner=flat_state(convert(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")),
               metrics=[[{k: float(v[r, u]) for k, v in j_m.items()} for u in range(updates)]
                        for r in range(WORLD)])
    return case, ref


def ppo_case(mesh):
    """One ``ppo.make_train_iteration`` of 16 envs x 8 steps a shard, with
    ``axis_name``; each shard its own key."""
    j_cfg, t_cfg = j_ppo.PPOConfig(**PPO), t_ppo.PPOConfig(**PPO)
    params = JAX_PARAMS
    state0 = j_ppo.init(jax.random.PRNGKey(4), OBS, ACT, j_cfg)
    env_keys0 = jax.random.split(jax.random.PRNGKey(5), WORLD * N)
    states0, obs0 = jax.vmap(j_env.reset, in_axes=(0, None))(env_keys0, params)
    keys = jax.random.split(jax.random.PRNGKey(6), WORLD)

    def run():
        it = j_ppo.make_train_iteration(j_cfg, N, STEPS, OBS, ACT, axis_name=DATA_AXIS)

        def local(state, env_states, obs, keys):
            state, env_states, obs, key, m = it(state, env_states, obs, keys[0], params)
            return state, env_states, obs, key[None], m

        return jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P())))(
                state0, states0, obs0, keys)

    (j_state, j_states, j_obs, _, j_m), env_keys = record_env_keys_sharded(run, WORLD, True)
    chain, rows = KeyChain(params), slice(None)
    case = dict(kind="ppo", cfg=t_cfg, params=env_params_from_numpy(params),
                state=ppo_state_from_numpy(np_tree(state0), t_cfg, OBS, ACT, device="cpu"),
                env_states=[], obs=[], draws=[], perms=[])
    ref = dict(learner=flat_state(ppo_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT,
                                                       device="cpu")),
               env=[], obs=[], metrics={k: float(v) for k, v in j_m.items()})
    for r in range(WORLD):
        rows = slice(r * N, (r + 1) * N)
        case["env_states"].append(env_state_from_numpy(jax.tree.map(
            lambda x: np.asarray(x)[rows], states0), "cpu"))
        case["obs"].append(torch.from_numpy(np.array(obs0)[rows]))
        key, draws = keys[r], []
        for t in range(STEPS):
            key, k_act = jax.random.split(key)
            draws.append(dataclasses.replace(chain.step(env_keys[r][t]),
                                             n_act=to_torch(jax.random.normal(k_act, (N, ACT)))))
        case["draws"].append(draws)
        case["perms"].append(permutations(key, STEPS * N, j_cfg.n_epochs))
        ref["env"].append(flat_state(env_state_from_numpy(shard_of(j_states, r), "cpu")))
        ref["obs"].append(torch.from_numpy(shard_of(j_obs, r)))
    return case, ref


def loop_case(mesh, extensions: bool):
    """One fused SAC iteration over the mesh from the reference's sharded
    ``init_fn``: plain through ``make_sharded_train``'s ``train_fn``; with the
    extensions through the same iteration under ``shard_map`` with
    ``carry_specs`` and every metric of the iteration."""
    params = JAX_PARAMS
    extra = EXTENSIONS if extensions else {}
    j_sac_cfg, t_sac_cfg = j_sac.SACConfig(**LOOP_SAC), t_sac.SACConfig(**LOOP_SAC)
    j_loop_cfg = j_loop.TrainLoopConfig(**LOOP, **extra)
    t_loop_cfg = t_loop.TrainLoopConfig(**LOOP, **extra)
    if extensions:
        # RND's predictor steps at env steps 0, 3, 6
        j_loop_cfg = dataclasses.replace(
            j_loop_cfg, rnd=dataclasses.replace(j_loop_cfg.rnd, update_frequency=3))
        t_loop_cfg = dataclasses.replace(
            t_loop_cfg, rnd=dataclasses.replace(t_loop_cfg.rnd, update_frequency=3))
    init_fn, train_fn = j_mesh.make_sharded_train(mesh, params, j_sac_cfg, j_loop_cfg)
    t_local_sac, t_local_loop = t_mesh.local_configs(t_sac_cfg, t_loop_cfg, WORLD)
    j_local_sac = dataclasses.replace(j_sac_cfg, buffer_size=t_local_sac.buffer_size,
                                      learning_starts=t_local_sac.learning_starts)
    j_local_loop = dataclasses.replace(j_loop_cfg, num_envs=N)
    assert (t_local_loop.num_envs, t_local_sac.buffer_size, t_local_sac.learning_starts) == (
        N, j_sac_cfg.buffer_size // WORLD, j_sac_cfg.learning_starts // WORLD)
    if extensions:
        it = j_loop.make_train_iteration(j_local_sac, j_local_loop, axis_name=DATA_AXIS)
        abstract = jax.eval_shape(
            lambda k: j_loop.init_carry(k, params, j_local_sac, j_local_loop),
            jax.random.PRNGKey(0))
        names = jax.eval_shape(j_loop.make_train_iteration(j_local_sac, j_local_loop),
                               abstract, params)[1]
        specs = j_mesh.carry_specs(abstract)
        train_fn = jax.jit(jax.shard_map(
            it, mesh=mesh, in_specs=(specs, jax.tree.map(lambda _: P(), params)),
            out_specs=(specs, {k: P() for k in names})))
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
    ref = dict(carry=[], init_env=[], init_obs=[], sizes=sizes,
               metrics={k: float(v) for k, v in j_m.items()},
               summary=j_loop.summarize(j_carry), episodes=j_loop.drain_episodes(j_carry, -1))
    for r in range(WORLD):
        carry = train_carry_from_numpy(shards0[r], t_local_sac, t_local_loop, device="cpu")
        case["carry"].append(dataclasses.replace(carry, generator=None))
        case["draws"].append(iteration_draws(chain, shards0[r].key, env_keys[r], sizes,
                                             t_local_sac, t_local_loop, rank=r))
        init_keys = jax.random.split(jax.random.fold_in(key, r), N)
        case["init_draws"].append(chain.reset(init_keys))
        ref["init_env"].append(flat_state(env_state_from_numpy(shards0[r].env_states, "cpu")))
        ref["init_obs"].append(torch.from_numpy(shards0[r].obs))
        done = train_carry_from_numpy(shard_of(j_carry, r), t_local_sac, t_local_loop,
                                      device="cpu")
        ref["carry"].append(flat_state(dataclasses.replace(done, generator=None)))
    return case, ref


CASES = {
    "sac_updates": lambda mesh: updates_case(mesh, "sac", 3),
    "td3_updates": lambda mesh: updates_case(mesh, "td3", 4),
    "ppo_iteration": ppo_case,
    "loop_sac": lambda mesh: loop_case(mesh, False),
    "loop_extensions": lambda mesh: loop_case(mesh, True),
}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    mesh = j_mesh.make_mesh(WORLD)
    cases, refs = {"collectives": dict(kind="collectives")}, {}
    for name, build in CASES.items():
        cases[name], refs[name] = build(mesh)
    outs = run_world(cases, tmp_path_factory.mktemp("world2"))
    return cases, refs, outs


# ---------------------------------------------------------------- the tests
def test_collectives_at_world_2(world2):
    _, _, outs = world2
    for r, out in enumerate(o["collectives"] for o in outs):
        torch.testing.assert_close(out["pmean"][0], torch.full((3,), 1.5), rtol=0, atol=0)
        assert float(out["pmean"][1]) == 2.0
        assert out["psum"] == [3.0, 1.0]
        assert out["gather"].tolist() == [[0, 10], [1, 11]]
        assert out["broadcast"] == {"from": 0}
        assert out["counts"]["all_reduce"] == 3, r


@pytest.mark.parametrize("name", ["sac_updates", "td3_updates"])
def test_updates_match_jax(world2, name):
    """The replicated state after the updates against the JAX shard_map run
    (1e-5), each rank's own metrics against its shard's."""
    _, refs, outs = world2
    for r, out in enumerate(o[name] for o in outs):
        assert_flat_close(out["learner"], refs[name]["learner"], 1e-5, f"{name} rank {r}",
                          learner=True)
        for u, (got, want) in enumerate(zip(out["metrics"], refs[name]["metrics"][r])):
            assert_metrics_close({k: float(v) for k, v in got.items()}, want,
                                 f"{name} rank {r} update {u}")


@pytest.mark.parametrize("name", ["sac_updates", "td3_updates", "ppo_iteration"])
def test_learner_replicas_bit_identical(world2, name):
    a, b = (o[name] for o in world2[2])
    assert_replicas_equal(a["learner"], b["learner"], ("",), name)


def test_ppo_iteration_matches_jax(world2):
    _, refs, outs = world2
    ref = refs["ppo_iteration"]
    for r, out in enumerate(o["ppo_iteration"] for o in outs):
        what = f"ppo rank {r}"
        assert_flat_close(out["learner"], ref["learner"], 1e-4, what, learner=True)
        assert_flat_close(out["env"], ref["env"][r], None, what)
        torch.testing.assert_close(out["obs"], ref["obs"][r], **OBS_BAR)
        assert_metrics_close({k: float(v) for k, v in out["metrics"].items()}, ref["metrics"],
                             what)
    a, b = (o["ppo_iteration"]["metrics"] for o in outs)
    assert all(torch.equal(a[k], b[k]) for k in a)


LOOPS = ["loop_sac", "loop_extensions"]


@pytest.mark.parametrize("name", LOOPS)
def test_loop_shards_match_jax(world2, name):
    """Each rank's env states, obs, replay rows, counters and episode ring
    against its JAX shard."""
    _, refs, outs = world2
    for r, out in enumerate(o[name] for o in outs):
        got = {p: v for p, v in out["carry"].items() if not p.startswith(LEARNERS)}
        want = {p: v for p, v in refs[name]["carry"][r].items() if not p.startswith(LEARNERS)}
        assert_flat_close(got, want, None, f"{name} rank {r}")


@pytest.mark.parametrize("name", LOOPS)
def test_loop_learners_match_jax(world2, name):
    """The replicated agent (and ICM, RND, high level) against JAX at the
    loop's bar, with the update count the gate allows."""
    cases, refs, outs = world2
    for r, out in enumerate(o[name] for o in outs):
        got = {p: v for p, v in out["carry"].items() if p.startswith(LEARNERS)}
        want = {p: v for p, v in refs[name]["carry"][r].items() if p.startswith(LEARNERS)}
        assert_flat_close(got, want, 1e-4, f"{name} rank {r}")
    local_gate = cases[name]["sac_cfg"].learning_starts // WORLD
    updates = sum(size >= local_gate for size in refs[name]["sizes"])
    assert outs[0][name]["carry"]["agent.step"] == updates
    assert 0 < updates < STEPS


@pytest.mark.parametrize("name", LOOPS)
def test_loop_replicas_bit_identical(world2, name):
    a, b = (o[name] for o in world2[2])
    assert_replicas_equal(a["carry"], b["carry"], LEARNERS + ("buffer.ptr", "buffer.size",
                                                              "env_steps_host"), name)
    assert all(torch.equal(a["metrics"][k], b["metrics"][k]) for k in a["metrics"])
    # the shards differ: the ranks' envs are their own
    assert not torch.equal(a["carry"]["env_states.body.pos"], b["carry"]["env_states.body.pos"])


@pytest.mark.parametrize("name", LOOPS)
def test_loop_metrics_summarize_and_drain_match_jax(world2, name):
    _, refs, outs = world2
    ref = refs[name]
    for r, out in enumerate(o[name] for o in outs):
        assert_metrics_close({k: float(v) for k, v in out["metrics"].items()}, ref["metrics"],
                             f"{name} rank {r}")
        assert sorted(out["summary"]) == sorted(ref["summary"])
        for k, v in ref["summary"].items():
            assert out["summary"][k] == pytest.approx(v, rel=1e-3), (name, k)
        assert out["summary"]["env_steps"] == WORLD * N * STEPS
        episodes, last = out["episodes"]
        want, want_last = ref["episodes"]
        assert last == want_last and len(episodes) == len(want) > 0
        for (tr, tl, ts), (jr, jl, js) in zip(episodes, want):
            assert (tl, ts) == (jl, js)
            assert tr == pytest.approx(jr, rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("name", LOOPS)
def test_sharded_init_fn(world2, name):
    """``make_sharded_train``'s ``init_fn``: each rank's reset on the
    replayed ``fold_in(key, rank)`` draws equals the JAX shard's, and its
    agent is the same on both ranks."""
    _, refs, outs = world2
    for r, out in enumerate(o[name] for o in outs):
        assert_flat_close(out["init_env"], refs[name]["init_env"][r], None, f"{name} init {r}")
        torch.testing.assert_close(out["init_obs"], refs[name]["init_obs"][r], **OBS_BAR)
    assert_replicas_equal(outs[0][name]["init_agent"], outs[1][name]["init_agent"], ("",), name)


def test_local_configs_and_world_rule(monkeypatch):
    sac_cfg, loop_cfg = t_sac.SACConfig(**LOOP_SAC), t_loop.TrainLoopConfig(**LOOP)
    s, lp = t_mesh.local_configs(sac_cfg, loop_cfg, 4)
    assert (lp.num_envs, s.buffer_size, s.learning_starts, s.batch_size) == (8, 48, 24, 16)
    s, lp = t_mesh.local_configs(dataclasses.replace(sac_cfg, buffer_size=8, learning_starts=1),
                                 loop_cfg, 4)
    assert (s.buffer_size, s.learning_starts) == (8, 1)    # at least the local envs, 1
    with pytest.raises(ValueError, match="divide"):
        t_mesh.local_configs(sac_cfg, loop_cfg, 3)
    assert t_mesh.rank_seed(5, 0) == 5 and t_mesh.rank_seed(5, 1) != t_mesh.rank_seed(5, 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert [t_mesh.resolve_world(m) for m in (0, 1)] == [1, 1]
    with pytest.raises(ValueError, match="mesh_devices=2"):
        t_mesh.resolve_world(2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert t_mesh.resolve_world(0) == t_mesh.resolve_world(2) == 2
    with pytest.raises(ValueError, match="single process"):
        t_mesh.resolve_world(1)
    with pytest.raises(ValueError, match="mesh_devices=4"):
        t_mesh.resolve_world(4)
    with pytest.raises(ValueError, match="axis_name"):
        t_mesh.pmean_([torch.zeros(2)], "model")
