"""Data parallelism over the env batch, in ``torch.distributed``'s idiom.

Counterpart of ``tvc_ai_tpu/parallel/mesh.py``. The reference runs one
``shard_map`` program over a 1-D ``data`` mesh; the port runs one process
per device (``torchrun`` launches them), joined in one process group:

- each rank holds its shard of the env batch, of the replay and of the
  per-env counters (``num_envs / world`` envs, ``buffer_size / world`` rows);
- each rank holds a full replica of the agents, started from the same seed;
- the replicas stay equal because every gradient is all-reduced before its
  optimizer step (``sum_grads_``: summed over the ranks, as the reference's
  gradients are, see there), so every rank applies the same update to the
  same parameters; losses, batch statistics and metrics are averaged
  (``pmean_``, the counterpart of ``jax.lax.pmean``).

``axis_name`` is ``DATA_AXIS`` wherever the reference passes it; it names
the default process group.

Which fields are sharded and which are replicated (the counterpart of
``carry_specs`` and ``ensemble_carry_specs``):

==========================================  ==================================
``TrainCarry`` field                        layout
==========================================  ==================================
env_states, obs, obs_window                 sharded: the rank's envs
goal, goal_obs                              sharded
buffer.data                                 sharded: the rank's replay rows
buffer.ptr, buffer.size, buffer.capacity    replicated (equal writes per rank)
agent, icm, rnd, hier                       replicated
env_steps, episodes, successes              sharded
ep_return, ep_length, return_sum,           sharded
length_sum
ep_ring_* (return, length, success, seq,    sharded: one ring per rank, which
ptr, goal, goal_obs)                        ``loop.drain_episodes`` gathers
env_steps_host                              replicated (a host int)
generator                                   per rank: the counterpart of
                                            ``fold_in(key, axis_index)``
demo_buffer                                 single device only (the
                                            reference's rule)
==========================================  ==================================

==========================================  ==================================
``EnsembleCarry`` field                     layout
==========================================  ==================================
env_states, obs, buffer.data                sharded
buffer.ptr, buffer.size, buffer.capacity    replicated
sac, td3, ppo                               replicated
env_steps, episodes, successes, ep_return,  sharded
return_sum, length_sum, ep_length
generator                                   per rank
==========================================  ==================================

The replicated state draws nothing from a rank's generator: each rank's
draws (action noise, replay rows, the updates' noise, the env's noise and
reset draws, PPO's permutations of its own rows) act only on its shard or
reach the replicas through an all-reduce. The per-rank generator is seeded
with ``rank_seed(seed, rank)``, which is ``seed`` on rank 0, so a world of
one draws what the unsharded carry draws.

Backends: NCCL for CUDA devices, gloo for the CPU, chosen by the caller or
by the device's type, never as a retreat from a failed init. gloo may also
join ranks on CUDA devices (several ranks on one card): there each
all-reduce is staged through the host.

A JAX package's checkpoint written over a mesh of n devices holds the
global arrays in that mesh's layout; ``shard_jax_carry`` gives a rank its
part at any world (the shard itself at world n, a re-laid part otherwise).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

DATA_AXIS = "data"
# collectives issued by this module since the count was last set to 0
# (pmean_, sum_grads_, psum_, all_gather_host, broadcast_): read by the smoke script
counts = {"all_reduce": 0}


# ---------------------------------------------------------------- the group
def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def launched_world() -> int:
    """The world this process belongs to: the group's size once one exists,
    else ``WORLD_SIZE`` as ``torchrun`` sets it (1 for a plain process)."""
    return world_size() if active() else int(os.environ.get("WORLD_SIZE", "1"))


def resolve_world(mesh_devices: int) -> int:
    """The world a trainer runs at, by the reference's rule on
    ``hardware.mesh_devices``: 0 takes the world that was launched, 1 asks
    for a single process, N > 1 for exactly N processes."""
    launched = launched_world()
    if mesh_devices == 0:
        return launched
    if mesh_devices == 1:
        if launched > 1:
            raise ValueError(
                f"hardware.mesh_devices=1 asks for a single process, but {launched} were "
                "launched; launch one process or set hardware.mesh_devices=0")
        return 1
    if launched != mesh_devices:
        raise ValueError(
            f"hardware.mesh_devices={mesh_devices} but {launched} processes were launched "
            f"(torchrun --nproc-per-node {mesh_devices})")
    return mesh_devices


def init_data_parallel(
    device: str | torch.device = DEFAULT_DEVICE,
    backend: str | None = None,
    init_method: str = "env://",
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
) -> torch.device:
    """Join this process to the data-parallel group and return its device.

    ``rank``, ``world_size`` and ``local_rank`` default to ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` sets them. A CUDA
    device becomes ``cuda:LOCAL_RANK``. The backend is NCCL for a CUDA
    device and gloo for the CPU unless ``backend`` names one. A group that
    already exists is kept.
    """
    env = os.environ
    rank = int(env.get("RANK", "0")) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", "1")) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", "0")) if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if not active():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


def _check_axis(axis_name: str) -> None:
    if axis_name != DATA_AXIS:
        raise ValueError(f"unknown axis_name {axis_name!r}; the port has one axis, {DATA_AXIS!r}")
    if not active():
        raise RuntimeError(
            f"axis_name={axis_name!r} needs a process group: call init_data_parallel first")


def _staged(tensor: torch.Tensor) -> bool:
    """gloo joins CUDA tensors only through the host."""
    return tensor.is_cuda and dist.get_backend() == "gloo"


def _all_reduce_sum_(tensor: torch.Tensor) -> None:
    counts["all_reduce"] += 1
    if _staged(tensor):
        host = tensor.cpu()
        dist.all_reduce(host)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor)


# ---------------------------------------------------------------- collectives
def _reduce_(sums: Sequence[torch.Tensor], means: Sequence[torch.Tensor],
             axis_name: str | None) -> list[torch.Tensor]:
    """``sums`` summed and ``means`` averaged over the ranks, in place, in
    one flat all_reduce(SUM) (gloo has no ``ReduceOp.AVG``: the means are
    divided by the world size after it). No host synchronisation on NCCL."""
    tensors = [*sums, *means]
    if axis_name is None or not tensors:
        return tensors
    _check_axis(axis_name)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"one dtype per all-reduce, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce_sum_(flat)
    if means:
        n_sum = sum(t.numel() for t in sums)
        flat[n_sum:].div_(dist.get_world_size())
    parts = torch.split(flat, [t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])
    return tensors


def pmean_(tensors: Sequence[torch.Tensor], axis_name: str | None) -> list[torch.Tensor]:
    """The mean of each tensor over the ranks, in place: the counterpart of
    ``jax.lax.pmean`` of a value that differs per rank (a loss, a batch
    statistic, a metric). One flat buffer, one all_reduce(SUM), a division
    by the world size, a copy back. With ``axis_name`` None it does nothing."""
    return _reduce_((), tensors, axis_name)


def sum_grads_(grads: Sequence[torch.Tensor], axis_name: str | None,
               means: Sequence[torch.Tensor] = ()) -> list[torch.Tensor]:
    """The gradients of replicated parameters summed over the ranks (and
    ``means`` averaged, in the same all-reduce), in place; returns the
    gradients then the means.

    This is what the reference's optimizer receives. Its learners call
    ``jax.lax.pmean`` on each gradient inside ``shard_map``, whose
    varying-axis checking is on: there reverse-mode differentiation of a
    replicated parameter against a rank's own data already sums the gradient
    over the shards (the transpose of the implicit ``pvary`` is a ``psum``),
    and ``pmean`` of that replicated sum leaves it unchanged. So the
    gradient that reaches the clip and Adam is the sum of the ranks'
    gradients, not their mean; the port does the same, so that it matches
    the reference at any world size (at world 1 the two agree).
    """
    return _reduce_(grads, means, axis_name)


def psum_(tensor: torch.Tensor, axis_name: str | None) -> torch.Tensor:
    """``tensor`` summed over the ranks, in place (the counterpart of
    ``jax.lax.psum``); unchanged with ``axis_name`` None."""
    if axis_name is not None:
        _check_axis(axis_name)
        _all_reduce_sum_(tensor)
    return tensor


def psum_host(values: Sequence[torch.Tensor], axis_name: str | None) -> list[float]:
    """The sum over the ranks of each 0-dim tensor, as host floats (float64):
    one all-reduce, one read."""
    return psum_(torch.stack([v.to(torch.float64) for v in values]), axis_name).tolist()


def all_gather_host(tensor: torch.Tensor, axis_name: str | None) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 in rank order, on the
    host (the reference's device-to-host gather of a sharded array)."""
    if axis_name is None:
        return tensor.cpu()
    _check_axis(axis_name)
    counts["all_reduce"] += 1
    src = tensor.cpu() if _staged(tensor) else tensor
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    return torch.cat([p.cpu() for p in parts])


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``tensor`` replaced in place by rank ``src``'s."""
    if not active():
        return tensor
    counts["all_reduce"] += 1
    if _staged(tensor):
        host = tensor.cpu()
        dist.broadcast(host, src)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src)
    return tensor


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (any picklable value) on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if active():
        dist.barrier()


# ---------------------------------------------------------------- the shards
def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``seed`` on rank 0, a distinct
    stream on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def local_configs(sac_cfg, loop_cfg, world: int):
    """(SAC config, loop config) of one rank: ``num_envs // world`` envs, a
    replay shard of ``max(buffer_size // world, local envs)`` rows and a gate
    of ``max(learning_starts // world, 1)`` rows, so that the global capacity
    and gate match the config. ``batch_size`` is not divided: each rank
    samples a full batch from its own shard."""
    if loop_cfg.num_envs % world != 0:
        raise ValueError(f"num_envs {loop_cfg.num_envs} must divide over {world} ranks")
    local_loop = dataclasses.replace(loop_cfg, num_envs=loop_cfg.num_envs // world)
    local_sac = dataclasses.replace(
        sac_cfg,
        buffer_size=max(sac_cfg.buffer_size // world, local_loop.num_envs),
        learning_starts=max(sac_cfg.learning_starts // world, 1),
    )
    return local_sac, local_loop


def local_ensemble_config(ens_cfg, num_envs: int, world: int):
    """(ensemble config, envs) of one rank, divided as ``local_configs`` does."""
    if num_envs % world != 0:
        raise ValueError(f"num_envs {num_envs} must divide over {world} ranks")
    local_envs = num_envs // world
    local_cfg = dataclasses.replace(ens_cfg, sac=dataclasses.replace(
        ens_cfg.sac,
        buffer_size=max(ens_cfg.sac.buffer_size // world, local_envs),
        learning_starts=max(ens_cfg.sac.learning_starts // world, 1),
    ))
    return local_cfg, local_envs


def _require_group() -> tuple[int, int]:
    if not active():
        raise RuntimeError("data-parallel training needs a process group: call "
                           "init_data_parallel first (torchrun sets its address)")
    return world_size(), rank()


def make_sharded_train(env_params, sac_cfg, loop_cfg, device: str | torch.device = DEFAULT_DEVICE):
    """This rank's ``(init_fn, train_fn)`` of the fused SAC loop over the group.

    ``loop_cfg.num_envs`` is the global env count. ``init_fn(seed,
    reset_draws=None)`` builds the rank's carry: the agent (and ICM, RND,
    high level) from ``seed`` on every rank, the envs reset from the rank's
    generator (or from ``reset_draws``). ``train_fn(carry, env_params,
    draws=None)`` is ``loop.make_train_iteration`` on the local configs with
    ``axis_name=DATA_AXIS``.
    """
    from tvc_ai_torch.training import loop

    world, r = _require_group()
    local_sac, local_loop = local_configs(sac_cfg, loop_cfg, world)
    dev = resolve_device(device)

    def init_fn(seed: int, reset_draws=None):
        return loop.init_carry(env_params, local_sac, local_loop, dev, seed=seed,
                               reset_draws=reset_draws, stream_seed=rank_seed(seed, r))

    train_fn = loop.make_train_iteration(local_sac, local_loop, axis_name=DATA_AXIS)
    return init_fn, train_fn


def make_sharded_ensemble_train(env_params, ens_cfg, num_envs: int, rollout_steps: int,
                                updates_per_step: int = 1,
                                device: str | torch.device = DEFAULT_DEVICE):
    """This rank's ``(init_fn, train_fns)`` of the ensemble over the group:
    members replicated with all-reduced gradients, env batch and replay
    sharded. ``train_fns`` is keyed by the acting member ('ppo', 'sac',
    'td3', 'ensemble'); ``num_envs`` is global."""
    from tvc_ai_torch.agents import ensemble

    world, r = _require_group()
    local_cfg, local_envs = local_ensemble_config(ens_cfg, num_envs, world)
    dev = resolve_device(device)

    def init_fn(seed: int, reset_draws=None):
        return ensemble.init_carry(env_params, local_cfg, local_envs, dev, seed=seed,
                                   reset_draws=reset_draws, stream_seed=rank_seed(seed, r))

    train_fns = {
        actor: ensemble.make_ensemble_iteration(actor, local_cfg, local_envs, rollout_steps,
                                                updates_per_step, axis_name=DATA_AXIS)
        for actor in ensemble.ACTORS
    }
    return init_fn, train_fns


# ---------------------------------------------------------------- JAX checkpoints
# the leaves of the JAX package's ``TrainCarry`` that its ``carry_specs``
# lays out over the mesh's data axis, besides ``buffer.data``: the env rows,
# and one episode ring (and ring pointer) per device
JAX_ENV_LEAVES = ("env_states", "obs", "obs_window", "goal", "goal_obs", "env_steps", "episodes",
                  "successes", "ep_return", "ep_length", "return_sum", "length_sum")
JAX_RING_LEAVES = ("ep_ring_return", "ep_ring_length", "ep_ring_success", "ep_ring_seq",
                   "ep_ring_goal", "ep_ring_goal_obs")


def jax_carry_shards(disk: dict) -> int:
    """How many devices wrote a JAX ``TrainCarry`` read from orbax: the
    length of its ``ep_ring_ptr``, one pointer per device (1 without one)."""
    ptr = disk.get("ep_ring_ptr")
    return 1 if ptr is None else int(np.shape(ptr)[0])


def _map(tree: Any, fn) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def shard_jax_carry(disk: dict, n: int, world: int, rank: int, num_envs: int,
                    ring_size: int) -> dict:
    """Rank ``rank``'s part, at ``world`` ranks, of a JAX ``TrainCarry``
    that a mesh of ``n`` devices wrote (``utils.orbax_read``'s numpy tree of
    the global arrays), laid out as ``make_sharded_train`` holds a run of
    ``num_envs`` envs with rings of ``ring_size`` slots on that rank.

    The JAX package's layout (its ``carry_specs`` and ``make_sharded_train``):
    device d holds env rows ``[d·N/n, (d+1)·N/n)``, replay rows ``[d·cap,
    (d+1)·cap)`` with its own ``ptr`` and ``size`` (equal on every device,
    stored once), ring entries ``[d·K, (d+1)·K)`` and ``ep_ring_ptr[d]``;
    the agent and the other learners' states are replicated.

    - ``n == world == 1``: ``disk`` itself.
    - ``world == n``: device ``rank``'s rows, replay, ring and pointer, as
      they are.
    - Otherwise the checkpoint is first laid out as one device would hold
      it: each device's step block t (its replay rows ``[t·N/n, (t+1)·N/n)``)
      becomes global rows ``[t·N, (t+1)·N)`` in global env order, and
      ``ptr`` and ``size`` count all of them. That is then split as a fresh
      run at ``world`` is split: the rank's envs ``[rank·N/w, (rank+1)·N/w)``
      and their rows of every step block. The n rings become ``world`` rings
      of K slots holding the newest ``world·K`` entries by ``ep_ring_seq``,
      in the order the drain reads them (by ``seq``, ties in ring order), K
      to a rank from rank 0, each pointer at its next free slot.

    Raises ``ValueError``, naming ``n`` and ``world``, where the env batch,
    the replay or the ring does not lay out: the shards are never read as
    one ring."""
    if n == world == 1:
        return disk
    what = f"a JAX checkpoint written by {n} device(s), resumed at world {world}"
    envs = int(np.shape(disk["obs"])[0])
    if envs != num_envs or num_envs % n or num_envs % world:
        raise ValueError(f"{what}: its {envs} envs must be the config's num_envs {num_envs} "
                         f"and divide over both {n} and {world}")
    ring = int(np.shape(disk["ep_ring_seq"])[0])
    if ring != n * ring_size:
        raise ValueError(f"{what}: its episode rings hold {ring} entries, not {n} x {ring_size}")
    data = disk["buffer"]["data"]
    rows = int(np.shape(next(iter(data.values())))[0])
    local, per = num_envs // n, num_envs // world
    ptr, size = (int(np.asarray(disk["buffer"][k])) for k in ("ptr", "size"))
    if rows % n or (rows // n) % local or ptr % local or size % local:
        raise ValueError(f"{what}: its replay of {rows} rows (ptr {ptr}, size {size}) is not "
                         f"{n} shards of whole {local}-env step blocks")
    cap = rows // n
    blocks = cap // local
    lo, hi = rank * per, (rank + 1) * per
    out = dict(disk)
    for name in JAX_ENV_LEAVES:
        out[name] = _map(disk.get(name), lambda x: x[lo:hi])
    if world == n:
        buffer_data = {k: v[rank * cap:(rank + 1) * cap] for k, v in data.items()}
        ring_rows = np.arange(rank * ring_size, (rank + 1) * ring_size)
        ring_ptr = np.asarray(disk["ep_ring_ptr"])[rank:rank + 1]
    else:
        def relaid(v):
            steps = v.reshape(n, blocks, local, *v.shape[1:]).swapaxes(0, 1)
            mine = steps.reshape(blocks, world, per, *v.shape[1:])[:, rank]
            return np.ascontiguousarray(mine.reshape(blocks * per, *v.shape[1:]))

        buffer_data = {k: relaid(v) for k, v in data.items()}
        ptr, size = ptr // local * per, size // local * per
        seq = np.asarray(disk["ep_ring_seq"])
        filled = np.flatnonzero(seq >= 0)
        newest = filled[np.argsort(seq[filled], kind="stable")][-world * ring_size:]
        ring_rows = newest[rank * ring_size:(rank + 1) * ring_size]
        ring_ptr = np.array([len(ring_rows) % ring_size], np.asarray(disk["ep_ring_ptr"]).dtype)
    out["buffer"] = dict(disk["buffer"], data=buffer_data, ptr=np.int32(ptr), size=np.int32(size))
    for name in JAX_RING_LEAVES:
        x = disk.get(name)
        if x is None:
            continue
        empty = np.full((ring_size, *np.shape(x)[1:]), -1 if name == "ep_ring_seq" else 0,
                        np.asarray(x).dtype)
        empty[:len(ring_rows)] = np.asarray(x)[ring_rows]
        out[name] = empty
    out["ep_ring_ptr"] = ring_ptr
    return out
