"""Checkpoint and resume with ``torch.save``.

Counterpart of ``tvc_ai_tpu/utils/checkpoint.py``. A checkpoint carries
everything needed to continue exactly: the train carry (networks, optimizer
states, replay buffer, env states, the carry's generator state, counters),
any other generator the caller adds, and a JSON sidecar of host state
(curriculum, stability cadence, best metrics).

Layout: one directory per step, named by its digits, under the manager's
directory: ``<dir>/<step>/carry.pt`` and ``<dir>/<step>/host.json``. A save
writes into a temporary directory and renames it, so a process killed
mid-save leaves no step directory behind. As with orbax: the newest
``max_to_keep`` steps are kept, a step that already exists is skipped, and
``latest_step`` is the highest step.

Saving is synchronous (orbax saves in the background); the trainer times it
under its ``"checkpoint"`` stage.

Under data parallelism (``parallel.mesh``) each rank writes its own shard of
the carry, ``<dir>/<step>/carry.rank{r}.pt``, and rank 0 writes
``host.json``; the temporary directory is renamed by rank 0 after a barrier,
so a step directory appears only once every shard is in it. A checkpoint is
restored at the world size that wrote it (the reference restores one global
array at any layout; the port's shards are the ranks' own).

``CheckpointManager.locate`` also takes the JAX package's orbax checkpoints
(a manager root or one step directory): it hands them to
``utils.orbax_read.OrbaxCheckpoints``, which reads them as numpy trees in the
JAX package's own layout.

``state_of`` turns a tree of dataclasses, dicts, lists, tensors, modules and
generators into plain nested dicts and lists of tensors (modules by their
``state_dict``, generators by ``get_state()``); ``load_state`` puts such a
state back into a tree of the same kind, field by field, keeping the
target's value for any field the checkpoint lacks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any

import torch

from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints, is_orbax_root, is_orbax_step

CARRY_FILE = "carry.pt"
HOST_FILE = "host.json"


def shard_file(rank: int) -> str:
    """The carry file of data-parallel rank ``rank``."""
    return f"carry.rank{rank}.pt"


def _complete(step_dir: Path) -> bool:
    return (step_dir / CARRY_FILE).exists() or (step_dir / shard_file(0)).exists()
_MODULE = "__module_state__"
_GENERATOR = "__generator_state__"


def state_of(obj: Any) -> Any:
    """``obj`` as nested dicts and lists whose leaves are tensors and scalars."""
    if isinstance(obj, torch.nn.Module):
        return {_MODULE: obj.state_dict()}
    if isinstance(obj, torch.Generator):
        return {_GENERATOR: obj.get_state()}
    if dataclasses.is_dataclass(obj):
        return {f.name: state_of(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: state_of(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [state_of(v) for v in obj]
    return obj


def load_state(target: Any, state: Any) -> Any:
    """``target`` with ``state`` (from ``state_of``) put back: modules and
    generators in place, tensors replaced by the checkpoint's (whose shapes
    win), dataclasses and dicts field by field."""
    if state is None:
        return None
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(state[_MODULE])
        return target
    if isinstance(target, torch.Generator):
        target.set_state(state[_GENERATOR].cpu())
        return target
    if isinstance(target, torch.Tensor):
        return state.to(target.device)
    if dataclasses.is_dataclass(target):
        return dataclasses.replace(target, **{
            f.name: load_state(getattr(target, f.name), state[f.name])
            for f in dataclasses.fields(target) if f.name in state
        })
    if isinstance(target, dict):
        return {k: load_state(target.get(k), v) for k, v in state.items()}
    if isinstance(target, (list, tuple)):
        if len(target) != len(state):
            raise ValueError(f"checkpoint holds {len(state)} entries, want {len(target)}")
        return type(target)(load_state(t, s) for t, s in zip(target, state))
    return state


def flat_state(obj: Any) -> dict[str, Any]:
    """``state_of(obj)`` flattened to {path: leaf}."""
    out: dict[str, Any] = {}

    def walk(x: Any, path: str) -> None:
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = x

    walk(state_of(obj), "")
    return out


def diff_states(a: Any, b: Any) -> list[str]:
    """The paths where ``a`` and ``b`` differ: a missing leaf, or a tensor
    that is not bit for bit equal (dtype and shape included)."""
    fa, fb = flat_state(a), flat_state(b)
    diffs = sorted(set(fa) ^ set(fb))
    for path in sorted(set(fa) & set(fb)):
        x, y = fa[path], fb[path]
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            same = x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        else:
            same = type(x) is type(y) and x == y
        if not same:
            diffs.append(path)
    return diffs


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(
            int(d.name) for d in self.directory.iterdir()
            if d.name.isdigit() and _complete(d)
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any, host_state: dict | None = None,
             rank: int | None = None, world: int = 1) -> None:
        """Write ``payload`` (any tree ``state_of`` takes) and ``host_state`` as
        step ``step``; a step that exists is skipped (the same count holds
        the same state). With ``world > 1`` every rank calls it with its own
        ``rank`` and payload (its shard)."""
        if step in self.all_steps():
            return
        if world > 1:
            self._save_shard(step, payload, host_state, rank, world)
            return
        tmp = self.directory / f"{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state_of(payload), tmp / CARRY_FILE)
        (tmp / HOST_FILE).write_text(json.dumps(host_state or {}, indent=2))
        self._publish(tmp, step)

    def _publish(self, tmp: Path, step: int) -> None:
        tmp.rename(self.directory / str(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def _save_shard(self, step: int, payload: Any, host_state: dict | None, rank: int,
                    world: int) -> None:
        tmp = self.directory / f"{step}.tmp-world{world}"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
        mesh.barrier()
        torch.save(state_of(payload), tmp / shard_file(rank))
        if rank == 0:
            (tmp / HOST_FILE).write_text(json.dumps(dict(host_state or {}, world_size=world),
                                                    indent=2))
        mesh.barrier()
        if rank == 0:
            self._publish(tmp, step)
        mesh.barrier()

    def world_of(self, step: int) -> int:
        """The world size that wrote ``step`` (1 for a single-process save)."""
        path = self.directory / str(step)
        shards = sum(1 for f in path.iterdir() if f.name.startswith("carry.rank"))
        return shards or 1

    def restore(self, step: int | None = None, device: str | torch.device = "cpu",
                rank: int | None = None, world: int = 1) -> tuple[Any, dict]:
        """(payload state, host state) of ``step`` (default: the latest), the
        tensors on ``device``; put the state back with ``load_state``. Under
        data parallelism each rank restores its own shard; the checkpoint
        must have been written at the same world size."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no completed checkpoints under {self.directory}")
        path = self.directory / str(step)
        saved_world = self.world_of(step)
        if saved_world != world:
            raise ValueError(
                f"{path} was written by {saved_world} process(es); resuming it needs the same "
                f"world size, not {world}")
        name = shard_file(rank) if world > 1 else CARRY_FILE
        state = torch.load(path / name, map_location=device, weights_only=True)
        return state, json.loads((path / HOST_FILE).read_text())

    @staticmethod
    def locate(path: str | Path) -> tuple["CheckpointManager | OrbaxCheckpoints", int]:
        """(manager, step) for a manager root (its latest step) or a single
        step directory like ``<run>/checkpoints_best/7208960``: of this
        package, or of the JAX package's orbax (an ``OrbaxCheckpoints``)."""
        path = Path(path)
        if path.name.isdigit() and _complete(path):
            return CheckpointManager(path.parent), int(path.name)
        if is_orbax_step(path):
            return OrbaxCheckpoints(path.parent), int(path.name)
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint directory at {path}")
        orbax = is_orbax_root(path)
        mngr = OrbaxCheckpoints(path) if orbax else CheckpointManager(path)
        step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no completed checkpoints under {path} (a process killed mid-save leaves "
                + ("only step directories without _CHECKPOINT_METADATA)" if orbax
                   else "only *.tmp-<pid> directories)")
            )
        return mngr, step


def save_json(path: str | Path, payload: dict) -> None:
    Path(path).write_text(json.dumps(payload, indent=2, default=str))
