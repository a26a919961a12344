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

CARRY_FILE = "carry.pt"
HOST_FILE = "host.json"
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
            if d.name.isdigit() and (d / CARRY_FILE).exists()
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any, host_state: dict | None = None) -> None:
        """Write ``payload`` (any tree ``state_of`` takes) and ``host_state`` as
        step ``step``; a step that exists is skipped (the same count holds
        the same state)."""
        if step in self.all_steps():
            return
        tmp = self.directory / f"{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state_of(payload), tmp / CARRY_FILE)
        (tmp / HOST_FILE).write_text(json.dumps(host_state or {}, indent=2))
        tmp.rename(self.directory / str(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, step: int | None = None,
                device: str | torch.device = "cpu") -> tuple[Any, dict]:
        """(payload state, host state) of ``step`` (default: the latest), the
        tensors on ``device``; put the state back with ``load_state``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no completed checkpoints under {self.directory}")
        path = self.directory / str(step)
        state = torch.load(path / CARRY_FILE, map_location=device, weights_only=True)
        return state, json.loads((path / HOST_FILE).read_text())

    @staticmethod
    def locate(path: str | Path) -> tuple["CheckpointManager", int]:
        """(manager, step) for a manager root (its latest step) or a single
        step directory like ``<run>/checkpoints_best/7208960``."""
        path = Path(path)
        if path.name.isdigit() and (path / CARRY_FILE).exists():
            return CheckpointManager(path.parent), int(path.name)
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint directory at {path}")
        if (path / "carry").is_dir() or any(
                (d / "carry").is_dir() for d in path.iterdir() if d.name.isdigit()):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint of the JAX package; this package "
                f"reads only its own checkpoints (<dir>/<step>/{CARRY_FILE})"
            )
        mngr = CheckpointManager(path)
        step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no completed checkpoints under {path} (a process killed mid-save "
                "leaves only *.tmp-<pid> directories)"
            )
        return mngr, step


def save_json(path: str | Path, payload: dict) -> None:
    Path(path).write_text(json.dumps(payload, indent=2, default=str))
