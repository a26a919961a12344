"""Read the JAX package's orbax checkpoints as nested numpy trees.

The JAX package's ``utils.checkpoint.CheckpointManager`` (orbax) writes one
directory per step under a manager root (``<run>/checkpoints``,
``checkpoints_best``, ``checkpoints_best_nominal``)::

    <root>/<step>/_CHECKPOINT_METADATA   written last: the step is complete
    <root>/<step>/host/metadata          the host state, plain JSON
    <root>/<step>/carry/_METADATA        each leaf's key path and value type
    <root>/<step>/carry/...              an OCDBT database (``utils.ocdbt``)

Each array leaf is a zarr v2 array in that database, named by its key path
joined with ".": ``agent.actor_params.params.hidden_0.kernel/.zarray`` (JSON:
dtype, shape, chunks, fill value, compressor) and its chunks
``<name>/<i>.<j>`` (``<name>/0`` for a scalar), each a zstd frame
(``utils.zstd``). A run sharded over several devices writes one chunk per
shard; a chunk the database lacks holds the fill value.

``OrbaxCheckpoints(root)`` lists the complete steps (numeric directories
holding ``_CHECKPOINT_METADATA``, as orbax does; never its
``*.orbax-checkpoint-tmp*`` directories); ``read(step, prefix=("agent",))``
decodes only that subtree's chunks, so reading the agent does not
decompress the replay ring. The tree is rebuilt from ``_METADATA``: dicts
for dict and attribute keys, tuples for sequence keys (optax's states),
``None`` where orbax stored None (an absent EMA actor, optax's empty
states). Leaves are numpy arrays of the stored dtype (``<f4``, ``<i4``,
``<u4``, ``bool``, ...), and ``torch.bfloat16`` tensors for bfloat16, which
numpy lacks. The ``_sharding`` file, which names the devices that wrote the
step, is not read: a step written on a TPU reads the same as one written
on a CPU.

An item written with ``use_zarr3`` or without OCDBT raises ``ValueError``, as
does a chunk that does not decode to its shape, or any decode error below.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tvc_ai_torch.utils import zstd
from tvc_ai_torch.utils.ocdbt import OcdbtReader

__all__ = ["OrbaxCheckpoints", "is_orbax_root", "is_orbax_step", "read_item"]

COMPLETE = "_CHECKPOINT_METADATA"
ITEM_METADATA = "_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2


def is_orbax_step(path: str | Path) -> bool:
    """Whether ``path`` is a complete orbax step directory."""
    path = Path(path)
    return path.name.isdigit() and (path / COMPLETE).is_file()


def is_orbax_root(path: str | Path) -> bool:
    """Whether ``path`` is an orbax manager root: a numeric child directory
    that orbax has written into, complete or not."""
    path = Path(path)
    return path.is_dir() and any(
        d.name.isdigit() and ((d / COMPLETE).exists() or (d / "carry").is_dir())
        for d in path.iterdir())


class OrbaxCheckpoints:
    """The complete steps of one orbax manager root, read-only."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory).absolute()

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(d.name) for d in self.directory.iterdir() if is_orbax_step(d))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> Path:
        path = self.directory / str(step)
        if not is_orbax_step(path):
            raise FileNotFoundError(f"no complete orbax step {step} under {self.directory}")
        return path

    def read(self, step: int, item: str = "carry", prefix: tuple = ()) -> Any:
        """The tree of ``item`` at ``step`` (only the subtree at ``prefix``)."""
        return read_item(self.step_dir(step) / item, prefix)

    def host(self, step: int) -> dict:
        """The host state saved with ``step`` (``{}`` when it has none)."""
        path = self.step_dir(step) / "host" / "metadata"
        return json.loads(path.read_text()) if path.is_file() else {}


def read_item(directory: str | Path, prefix: tuple = ()) -> Any:
    """The tree of one orbax item directory (a ``StandardSave``), or its
    subtree at the key path ``prefix``."""
    directory = Path(directory)
    meta_path = directory / ITEM_METADATA
    if not meta_path.is_file():
        raise ValueError(f"{directory} holds no orbax {ITEM_METADATA}")
    meta = json.loads(meta_path.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{directory}: use_zarr3 is true (zarr v3 arrays); this reader reads "
                         "the zarr v2 arrays orbax writes by default")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{directory}: use_ocdbt is {meta.get('use_ocdbt')!r}; this reader "
                         "reads OCDBT items only")
    prefix = tuple(str(k) for k in prefix)
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        path = tuple(str(k["key"]) for k in keys)
        if path[:len(prefix)] == prefix:
            leaves.append((path, tuple(k["key_type"] for k in keys), entry["value_metadata"]))
    if not leaves:
        raise KeyError(f"{directory} holds no leaf under {'.'.join(prefix) or 'its root'}")
    kv = OcdbtReader(directory)
    root: dict = {}
    kinds: dict[tuple, int] = {}
    for path, key_types, value_meta in leaves:
        node = root
        for depth, (key, kind) in enumerate(zip(path, key_types)):
            if kind not in (KEY_SEQUENCE, KEY_DICT):
                raise ValueError(f"{directory}: key {key!r} of unknown key type {kind}")
            if kinds.setdefault(path[:depth], kind) != kind:
                raise ValueError(f"{directory}: {'.'.join(path[:depth])} is both a sequence "
                                 "and a dict")
            if depth == len(path) - 1:
                node[key] = _leaf(kv, ".".join(path), value_meta)
            else:
                node = node.setdefault(key, {})
    tree = _sequences(root, kinds, ())
    for key in prefix:
        tree = tree[key]
    return tree


def _sequences(node: Any, kinds: dict, path: tuple) -> Any:
    """Dicts under sequence keys turned into tuples, in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _sequences(v, kinds, path + (k,)) for k, v in node.items()}
    if kinds.get(path) != KEY_SEQUENCE:
        return out
    if set(out) != {str(i) for i in range(len(out))}:
        raise ValueError(f"sequence {'.'.join(path)} has indices {sorted(out)}")
    return tuple(out[str(i)] for i in range(len(out)))


def _leaf(kv: OcdbtReader, name: str, value_meta: dict) -> Any:
    kind = value_meta.get("value_type")
    if kind == "None":
        return None
    if f"{name}/.zarray" not in kv:
        raise ValueError(f"leaf {name} ({kind}) has no zarr array in the checkpoint")
    return read_array(kv, name)


def _dtype(name: str) -> tuple[np.dtype, bool]:
    """(storage dtype, is bfloat16) of a zarr v2 dtype string."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"zarr dtype {name!r} is not one numpy or torch reads") from None
    if dtype.hasobject or dtype.kind in "USVMmOc":
        raise ValueError(f"zarr dtype {name!r} is not a numeric array type")
    return dtype, False


def _fill(value: Any, dtype: np.dtype, bf16: bool) -> Any:
    """A zarr v2 fill value as a scalar of the storage dtype (null: zero)."""
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if bf16:
        return int(torch.tensor(float(value), dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    return np.array(value).astype(dtype)


def read_array(kv: OcdbtReader, name: str) -> np.ndarray | torch.Tensor:
    """The zarr v2 array ``name`` of an OCDBT database, its chunks decoded
    and assembled."""
    meta = json.loads(kv.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, not 2")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r}; C order only")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}; zstd only")
    dtype, bf16 = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    whole = all(s == c for s, c in zip(shape, chunks))
    out = None if whole else np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    for index in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in kv:
            if whole:
                out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
            continue
        raw = kv.read(key)
        data = zstd.decompress(raw) if compressor is not None else raw
        if len(data) != dtype.itemsize * math.prod(chunks):
            raise ValueError(f"{key}: {len(data)} bytes for a {meta['dtype']} chunk of "
                             f"shape {chunks}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if whole:
            out = chunk
            continue
        lo = [i * c for i, c in zip(index, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int16).copy()).view(
            torch.bfloat16)
    if not out.dtype.isnative:
        out = out.astype(out.dtype.newbyteorder("="))
    return out
