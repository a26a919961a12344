"""Read the flax msgpack files of the JAX package, with neither flax nor msgpack.

The JAX package writes its research artifacts with
``flax.serialization.msgpack_serialize``: the legacy ``SACAgent.save`` file,
the DAgger students (``student*.msgpack``), the θ-student and the ensemble's
checkpoint. That format is standard msgpack whose map keys are strings, plus
flax's extension types:

- ext 1, an ndarray: the payload is itself msgpack, ``(shape, dtype name,
  C-order bytes)``; ``bfloat16`` is named as such;
- ext 2, a Python complex: ``(real, imag)``;
- ext 3, a numpy scalar, packed as a 0-d ndarray;
- arrays above ``MAX_CHUNK_SIZE`` bytes split into a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": ..}}``.

Tuples and lists of a pytree arrive as maps ``{"0": .., "1": ..}`` and named
tuples as maps of their fields (``flax.serialization.to_state_dict``); this
module returns them as it finds them.

``msgpack_restore(data)`` decodes what ``flax.serialization.msgpack_restore``
decodes, to the same tree: maps → dicts, arrays → lists, str → str, bin →
bytes, an ndarray → a read-only ``numpy.ndarray`` (a ``torch.bfloat16``
tensor for bfloat16, which numpy lacks), a numpy scalar → a numpy scalar (a
0-d bfloat16 tensor), any other ext type → ``ExtType(code, data)``. A complex
raises ``ValueError``, as does an unknown dtype, a truncated file, bytes past
the end of the tree or a marker msgpack does not define; nothing returns a
partial tree.

The decoder walks a ``memoryview`` with an offset, so an array's bytes are
read in place (a default-width agent file holds about a million floats).
"""

from __future__ import annotations

import struct
import zipfile
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["ExtType", "is_flax_msgpack", "load", "msgpack_restore"]

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a type flax does not define (as ``msgpack.ExtType``)."""

    code: int
    data: bytes


def is_flax_msgpack(path: str | Path) -> bool:
    """Whether ``path`` is a file in flax's msgpack form: not a zip (a
    ``torch.save`` file is one), and its first byte opens a map."""
    path = Path(path)
    if not path.is_file() or zipfile.is_zipfile(path):
        return False
    with path.open("rb") as f:
        head = f.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load(path: str | Path) -> Any:
    """The tree of the flax msgpack file at ``path``."""
    try:
        return msgpack_restore(Path(path).read_bytes())
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None


def msgpack_restore(data: bytes | bytearray | memoryview) -> Any:
    """The tree of ``data`` (``flax.serialization.msgpack_restore``'s)."""
    view = memoryview(data).cast("B")
    try:
        reader = _Reader(view, raw=False)
        tree = reader.value()
    except RecursionError:
        raise ValueError("msgpack nested too deeply") from None
    if reader.pos != len(view):
        raise ValueError(f"{len(view) - reader.pos} bytes past the end of the msgpack tree")
    return _unchunk(tree)


_FIXED = {  # marker → (struct format, byte count)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """One pass over ``view``; ``raw`` keeps str as bytes (an ndarray's
    payload is read so, as flax does)."""

    def __init__(self, view: memoryview, raw: bool):
        self.view, self.raw, self.pos = view, raw, 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise ValueError(f"msgpack truncated: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.view) - self.pos} left")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int) -> Any:
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, width: int) -> int:
        return self.unpack(_LENGTH[width], width)

    def string(self, n: int) -> str | bytes:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        m = self.unpack(">B", 1)
        if m <= 0x7F:
            return m
        if m >= 0xE0:
            return m - 0x100
        if m <= 0x8F:
            return self.mapping(m & 0x0F)
        if m <= 0x9F:
            return [self.value() for _ in range(m & 0x0F)]
        if m <= 0xBF:
            return self.string(m & 0x1F)
        if m == 0xC0:
            return None
        if m in (0xC2, 0xC3):
            return m == 0xC3
        if m in _FIXED:
            return self.unpack(*_FIXED[m])
        if m in _STR:
            return self.string(self.length(_STR[m]))
        if m in _BIN:
            return bytes(self.take(self.length(_BIN[m])))
        if m in _ARRAY:
            return [self.value() for _ in range(self.length(_ARRAY[m]))]
        if m in _MAP:
            return self.mapping(self.length(_MAP[m]))
        if m in _EXT:
            n = self.length(_EXT[m])
            return self.ext(self.unpack(">b", 1), n)
        if m in _FIXEXT:
            return self.ext(self.unpack(">b", 1), _FIXEXT[m])
        raise ValueError(f"byte 0x{m:02x} at offset {self.pos - 1} is not a msgpack marker")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(key).__name__} "
                                 f"before offset {self.pos}")
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            raise ValueError("a complex number in the file: this package holds no complex state")
        return ExtType(code, bytes(payload))


def _ndarray(payload: memoryview) -> np.ndarray | torch.Tensor:
    """flax's ndarray ext: msgpack ``(shape, dtype name, bytes)`` read raw."""
    inner = _Reader(payload, raw=True)
    tpl = inner.value()
    if inner.pos != len(payload) or not isinstance(tpl, list) or len(tpl) != 3:
        raise ValueError("an ndarray ext that is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if (not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape)
            or not isinstance(buf, bytes) or not isinstance(name, str)):
        raise ValueError("an ndarray ext that is not (shape, dtype, bytes)")
    if name == "bfloat16":
        if len(buf) != 2 * int(np.prod(shape)):
            raise ValueError(f"a bfloat16 array of shape {tuple(shape)} holds {len(buf)} bytes")
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not one numpy or torch reads") from None
    if dtype.hasobject or len(buf) != dtype.itemsize * int(np.prod(shape)):
        raise ValueError(f"a {name} array of shape {tuple(shape)} holds {len(buf)} bytes")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunk(tree: Any) -> Any:
    """Chunked arrays joined, where flax joins them: a dict, or a dict's
    value, at any depth of dicts (flax chunks nothing inside a list)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        return _join(tree)
    for key, value in tree.items():
        if isinstance(value, dict):
            tree[key] = _unchunk(value)
    return tree


def _ordered(d: Any, what: str) -> list:
    if not isinstance(d, dict) or set(d) != {str(i) for i in range(len(d))}:
        raise ValueError(f"a chunked array whose {what} is not a map of 0..n-1")
    return [d[str(i)] for i in range(len(d))]


def _join(d: dict) -> np.ndarray | torch.Tensor:
    shape = tuple(_ordered(d.get("shape"), "shape"))
    chunks = _ordered(d.get("chunks"), "chunks")
    if not chunks:
        raise ValueError("a chunked array with no chunks")
    if all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    if not all(isinstance(c, np.ndarray) for c in chunks):
        raise ValueError("a chunked array whose chunks are not arrays")
    flat = np.concatenate(chunks)
    if flat.size != int(np.prod(shape)):
        raise ValueError(f"chunks of {flat.size} elements for shape {shape}")
    return flat.reshape(shape)
