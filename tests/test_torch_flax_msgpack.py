"""The port's flax msgpack decoder (``tvc_ai_torch/utils/flax_msgpack.py``)
against ``flax.serialization.msgpack_restore`` (``msgpack.unpackb`` with
flax's ext hook, then its chunk joining), on this CPU.

- Hypothesis trees of every msgpack type flax's files can hold (nil, bools,
  ints of every width, float32 and float64, str, bin, arrays, maps with str
  keys, ext payloads of unknown types), and each boundary by name: ints at
  ±2^7, 2^8, 2^15, 2^16, 2^31, 2^32, 2^63 and 2^64 − 1, str and bin lengths
  31, 255 and 65,535 (and one past), arrays and maps of 15, 16 and 65,536
  entries, fixext 1-16 and ext 8/16/32 payloads.
- Arrays: every dtype flax writes decodes exactly, bfloat16 as a
  ``torch.bfloat16`` tensor of the same bits; numpy scalars; chunked arrays
  (``flax.serialization.MAX_CHUNK_SIZE`` made small in this process).
- Bad input raises ``ValueError``: every truncation of a file, bytes past
  the end, an undefined marker, a complex number, an unknown dtype, an
  ndarray payload of the wrong size, a map key that is not a string.
"""

from __future__ import annotations

import math
import struct
import zipfile

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from tvc_ai_torch.utils import flax_msgpack


def assert_trees_equal(got, want, path: str = "") -> None:
    """``got`` (the port's decode) equal to ``want`` (flax's), leaf for leaf:
    arrays by dtype, shape and bits (a bfloat16 tensor against ml_dtypes'
    bfloat16 array), floats by bits, containers by type and keys."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, got, want)
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, (path, got)
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, got, want)
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), (path, got)
    elif isinstance(want, float):
        assert isinstance(got, float), (path, got)
        assert struct.pack(">d", got) == struct.pack(">d", want), (path, got, want)
    elif isinstance(want, msgpack.ExtType):
        assert isinstance(got, flax_msgpack.ExtType) and tuple(got) == tuple(want), (path, got)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def random_array(rng: np.random.Generator, name: str, shape) -> np.ndarray:
    """Seeded values that fill the dtype's range without casting out of it."""
    if name == "bool":
        return rng.random(shape) < 0.5
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.integers(info.min, info.max, size=shape, dtype=name, endpoint=True)
    if name.startswith("complex"):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(name)
    return (rng.normal(size=shape) * 1e3).astype(name)


def check(data: bytes) -> None:
    assert_trees_equal(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


# ------------------------------------------------------------- hypothesis
INTS = st.integers(-(2**63), 2**64 - 1)
FLOATS = st.floats(allow_nan=True, allow_infinity=True)
SCALARS = st.one_of(st.none(), st.booleans(), INTS, FLOATS, st.text(max_size=40),
                    st.binary(max_size=40))
EXT_CODES = st.integers(4, 127)   # flax defines 1-3; msgpack-python takes no other negative
EXTS = st.builds(msgpack.ExtType, EXT_CODES, st.binary(max_size=300))


def trees(leaves):
    return st.recursive(leaves, lambda inner: st.lists(inner, max_size=20)
                        | st.dictionaries(st.text(max_size=10), inner, max_size=20),
                        max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(trees(SCALARS | EXTS), st.booleans())
def test_decodes_msgpack_trees_as_flax(tree, single_float):
    check(msgpack.packb(tree, use_bin_type=True, use_single_float=single_float))


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=8), st.tuples(
    st.sampled_from(["float32", "float64", "int32", "uint8", "bool", "float16"]),
    st.lists(st.integers(0, 5), max_size=3)), max_size=6), st.integers(0, 2**32 - 1))
def test_decodes_flax_array_trees(spec, seed):
    rng = np.random.default_rng(seed)
    tree = {k: random_array(rng, dtype, shape) for k, (dtype, shape) in spec.items()}
    check(serialization.msgpack_serialize({"nested": tree, "flat": list(tree.values())}))


# ---------------------------------------------------------- the boundaries
INT_EDGES = sorted({s * v + d for v in (2**7, 2**8, 2**15, 2**16, 2**31, 2**32, 2**63)
                    for s in (1, -1) for d in (-1, 0, 1)
                    if -(2**63) <= s * v + d <= 2**64 - 1} | {0, 2**64 - 1, 2**64 - 2})


@pytest.mark.parametrize("kind", ["int", "str", "bin", "array", "map", "ext"])
def test_boundaries(kind):
    if kind == "int":
        values = INT_EDGES
    elif kind == "str":
        values = ["x" * n for n in (0, 31, 32, 255, 256, 65535, 65536)] + ["é" * 200]
    elif kind == "bin":
        values = [bytes(range(256)) * (n // 256) + bytes(n % 256)
                  for n in (0, 31, 32, 255, 256, 65535, 65536)]
    elif kind == "array":
        values = [list(range(n)) for n in (0, 15, 16, 65535, 65536)]
    elif kind == "map":
        values = [{str(i): i for i in range(n)} for n in (0, 15, 16, 65535, 65536)]
    else:
        values = [msgpack.ExtType(code, bytes(range(7)) * (n // 7) + bytes(n % 7))
                  for code in (5, 127) for n in (1, 2, 4, 8, 16, 0, 3, 255, 256, 65535, 65536)]
    for v in values:
        data = msgpack.packb({"v": v}, use_bin_type=True)
        check(data)
    # each width's marker is the one the boundaries call for
    if kind == "int":
        markers = {msgpack.packb(v)[0] for v in INT_EDGES}
        assert {0xcc, 0xcd, 0xce, 0xcf, 0xd0, 0xd1, 0xd2, 0xd3} <= markers


# ----------------------------------------------------------------- arrays
DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64", "complex64", "complex128"]


@pytest.mark.parametrize("shape", [(), (0,), (3,), (2, 0, 3), (4, 5)], ids=str)
def test_every_flax_dtype_decodes_exactly(shape):
    rng = np.random.default_rng(1)
    tree = {name: random_array(rng, name, shape) for name in DTYPES}
    tree["bfloat16"] = jnp.asarray(rng.normal(size=shape) * 1e3, jnp.bfloat16)
    tree["scalars"] = {name: random_array(rng, name, ())[()]
                       for name in ("float32", "int64", "bool", "uint8")}
    tree["bf16_scalar"] = jnp.asarray(1.5, jnp.bfloat16)
    data = serialization.msgpack_serialize(tree)
    check(data)
    got = flax_msgpack.msgpack_restore(data)
    assert isinstance(got["scalars"]["float32"], np.float32)
    assert isinstance(got["bfloat16"], torch.Tensor) and got["bfloat16"].shape == shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16"])
def test_chunked_arrays_decode_exactly(dtype, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 24)
    rng = np.random.default_rng(2)
    big = jnp.asarray(rng.normal(size=(7, 11)) * 100, dtype)
    tree = {"big": big, "inner": {"also": big[:3], "small": jnp.ones((2,), dtype)},
            "listed": [big]}   # flax chunks nothing inside a list: left as it is
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    check(data)
    got = flax_msgpack.msgpack_restore(data)
    assert tuple(got["big"].shape) == (7, 11)


def test_reads_bytes_bytearray_memoryview_and_files(tmp_path):
    data = serialization.msgpack_serialize({"a": np.arange(5.0), "b": [1, "two"]})
    for form in (data, bytearray(data), memoryview(data)):
        check(bytes(form))
        assert_trees_equal(flax_msgpack.msgpack_restore(form), serialization.msgpack_restore(data))
    path = tmp_path / "tree.msgpack"
    path.write_bytes(data)
    assert flax_msgpack.is_flax_msgpack(path)
    assert_trees_equal(flax_msgpack.load(path), serialization.msgpack_restore(data))


def test_is_flax_msgpack(tmp_path):
    cases = {
        "fixmap": msgpack.packb({"a": 1}),
        "map16": msgpack.packb({str(i): i for i in range(16)}),
        "map32": b"\xdf\x00\x00\x00\x00",
        "array": msgpack.packb([1, 2]),
        "int": msgpack.packb(7),
        "empty": b"",
    }
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
    torch.save({"state": {}}, tmp_path / "torch.pt")
    assert zipfile.is_zipfile(tmp_path / "torch.pt")
    got = {p.name: flax_msgpack.is_flax_msgpack(p) for p in tmp_path.iterdir()}
    assert got == {"fixmap": True, "map16": True, "map32": True, "array": False, "int": False,
                   "empty": False, "torch.pt": False}
    assert not flax_msgpack.is_flax_msgpack(tmp_path)
    assert not flax_msgpack.is_flax_msgpack(tmp_path / "absent")


# -------------------------------------------------------------- bad input
def test_every_truncation_raises():
    data = serialization.msgpack_serialize({
        "w": np.arange(6, dtype=np.float32).reshape(2, 3), "s": "text", "n": [1, 300, -70000],
        "f": 0.5, "b": b"\x00\x01", "bf": jnp.ones((2,), jnp.bfloat16)})
    for cut in range(len(data)):
        with pytest.raises(ValueError):
            flax_msgpack.msgpack_restore(data[:cut])
    with pytest.raises(ValueError, match="past the end"):
        flax_msgpack.msgpack_restore(data + b"\xc0")


def ndarray_ext(shape, name, buf) -> bytes:
    return msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb((shape, name, buf),
                                                                use_bin_type=True))})


@pytest.mark.parametrize("case", ["marker", "complex", "dtype", "size", "bf16_size", "key",
                                  "utf8", "not_a_tuple", "chunks"])
def test_bad_input_raises_value_error(case, monkeypatch):
    data = {
        "marker": b"\x81\xa1a\xc1",
        "complex": msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}),
        "dtype": ndarray_ext((2,), "float7_x", b"\x00" * 2),
        "size": ndarray_ext((3,), "float32", b"\x00" * 8),
        "bf16_size": ndarray_ext((3,), "bfloat16", b"\x00" * 4),
        "key": msgpack.packb({1: 2}, strict_types=False),
        "utf8": b"\x81\xa1a\xa2\xff\xfe",
        "not_a_tuple": msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb([1, 2]))}),
        "chunks": msgpack.packb({"a": {"__msgpack_chunked_array__": True,
                                       "shape": {"0": 2}, "chunks": {"1": 3}}}),
    }[case]
    match = {"dtype": "float7_x", "complex": "complex"}.get(case)
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


def test_load_names_the_file(tmp_path):
    path = tmp_path / "cut.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"a": np.ones(100)})[:50])
    with pytest.raises(ValueError, match="cut.msgpack"):
        flax_msgpack.load(path)


def test_deep_nesting_raises_value_error():
    data = b"\x91" * 100_000 + b"\xc0"
    with pytest.raises(ValueError, match="deeply"):
        flax_msgpack.msgpack_restore(data)


def test_a_default_width_file_decodes_in_place():
    """About a million float32s (a 256x256 agent file's size) in one array:
    the bytes are read once, without a copy per token."""
    w = np.random.default_rng(3).normal(size=(1000, 1000)).astype(np.float32)
    data = serialization.msgpack_serialize({"w": w})
    got = flax_msgpack.msgpack_restore(data)["w"]
    assert got.dtype == np.float32 and np.array_equal(got, w)
    assert math.prod(got.shape) == 1_000_000
