"""Read an OCDBT key-value store (tensorstore's format) without tensorstore.

orbax writes a checkpoint item (``<step>/carry``) as one OCDBT database:

- ``manifest.ocdbt`` holds the database's configuration, a table of data
  files, the newest versions inline and references to version tree nodes
  for older ones. Each version names the root of a b-tree.
- data files (``d/<hex>``, also under ``ocdbt.process_<i>/`` for what each
  process wrote before orbax merged them) hold b-tree nodes, version tree
  nodes and values stored out of line, at an offset and a length.
- every manifest and node is framed: magic (big-endian u32), total length
  (u64), format version and compression (varints; compression 1 is zstd,
  decoded by ``utils.zstd``), the body, and a CRC-32C of everything before.
- a b-tree leaf lists keys (each sharing a prefix with the key before it)
  with values inline or as (data file, offset, length); an interior node
  lists its children with the key prefix all their keys share, which their
  own keys leave out.
- a data file table entry is a base path and a path relative to it; the
  paths in a node are relative to the base path of the file that holds it.

``OcdbtReader(directory)`` reads the newest version; ``list(prefix)`` and
``read(key)`` answer from it. A format version other than 0, an unknown
compression or manifest kind, a checksum mismatch, and a missing or short
data file raise ``ValueError``.
"""

from __future__ import annotations

from pathlib import Path

from tvc_ai_torch.utils import zstd

__all__ = ["OcdbtReader"]

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_TREE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
MANIFEST = "manifest.ocdbt"


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads a decoded body front to back."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> list[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes past its end")


def _unframe(raw: bytes, magic: int, what: str) -> _Cursor:
    """The decoded body of a manifest or node, its frame checked."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: not an OCDBT {hex(magic)} record")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{what}: length field says {int.from_bytes(raw[4:12], 'little')}, "
                         f"the record holds {len(raw)} bytes")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{what}: checksum mismatch")
    head = _Cursor(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}, this reader knows 0")
    body = raw[12 + head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"{what}: unknown compression format {compression}")
    return _Cursor(body, what)


def _file_table(cur: _Cursor, base: str) -> list[tuple[str, str]]:
    """(base path, path) of each data file of a table, ``base`` (the base
    path of the file holding the table) in front of both."""
    n = cur.varint()
    if not n:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{cur.what}: data file path shares more than the one before")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"{cur.what}: data file base path longer than its path")
        prev = path
        files.append((base + path[:base_len[i]].decode(), base + path.decode()))
    return files


def _location(files: list, file_id: int, what: str) -> tuple[str, str]:
    if file_id >= len(files):
        raise ValueError(f"{what}: data file {file_id} of a table of {len(files)}")
    return files[file_id]


class OcdbtReader:
    """The newest version of the OCDBT database in ``directory``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self._entries: dict[bytes, bytes | tuple[str, int, int]] = {}
        root = self._newest_root()
        if root is not None:
            self._walk(*root, prefix=b"")

    # ------------------------------------------------------------ reading
    def _file_bytes(self, path: str, offset: int, length: int) -> bytes:
        full = self.directory / path
        try:
            with full.open("rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as exc:
            raise ValueError(f"OCDBT data file {full} unreadable: {exc}") from None
        if len(data) != length:
            raise ValueError(f"OCDBT data file {full} holds {offset + len(data)} bytes, "
                             f"a reference needs {offset + length}")
        return data

    def _record(self, loc: tuple[str, str], offset: int, length: int, magic: int
                ) -> tuple[_Cursor, str]:
        base, path = loc
        what = f"{path}@{offset}"
        return _unframe(self._file_bytes(path, offset, length), magic, what), base

    # ------------------------------------------------------------ versions
    def _newest_root(self) -> tuple | None:
        """(height, location, offset, length) of the newest version's b-tree
        root, None for an empty database."""
        path = self.directory / MANIFEST
        if not path.is_file():
            raise ValueError(f"no OCDBT manifest at {path}")
        cur = _unframe(path.read_bytes(), MANIFEST_MAGIC, str(path))
        cur.take(16)                                          # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered manifests are not read)")
        cur.varint(), cur.varint()                            # max inline / node bytes
        cur.byte()                                            # version tree arity (log2)
        method = cur.varint()
        if method == 1:
            cur.take(4)                                       # zstd level
        elif method != 0:
            raise ValueError(f"{path}: unknown compression method {method}")
        files = _file_table(cur, "")
        versions = self._versions(cur, files)
        refs = self._version_refs(cur, files, with_height=True)
        cur.end()
        return self._newest(versions, refs)

    def _newest(self, versions: list, refs: list) -> tuple | None:
        best_v = max(versions, key=lambda v: v[0], default=None)
        best_r = max(refs, key=lambda r: r[0], default=None)
        if best_r is not None and (best_v is None or best_r[0] > best_v[0]):
            _, loc, offset, length, height = best_r
            cur, base = self._record(loc, offset, length, VERSION_TREE_MAGIC)
            cur.byte()                                        # arity (log2)
            if cur.byte() != height:
                raise ValueError(f"{cur.what}: version tree node of another height")
            files = _file_table(cur, base)
            if height == 0:
                versions, refs = self._versions(cur, files), []
            else:
                versions, refs = [], self._version_refs(cur, files, with_height=False,
                                                        height=height - 1)
            cur.end()
            return self._newest(versions, refs)
        if best_v is None:
            return None
        generation, height, loc, offset, length, num_keys = best_v
        return None if num_keys == 0 else (height, loc, offset, length)

    @staticmethod
    def _versions(cur: _Cursor, files: list) -> list[tuple]:
        n = cur.varint()
        generation = cur.varints(n)
        height = [cur.byte() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(n), cur.varints(n), cur.u64s(n)      # tree bytes, indirect bytes, time
        return [(generation[i], height[i], _location(files, file_id[i], cur.what), offset[i],
                 length[i], num_keys[i]) for i in range(n)]

    @staticmethod
    def _version_refs(cur: _Cursor, files: list, with_height: bool, height: int = 0
                      ) -> list[tuple]:
        n = cur.varint()
        generation = cur.varints(n)
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(n), cur.u64s(n)                        # generations, commit time
        heights = [cur.byte() for _ in range(n)] if with_height else [height] * n
        return [(generation[i], _location(files, file_id[i], cur.what), offset[i], length[i],
                 heights[i]) for i in range(n)]

    # ------------------------------------------------------------ b-tree
    def _walk(self, height: int, loc: tuple, offset: int, length: int, prefix: bytes) -> None:
        cur, base = self._record(loc, offset, length, BTREE_MAGIC)
        if cur.byte() != height:
            raise ValueError(f"{cur.what}: b-tree node of another height")
        files = _file_table(cur, base)
        n = cur.varint()
        shared = [0] + cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        common = cur.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise ValueError(f"{cur.what}: key shares more than the key before it")
            prev = prev[:shared[i]] + cur.take(suffix[i])
            keys.append(prev)
        if height:
            file_id, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(n), cur.varints(n), cur.varints(n)   # keys, tree / indirect bytes
            cur.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"{cur.what}: subtree prefix longer than its key")
                self._walk(height - 1, _location(files, file_id[i], cur.what), offsets[i],
                           lengths[i], prefix + keys[i][:common[i]])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{cur.what}: unknown value kind in {sorted(set(kinds))}")
        out_of_line = [i for i in range(n) if kinds[i] == 1]
        file_id, offsets = cur.varints(len(out_of_line)), cur.varints(len(out_of_line))
        for j, i in enumerate(out_of_line):
            _, path = _location(files, file_id[j], cur.what)
            self._entries[prefix + keys[i]] = (path, offsets[j], lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._entries[prefix + keys[i]] = cur.take(lengths[i])
        cur.end()

    # ------------------------------------------------------------ queries
    def list(self, prefix: bytes | str = b"") -> list[bytes]:
        """The keys that start with ``prefix``, sorted."""
        p = prefix.encode() if isinstance(prefix, str) else prefix
        return sorted(k for k in self._entries if k.startswith(p))

    def __contains__(self, key: bytes | str) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._entries

    def read(self, key: bytes | str) -> bytes:
        """The value of ``key``; ``KeyError`` when the database lacks it."""
        value = self._entries[key.encode() if isinstance(key, str) else key]
        if isinstance(value, bytes):
            return value
        return self._file_bytes(*value)
