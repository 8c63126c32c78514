"""A read-only OCDBT key-value store: the on-disk format in which orbax (through
tensorstore) writes a checkpoint directory.

An OCDBT store is a B+tree of keys and values.  ``manifest.ocdbt`` at its root
names the newest version's root node; nodes, and values too large to sit
inline in a leaf, lie at (offset, length) in data files under ``d/``.  Every
manifest and node is laid out as

    magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node)
    length of the whole file or node (uint64 little-endian)
    format version (varint, 0)
    compression (varint: 0 none, 1 zstd)
    body (a zstd frame if compressed)
    CRC-32C of everything before it (uint32 little-endian)

and their bodies are columns of varints: the manifest's config, a data file
table and the newest versions (generation, root height, root node reference,
statistics, commit time); a node's height, data file table and entries (keys
prefix-compressed against the previous key; in a leaf each value inline or a
reference into a data file, in an interior node each child's reference and
the length of the key prefix that its whole subtree shares, which its keys
leave out).  A multi-process orbax write gives each process a store of its own
under ``ocdbt.process_<i>/`` and a root store whose leaves point into their
data files: a data file's path is relative to the directory of the file that
names it.

The format is tensorstore's ("kvstore/ocdbt" in its documentation); this
reader implements version 0 with zstd or no compression and a manifest that
holds its versions inline (``manifest_kind`` single), which is what orbax
writes.  Anything else raises a ``ValueError`` naming it.  Data files are read
by offset and length, never whole; values are returned as ``bytes``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

from . import zstd

__all__ = ["OcdbtReader", "ValueRef", "MANIFEST"]

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # offset and length of the root of an empty version
_HEADER_MIN = 4 + 8 + 1 + 1


class ValueRef(NamedTuple):
    """A value stored in a data file: ``length`` bytes at ``offset`` of ``path``."""

    path: str
    offset: int
    length: int


class _Ref(NamedTuple):
    """A node: its data file (directory of base path, relative path), offset, length."""

    base: str
    path: str
    offset: int
    length: int


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.buf = memoryview(data)
        self.pos = 0
        self.what = what

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError(f"{self.what} is truncated at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            if shift > 63 or (shift == 63 and b > 1):
                raise ValueError(f"{self.what}: varint longer than 64 bits at byte {self.pos}")
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _open_file(data: bytes, magic: int, what: str) -> _Cursor:
    """The body of a manifest or node after checking its magic, length, format
    version, compression and CRC-32C (decompressed where it is zstd)."""
    if len(data) < _HEADER_MIN + 4:
        raise ValueError(f"{what}: {len(data)} bytes is too short for an OCDBT file")
    found = struct.unpack(">I", data[:4])[0]
    if found != magic:
        raise ValueError(f"{what}: magic 0x{found:08x}, not 0x{magic:08x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, {len(data)} read")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Cursor(data[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not supported (only 0)")
    compression = head.varint()
    body = head.buf[head.pos:]
    if compression == 1:
        return _Cursor(zstd.decompress(body), what)
    if compression != 0:
        raise ValueError(f"{what}: OCDBT compression method {compression} is not supported "
                         "(0 none, 1 zstd)")
    return _Cursor(bytes(body), what)


def _data_files(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """A data file table: (directory of the file's base path, path relative to
    the store) of each file.  Paths are prefix-compressed against the previous
    one, and relative to ``base``, the base path of the file being read."""
    n = cur.varint()
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise ValueError(f"{cur.what}: data file path prefix out of range")
        path = prev[:keep] + bytes(cur.take(suffix[i]))
        if base_len[i] > len(path):
            raise ValueError(f"{cur.what}: data file base path longer than its path")
        name = path.decode()
        parts = name.split("/")
        if name.startswith("/") or ".." in parts:
            raise ValueError(f"{cur.what}: data file path {name!r} leaves the store")
        out.append((base + name[:base_len[i]], base + name))
        prev = path
    return out


def _keys(cur: _Cursor, n: int, extra: bool) -> Tuple[List[bytes], List[int]]:
    """``n`` prefix-compressed keys (with each entry's subtree common prefix
    length where ``extra``, an interior node's column between the lengths and
    the key bytes)."""
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if extra else []
    keys, prev = [], b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise ValueError(f"{cur.what}: key prefix out of range")
        prev = prev[:keep] + bytes(cur.take(suffix[i]))
        keys.append(prev)
    return keys, common


class OcdbtReader:
    """The newest version of the OCDBT store at directory ``root``.

    ``entries()`` walks its tree once: every key (``bytes``, in order) with its
    value, ``bytes`` where it is inline and a ``ValueRef`` where it lies in a
    data file.  ``read(value)`` gives the bytes of either.
    """

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST)
        if not os.path.isfile(path):
            raise ValueError(f"{root} has no {MANIFEST}: not an OCDBT store")
        with open(path, "rb") as f:
            cur = _open_file(f.read(), _MANIFEST_MAGIC, path)
        cur.take(16)  # uuid
        kind = cur.varint()
        cur.varint()  # max inline value bytes
        self.max_decoded_node_bytes = cur.varint()
        cur.byte()  # version tree arity (log2)
        method = cur.varint()
        if method == 1:
            cur.i32()  # zstd level
        elif method != 0:
            raise ValueError(f"{path}: OCDBT compression method {method} is not supported")
        if kind != 0:
            raise ValueError(f"{path}: OCDBT manifest kind {kind} (versions in numbered "
                             "manifest files) is not supported; orbax writes kind 0")
        files = _data_files(cur, "")
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{path}: the manifest holds no version")
        generation = cur.varints(n)
        height = [cur.byte() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(2 * n)  # tree bytes, indirect value bytes
        commit = [cur.u64() for _ in range(n)]
        newest = max(range(n), key=lambda i: generation[i])
        self.generation, self.commit_time_ns = generation[newest], commit[newest]
        self.num_keys = num_keys[newest]
        self._root: Optional[_Ref] = None
        self._height = height[newest]
        if offset[newest] != _NO_ROOT or length[newest] != _NO_ROOT:
            if file_id[newest] >= len(files):
                raise ValueError(f"{path}: root node in data file {file_id[newest]} of "
                                 f"{len(files)}")
            self._root = _Ref(*files[file_id[newest]], offset[newest], length[newest])
        self._entries: Optional[Dict[bytes, Union[bytes, ValueRef]]] = None

    def _path(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def _node(self, ref: _Ref, prefix: bytes, height: int,
              out: Dict[bytes, Union[bytes, ValueRef]]) -> None:
        what = f"{self._path(ref.path)}@{ref.offset}"
        data = self.read(ValueRef(self._path(ref.path), ref.offset, ref.length))
        cur = _open_file(data, _NODE_MAGIC, what)
        if self.max_decoded_node_bytes and len(cur.buf) > self.max_decoded_node_bytes:
            raise ValueError(f"{what}: node of {len(cur.buf)} bytes above the store's "
                             f"{self.max_decoded_node_bytes}")
        found = cur.byte()
        if found != height:
            raise ValueError(f"{what}: node of height {found} where {height} was expected")
        files = _data_files(cur, ref.base)
        n = cur.varint()
        keys, common = _keys(cur, n, extra=height > 0)

        def file_of(i: int) -> Tuple[str, str]:
            if i >= len(files):
                raise ValueError(f"{what}: data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"{what}: subtree prefix longer than its key")
                self._node(_Ref(*file_of(ids[i]), offsets[i], lengths[i]),
                           prefix + keys[i][:common[i]], height - 1, out)
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)} is not supported (0 inline, "
                             "1 in a data file)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if i in where:
                file_id, offset = where[i]
                out[prefix + keys[i]] = ValueRef(self._path(file_of(file_id)[1]), offset,
                                                 lengths[i])
            else:
                out[prefix + keys[i]] = bytes(cur.take(lengths[i]))

    def entries(self) -> Dict[bytes, Union[bytes, ValueRef]]:
        """Every key of the newest version with its value (inline bytes or a
        ``ValueRef``), in key order."""
        if self._entries is None:
            out: Dict[bytes, Union[bytes, ValueRef]] = {}
            if self._root is not None:
                self._node(self._root, b"", self._height, out)
            if list(out) != sorted(out):
                raise ValueError(f"{self.root}: OCDBT keys out of order")
            if len(out) != self.num_keys:
                raise ValueError(f"{self.root}: {len(out)} keys found, the manifest says "
                                 f"{self.num_keys}")
            self._entries = out
        return self._entries

    @staticmethod
    def read(value: Union[bytes, ValueRef]) -> bytes:
        """A value's bytes: inline ones as they are, a ``ValueRef``'s read from
        its data file by offset and length."""
        if isinstance(value, ValueRef):
            with open(value.path, "rb") as f:
                data = os.pread(f.fileno(), value.length, value.offset)
            if len(data) != value.length:
                raise ValueError(f"{value.path}: {value.length} bytes at {value.offset} "
                                 f"wanted, {len(data)} there")
            return data
        return value
