"""Read the JAX package's msgpack checkpoints without JAX, flax or msgpack.

``slice3d_tpu/train/checkpoint.py`` writes a checkpoint with flax's
``serialization.msgpack_serialize`` of a ``to_state_dict`` tree: plain
msgpack in which every array is an ext value of type 1 holding a msgpack
``(shape, dtype name, C-order bytes)`` triple, numpy scalars are ext type 3
in the same form, complex numbers ext type 2, and an array larger than
flax's ``MAX_CHUNK_SIZE`` is split into a ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}`` dict.  Tuples and lists were turned
into dicts keyed ``"0"``, ``"1"``, ... and optax's named tuples into dicts
keyed by field name before serialisation, so a checkpoint is a tree of dicts.

``read_flax_msgpack`` returns that tree as ``flax.serialization.
msgpack_restore`` does: nested dicts of numpy arrays and Python scalars, the
chunked arrays joined.  ``bfloat16`` has no numpy dtype: such arrays are
widened to float32 (exactly: a bf16 value is the top half of an fp32 one).

``read_flax_checkpoint`` reads either kind of checkpoint the JAX package
writes: a msgpack file as above, or an orbax directory (``--ckpt_backend
orbax`` / ``orbax_async``) through ``flax_orbax.read_flax_orbax``, which gives
the same tree.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

from .flax_orbax import is_jax_orbax_dir, read_flax_orbax

__all__ = ["decode_msgpack", "read_flax_msgpack", "read_flax_checkpoint", "NOT_A_CHECKPOINT"]

NOT_A_CHECKPOINT = (
    "{path} is a directory but not a checkpoint: neither the port's (DCP's .metadata) "
    "nor the JAX package's orbax one (manifest.ocdbt, _METADATA)")

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# fixed-width heads: (struct format, size) of the value after the type byte
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
          0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8)}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """A cursor over msgpack bytes; ``value()`` decodes one object."""

    def __init__(self, data, raw: bool, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.views = views  # bin values as views of ``data``, not copies

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def _length(self, width: int) -> int:
        return self._unpack(_LENGTH[width], width)

    def _str(self, n: int):
        data = self._take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = decode_msgpack(data)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")

    def value(self) -> Any:
        head = self._take(1)[0]
        if head <= 0x7f:
            return head
        if head >= 0xe0:
            return head - 0x100
        if 0x80 <= head <= 0x8f:
            return self._map(head & 0x0f)
        if 0x90 <= head <= 0x9f:
            return self._array(head & 0x0f)
        if 0xa0 <= head <= 0xbf:
            return self._str(head & 0x1f)
        if head == 0xc0:
            return None
        if head in (0xc2, 0xc3):
            return head == 0xc3
        if head in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            data = self._take(self._length(1 << (head - 0xc4)))
            return data if self.views else bytes(data)
        if head in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
            n = self._length(1 << (head - 0xc7))
            return self._ext(self._unpack(">b", 1), n)
        if head in _FIXED:
            fmt, n = _FIXED[head]
            return self._unpack(fmt, n)
        if head in _FIXEXT:
            return self._ext(self._unpack(">b", 1), _FIXEXT[head])
        if head in (0xd9, 0xda, 0xdb):  # str 8/16/32
            return self._str(self._length(1 << (head - 0xd9)))
        if head in (0xdc, 0xdd):  # array 16/32
            return self._array(self._length(2 if head == 0xdc else 4))
        if head in (0xde, 0xdf):  # map 16/32
            return self._map(self._length(2 if head == 0xde else 4))
        raise ValueError(f"byte 0x{head:02x} at {self.pos - 1} does not start a msgpack value")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def decode_msgpack(data, raw: bool = False, views: bool = False) -> Any:
    """One msgpack object from ``data`` (bytes-like): maps -> dicts, arrays ->
    lists, str -> str (bytes with ``raw``), bin -> bytes (memoryviews of
    ``data`` with ``views``), ints, floats, nil, bools, and flax's ext types
    -> numpy arrays, numpy scalars, complex."""
    reader = _Reader(data, raw, views)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return out


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype to read the bytes with, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name).newbyteorder("<"), False


def _ndarray_from_bytes(data) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a msgpack (shape, dtype name, bytes)
    triple -> a numpy array (little-endian, C order; bf16 widened to fp32)."""
    shape, name, buffer = decode_msgpack(data, raw=True, views=True)
    dtype, bf16 = _dtype(name.decode() if isinstance(name, bytes) else name)
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")
    if bf16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(dtype.newbyteorder("="), copy=False)


def _tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    """Join flax's chunked large arrays, everywhere in the tree."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = _tuple(tree["shape"])
            return np.concatenate(_tuple(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(path: str) -> Any:
    """The tree of a msgpack checkpoint written by the JAX package's
    ``save_checkpoint(..., backend="msgpack")``; a ``ValueError`` for a
    directory, which ``read_flax_checkpoint`` reads."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, not a msgpack file: read_flax_checkpoint "
                         "reads the JAX package's orbax directories")
    with open(path, "rb") as f:
        data = f.read()
    return _unchunk(decode_msgpack(data))


def read_flax_checkpoint(path: str) -> Any:
    """The tree of a checkpoint written by the JAX package's
    ``save_checkpoint``: a msgpack file (``read_flax_msgpack``) or an orbax
    directory (``read_flax_orbax``), the same tree for the same state.  Any
    other directory raises a ``ValueError``."""
    if is_jax_orbax_dir(path):
        return read_flax_orbax(path)
    if os.path.isdir(path):
        raise ValueError(NOT_A_CHECKPOINT.format(path=path))
    return read_flax_msgpack(path)
