"""Read the JAX package's orbax checkpoint directories without JAX, orbax or
tensorstore.

``slice3d_tpu/train/checkpoint.py`` writes ``--ckpt_backend orbax`` /
``orbax_async`` checkpoints with orbax's ``StandardCheckpointHandler``: a
directory holding

* ``_METADATA`` (JSON): ``tree_metadata``, each leaf's key path and
  ``value_type`` (``jax.Array``, ``np.ndarray`` and ``scalar`` are arrays;
  ``None`` and ``Dict`` an empty entry), with ``use_ocdbt`` and ``use_zarr3``;
* an OCDBT store (``manifest.ocdbt``, ``d/``, and ``ocdbt.process_<i>/`` for
  each writing process; ``ocdbt.py``) of zarr v2 arrays: for the leaf at key
  path ``(a, b)`` the key ``a.b/.zarray`` holds its JSON metadata (shape,
  chunk shape, dtype, compressor) and ``a.b/<i>.<j>`` its chunk (i, j), in C
  order, zstd-compressed (the port's own decoder, ``zstd.py``).  A sharded
  array has one chunk per shard; edge chunks are stored at full chunk size.

``read_flax_orbax`` returns the tree that ``flax_msgpack.read_flax_msgpack``
returns for the same state written with ``backend="msgpack"``: nested dicts
with numpy arrays of the same dtypes and bytes (Python and numpy scalars are
0-d arrays there too, as the JAX package's msgpack write turns every leaf into
an array; ``bfloat16`` is widened exactly to float32), None and empty dicts
where the state had them.  Each leaf is one preallocated array that its chunks
fill, read and decoded on a thread pool, so the peak host memory is the state
plus the chunks in flight.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Any, Dict, List, Tuple

import numpy as np

from . import zstd
from .ocdbt import MANIFEST, OcdbtReader

__all__ = ["read_flax_orbax", "is_jax_orbax_dir"]

METADATA = "_METADATA"
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {"None": lambda: None, "Dict": dict}


def is_jax_orbax_dir(path: str) -> bool:
    """A directory of the JAX package's orbax backend: an OCDBT store or orbax's
    ``_METADATA``, and not the port's own checkpoint directory (DCP's
    ``.metadata``)."""
    return (os.path.isdir(path) and not os.path.isfile(os.path.join(path, ".metadata"))
            and any(os.path.isfile(os.path.join(path, n)) for n in (MANIFEST, METADATA)))


def _key_path(name: str, entry: dict, where: str) -> Tuple[str, ...]:
    if "key_metadata" not in entry:
        raise ValueError(f"{where}: leaf {name} has no key_metadata")
    return tuple(str(k["key"]) for k in entry["key_metadata"])


def _dtype(name: str, where: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"{where}: zarr dtype {name!r} is not supported") from None
    if dtype.kind not in "biufc":
        raise ValueError(f"{where}: zarr dtype {name!r} is not supported")
    return dtype, False


class _Array:
    """One leaf: its zarr v2 metadata and the array its chunks fill."""

    def __init__(self, where: str, meta: dict):
        self.where = where
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}, not 2")
        if meta.get("order", "C") != "C":
            raise ValueError(f"{where}: zarr order {meta.get('order')!r} is not supported (C)")
        if meta.get("filters"):
            raise ValueError(f"{where}: zarr filters {meta['filters']!r} are not supported")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ValueError(f"{where}: zarr compressor {compressor.get('id')!r} is not "
                             "supported (zstd or none)")
        self.compressed = compressor is not None
        if meta.get("dimension_separator", ".") != ".":
            raise ValueError(f"{where}: zarr dimension_separator "
                             f"{meta['dimension_separator']!r} is not supported (.)")
        self.shape = tuple(int(n) for n in meta["shape"])
        self.chunks = tuple(int(n) for n in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks):
            raise ValueError(f"{where}: zarr chunks {self.chunks} do not fit shape {self.shape}")
        self.stored, self.bf16 = _dtype(meta["dtype"], where)
        native = np.float32 if self.bf16 else self.stored.newbyteorder("=")
        self.out = np.empty(self.shape, native)
        self.grid = [range(-(-n // c)) for n, c in zip(self.shape, self.chunks)]

    def keys(self, name: str) -> List[Tuple[Tuple[int, ...], str]]:
        """(chunk index, its key) of every chunk."""
        if not self.shape:
            return [((), f"{name}/0")]
        return [(idx, f"{name}/{'.'.join(map(str, idx))}") for idx in product(*self.grid)]

    def fill(self, idx: Tuple[int, ...], data: bytes) -> None:
        """Decode chunk ``idx`` from its stored bytes into ``out``."""
        region = tuple(slice(i * c, min((i + 1) * c, n))
                       for i, c, n in zip(idx, self.chunks, self.shape))
        dest = self.out[region] if region else self.out[...]  # [...]: a 0-d view
        nbytes = int(np.prod(self.chunks, dtype=np.int64)) * self.stored.itemsize
        direct = (not self.bf16 and self.stored == self.out.dtype
                  and dest.shape == self.chunks and dest.flags.c_contiguous)
        if direct:  # the chunk is a contiguous part of the leaf: decode in place
            if self.compressed:
                zstd.decompress(data, out=dest)
            elif len(data) != nbytes:
                raise ValueError(f"{self.where}: chunk {idx} holds {len(data)} bytes, "
                                 f"{nbytes} expected")
            else:
                dest[...] = np.frombuffer(data, self.stored).reshape(self.chunks)
            return
        raw = zstd.decompress(data, size=nbytes) if self.compressed else data
        if len(raw) != nbytes:
            raise ValueError(f"{self.where}: chunk {idx} holds {len(raw)} bytes, "
                             f"{nbytes} expected")
        chunk = np.frombuffer(raw, self.stored).reshape(self.chunks)
        chunk = chunk[tuple(slice(0, s.stop - s.start) for s in region)]
        if self.bf16:
            dest[...] = (chunk.astype(np.uint32) << 16).view(np.float32)
        else:
            dest[...] = chunk


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def read_flax_orbax(path: str) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory written by the JAX package's
    ``save_checkpoint(..., backend="orbax" | "orbax_async")``, equal to
    ``read_flax_msgpack``'s of the same state written as msgpack.  Chunks are
    read and decoded on a thread pool of one thread a CPU.  A ``ValueError``
    names what it cannot read: zarr v3 or no OCDBT store, a compressor other
    than zstd, zarr filters, a missing chunk, an unknown ``value_type``."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} has no {METADATA}: not an orbax checkpoint of the JAX package")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is true; only zarr v2 arrays are supported")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: use_ocdbt is false; only arrays in an OCDBT store are "
                         "supported")
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise ValueError(f"{meta_path} has no tree_metadata")
    store = OcdbtReader(path)
    entries = store.entries()
    tree: Dict[str, Any] = {}
    jobs = []
    for name, entry in tree_meta.items():
        keys = _key_path(name, entry, path)
        kind = entry.get("value_metadata", {}).get("value_type")
        if kind in _EMPTY:
            _set(tree, keys, _EMPTY[kind]())
            continue
        if kind not in _ARRAYS:
            raise ValueError(f"{path}: leaf {'.'.join(keys)} has value_type {kind!r}, which "
                             f"is not supported ({', '.join(_ARRAYS + tuple(_EMPTY))})")
        param = ".".join(keys)
        zarray = entries.get(f"{param}/.zarray".encode())
        if zarray is None:
            raise ValueError(f"{path}: no {param}/.zarray in the OCDBT store")
        arr = _Array(f"{path}:{param}", json.loads(store.read(zarray)))
        _set(tree, keys, arr)
        for idx, key in arr.keys(param):
            value = entries.get(key.encode())
            if value is None:
                raise ValueError(f"{path}: chunk {key} is missing from the OCDBT store")
            jobs.append((arr, idx, value))

    def run(job) -> None:
        arr, idx, value = job
        arr.fill(idx, store.read(value))

    with ThreadPoolExecutor(max(1, min(os.cpu_count() or 1, len(jobs)))) as pool:
        list(pool.map(run, jobs))
    return _finish(tree)


def _finish(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _finish(v) for k, v in tree.items()}
    return tree.out if isinstance(tree, _Array) else tree
