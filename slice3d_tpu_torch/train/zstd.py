"""zstd decompression and CRC-32C through the port's own decoder.

``native/zstd_decode.cpp`` is a decoder of RFC 8878 written for the JAX
package's orbax checkpoint directories (``ocdbt.py``, ``flax_orbax.py``),
built with g++ into the package's git-ignored build directory the first time
it is needed.  There is no other decode path: if the build fails, the call
raises.  The calls release the GIL (ctypes does), so chunks decode on a
thread pool.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import numpy as np

from ..native import build_library

__all__ = ["decompress", "crc32c", "load_library"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "zstd_decode.cpp")
_ERR_LEN = 256
_TOO_SMALL = -2


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the decoder."""
    lib = build_library("s3d_torch_zstd", [_SRC], ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"])
    if lib.s3d_zstd_decompress.argtypes is None:
        i64 = ctypes.c_int64
        lib.s3d_zstd_decompress.restype = i64
        lib.s3d_zstd_decompress.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p, i64,
                                            ctypes.c_char_p, ctypes.c_int]
        lib.s3d_zstd_content_size.restype = i64
        lib.s3d_zstd_content_size.argtypes = [ctypes.c_void_p, i64]
        lib.s3d_crc32c.restype = ctypes.c_uint32
        lib.s3d_crc32c.argtypes = [ctypes.c_void_p, i64]
    return lib


def _source(data) -> np.ndarray:
    """``data`` (bytes-like) as a C-contiguous uint8 array, without a copy
    where it already is one."""
    return np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))


def _decode(lib, src: np.ndarray, out: np.ndarray) -> int:
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.s3d_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, out.size,
                                err, _ERR_LEN)
    if n == _TOO_SMALL:
        return n
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return n


def decompress(data, size: Optional[int] = None,
               out: Optional[np.ndarray] = None) -> Union[bytes, np.ndarray]:
    """The decompressed content of ``data``: one or more zstd frames
    (skippable frames among them), as ``bytes``.

    With ``size``: a uint8 array of exactly ``size`` bytes (a ``ValueError``
    if the frames hold another amount).  With ``out`` (a writable C-contiguous
    array): the content written into its bytes, which it must fill exactly;
    ``out`` is returned.  Corrupt data, a checksum mismatch or a frame that
    needs a dictionary raise a ``ValueError``."""
    lib = load_library()
    src = _source(data)
    if out is not None or size is not None:
        if out is None:
            out = np.empty(size, np.uint8)
        if not out.flags.c_contiguous or not out.flags.writeable:
            raise ValueError("decompress needs a writable C-contiguous output array")
        view = out.reshape(-1).view(np.uint8)
        n = _decode(lib, src, view)
        if n != view.size:
            held = "more" if n == _TOO_SMALL else f"{n}"
            raise ValueError(f"zstd data holds {held} bytes, {view.size} expected")
        return out
    known = lib.s3d_zstd_content_size(src.ctypes.data, src.size) if src.size else -3
    if known >= 0:
        buf = np.empty(known, np.uint8)
        n = _decode(lib, src, buf)
        if n != known:
            raise ValueError(f"zstd data holds {n} bytes, its frames declare {known}")
        return buf.tobytes()
    cap = max(4 * src.size, 1 << 16)  # no declared size: grow until it fits
    while True:
        buf = np.empty(cap, np.uint8)
        n = _decode(lib, src, buf)
        if n != _TOO_SMALL:
            return buf[:n].tobytes()
        cap *= 4


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data`` (bytes-like)."""
    src = _source(data)
    return int(load_library().s3d_crc32c(src.ctypes.data, src.size))
