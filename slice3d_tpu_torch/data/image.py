"""Host-side image IO without Pillow: a PNG codec, Pillow's bilinear resize
and the service's alpha-bbox recentering, in the standard library and numpy.

Images are numpy uint8 arrays as ``np.asarray(PIL.Image.open(...))`` gives
them: (H, W) grey, (H, W, 2) grey + alpha, (H, W, 3) RGB, (H, W, 4) RGBA.

* ``decode_png`` reads 8-bit grey, grey + alpha, RGB and RGBA PNGs,
  non-interlaced, with any of the five row filters; ``encode_png`` writes
  them (filter 0, zlib).
* ``resize_bilinear`` is Pillow's ``Image.resize(size, Image.BILINEAR)`` on
  8-bit images: a separable triangle filter whose support widens by the
  downscale factor, coefficients in 22-bit fixed point, the horizontal pass
  rounded to uint8 before the vertical one.
* ``center_rgba`` moves the alpha bounding box to the middle of the canvas
  the way Pillow's ``paste(img, offset, mask=alpha)`` onto a transparent
  canvas does (every channel, alpha included, blended by alpha).
* ``decode_image`` takes a PNG through ``decode_png`` and anything else
  (JPEG, palette or 16-bit PNGs) through Pillow when it is importable.
"""

from __future__ import annotations

import io
import math
import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "decode_image", "load_image", "resize_bilinear",
           "center_rgba", "UnsupportedImage"]

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels (8-bit)
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


class UnsupportedImage(ValueError):
    """An image this module cannot read without Pillow."""


def _chunks(data: bytes):
    pos = len(_SIG)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: a running sum per channel, modulo 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                    continue
                c = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} does not exist")
        out[y] = row
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit grey, grey + alpha, RGB or RGBA PNG bytes -> uint8 array;
    ``UnsupportedImage`` for other bit depths, palettes or interlacing."""
    if not data.startswith(_SIG):
        raise UnsupportedImage("not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise UnsupportedImage(f"PNG of bit depth {depth}, colour type {color}, interlace "
                               f"{interlace}: only 8-bit grey / grey+alpha / RGB / RGBA "
                               "non-interlaced PNGs are read without Pillow")
    if compression != 0 or filtering != 0:
        raise ValueError("PNG with an unknown compression or filter method")
    c = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return pixels.reshape(h, w) if c == 1 else pixels.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 1..4) -> PNG bytes (filter 0 on every row)."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 array.  PNGs of the kinds ``decode_png`` reads
    go through it; anything else needs Pillow, and without it raises
    ``UnsupportedImage`` saying so."""
    try:
        return decode_png(data)
    except UnsupportedImage as err:
        try:
            from PIL import Image
        except ImportError:
            raise UnsupportedImage(f"{err}; other image formats need Pillow, which is not "
                                   "installed (send an 8-bit PNG)") from None
        return np.asarray(Image.open(io.BytesIO(data)))


def load_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def _coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter, in 22-bit
    fixed point: (first input index (out,), weights (out, k) int64 with
    zeros past each window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ss = 1.0 / filterscale
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = 0.0
        for wv in ws:
            total += wv
        for x, wv in enumerate(ws):
            k = wv / total if total != 0.0 else wv
            kk[xx, x] = int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    first, kk = _coefficients(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)  # (out, k)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, ...)
    taps = src[idx]  # (out, k, ...)
    weights = kk.reshape(kk.shape + (1,) * (src.ndim - 1))
    acc = (taps * weights).sum(axis=1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W[, C]) -> (size[1], size[0][, C]), ``size`` as Pillow's
    (width, height): the horizontal pass first, rounded to uint8, then the
    vertical one; an axis whose size does not change is not resampled."""
    width, height = size
    out = np.asarray(img, np.uint8)
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0)
    return out


def center_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 with the alpha bounding box moved to the middle of a
    transparent canvas of the same size, every channel (alpha included)
    blended by alpha as Pillow's masked paste rounds it."""
    alpha = img[..., 3]
    ys, xs = np.nonzero(alpha)
    if len(ys) == 0:
        return img
    h, w = alpha.shape
    x0, y0 = int(xs.min()), int(ys.min())
    dx = (w - (int(xs.max()) + 1 - x0)) // 2 - x0
    dy = (h - (int(ys.max()) + 1 - y0)) // 2 - y0
    t = img.astype(np.uint32) * alpha[..., None] + 128
    blended = (((t >> 8) + t) >> 8).astype(np.uint8)
    out = np.zeros_like(img)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        blended[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out
