"""Weight sets cast once for a kernel, reused until a parameter changes.

The head's kernels take bf16 weight matrices, fp32 vectors and, on the card,
TMA maps encoded from the weights' addresses.  A model may keep its
parameters in another dtype (fp32 master weights), and the layer hands the
wrapper the same parameters call after call, so ``prepare`` casts them once
and keeps the result until one of them changes: another tensor object, a new
storage (``data_ptr``) or an in-place update (``_version``).  The plain
versions do not use it.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Optional, Sequence

import torch

__all__ = ["Prepared", "prepare"]

_MAX_ENTRIES = 64  # weight sets kept: every layer of the models a process serves
prepares = 0  # weight sets made (a replica on another device is a set of its own)


class Prepared:
    """One weight set: ``weights`` (bf16, contiguous) and ``vectors`` (fp32,
    contiguous) in the order given, and ``maps``, a slot for the kernel's
    encoded TMA maps (host bytes), which the wrapper fills at its first
    launch with this set."""

    __slots__ = ("weights", "vectors", "maps", "_refs", "_stamp")

    def __init__(self, weights, vectors, refs, stamp):
        self.weights = weights
        self.vectors = vectors
        self.maps: Optional[object] = None
        self._refs = refs
        self._stamp = stamp


_CACHE: "OrderedDict[tuple, Prepared]" = OrderedDict()


def _stamp(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype, str(t.device))
                 for t in tensors)


def prepare(kind: str, weights: Sequence[torch.Tensor],
            vectors: Sequence[torch.Tensor]) -> Prepared:
    """The prepared set of these tensors for kernel ``kind``: the cached one
    if every tensor is the same object with the same storage and version as
    when it was made, else a new one (which replaces it)."""
    tensors = (*weights, *vectors)
    key = (kind, tuple(id(t) for t in tensors))
    stamp = _stamp(tensors)
    entry = _CACHE.get(key)
    if (entry is not None and entry._stamp == stamp
            and all(r() is t for r, t in zip(entry._refs, tensors))):
        _CACHE.move_to_end(key)
        return entry
    global prepares
    prepares += 1
    with torch.no_grad():
        ws = tuple(w.detach().to(torch.bfloat16).contiguous() for w in weights)
        vs = tuple(v.detach().to(torch.float32).contiguous() for v in vectors)
    entry = Prepared(ws, vs, tuple(weakref.ref(t) for t in tensors), stamp)
    _CACHE[key] = entry
    _CACHE.move_to_end(key)
    while len(_CACHE) > _MAX_ENTRIES:
        _CACHE.popitem(last=False)
    return entry
