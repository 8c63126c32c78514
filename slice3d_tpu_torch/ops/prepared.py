"""What the kernel wrappers share: weight sets cast once for a kernel and
reused until a parameter changes, the one-dtype rule of a call
(``one_kernel_dtype``) and 16-byte aligned inputs (``aligned``).

The head's bf16 kernels take bf16 weight matrices, fp32 vectors and, on the
card, TMA maps encoded from the weights' addresses; its fp32 kernels take
fp32 weight matrices packed into the order they stream them (``pack``) and
fp32 vectors, and no maps.  A model may keep its parameters in another dtype
than the kernel's (fp32 master weights under a bf16 kernel), and the layer
hands the wrapper the same parameters call after call, so ``prepare`` casts
(and packs) them once and keeps the result until one of them changes:
another tensor object, a new storage (``data_ptr``) or an in-place update
(``_version``).  The weights' dtype is part of the key: a bf16 set and an
fp32 set of the same parameters are two sets.  The plain versions do not
use it.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["Prepared", "prepare", "one_kernel_dtype", "aligned", "KERNEL_DTYPES"]

KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the dtypes the kernels take

_MAX_ENTRIES = 64  # weight sets kept: every layer of the models a process serves
prepares = 0  # weight sets made (a replica on another device is a set of its own)


class Prepared:
    """One weight set: ``weights`` (in the kernel's dtype, contiguous; packed
    where ``prepare`` was given a ``pack``) and ``vectors`` (fp32,
    contiguous) in the order given, and ``maps``, a slot for a bf16 kernel's
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


def prepare(kind: str, weights: Sequence[torch.Tensor], vectors: Sequence[torch.Tensor],
            dtype: torch.dtype = torch.bfloat16,
            pack: Optional[Callable[..., Sequence[torch.Tensor]]] = None) -> Prepared:
    """The prepared set of these tensors for kernel ``kind`` with weights in
    ``dtype``: the cached one if every tensor is the same object with the
    same storage and version as when it was made, else a new one (which
    replaces it).  ``pack`` maps the cast weights to the tensors the kernel
    reads (the fp32 kernels' streams)."""
    tensors = (*weights, *vectors)
    key = (kind, dtype, tuple(id(t) for t in tensors))
    stamp = _stamp(tensors)
    entry = _CACHE.get(key)
    if (entry is not None and entry._stamp == stamp
            and all(r() is t for r, t in zip(entry._refs, tensors))):
        _CACHE.move_to_end(key)
        return entry
    global prepares
    prepares += 1
    with torch.no_grad():
        ws = tuple(w.detach().to(dtype).contiguous() for w in weights)
        if pack is not None:
            ws = tuple(w.contiguous() for w in pack(*ws))
        vs = tuple(v.detach().to(torch.float32).contiguous() for v in vectors)
    entry = Prepared(ws, vs, tuple(weakref.ref(t) for t in tensors), stamp)
    _CACHE[key] = entry
    _CACHE.move_to_end(key)
    while len(_CACHE) > _MAX_ENTRIES:
        _CACHE.popitem(last=False)
    return entry


def one_kernel_dtype(kind: str, named: Sequence[Tuple[str, torch.Tensor]]) -> torch.dtype:
    """The one dtype of the named tensors for kernel ``kind``, which must be
    one of ``KERNEL_DTYPES``: a ``TypeError`` names the first tensor that is
    not, or that differs from the first tensor's.  Reads dtypes only, on any
    device."""
    first = named[0][1].dtype
    for name, x in named:
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{kind} kernels take bf16 or fp32, got {name} {x.dtype}")
        if x.dtype != first:
            raise TypeError(f"{kind} kernels take one dtype a call, got {named[0][0]} "
                            f"{first} and {name} {x.dtype}")
    return first


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernels' TMA and
    16-byte loads need it; a view into a larger tensor may start anywhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()
