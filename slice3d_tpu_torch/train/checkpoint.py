"""Checkpoints of the port's trainers: one ``torch.save`` file, or a sharded
checkpoint directory of ``torch.distributed.checkpoint`` (DCP).

``--ckpt_backend`` keeps the JAX package's names
(``slice3d_tpu/train/checkpoint.py``):

* ``msgpack`` (the default): one ``torch.save`` file of a dictionary of
  tensors, numbers and optimizer state.  The optimizer payloads gather
  moments sharded over the ``model`` axis (``parallel.shard_params_fsdp``)
  before a write and hand each process its part on a read, so sharded and
  unsharded runs read and write one file; one process writes it.  (The JAX
  package writes a flax msgpack file here; ``flax_msgpack.py`` reads those.)
* ``orbax``: a directory in DCP's format, not orbax's: ``.metadata`` and the
  ``__<rank>_<n>.distcp`` files.  Every process of the group calls the save
  with the tensors as they lie (``optimizer_shards``: a sharded parameter's
  shards, nothing gathered) and writes the shards it holds; a tensor that
  several processes hold whole is written once, by the process DCP picks.
  A restore through a target reads each process's own part into the
  target's tensors in place, and reshards on the way where the target lies
  otherwise (another ``model`` axis, or no sharding at all).
* ``orbax_async``: the same directory written by ``dcp.async_save``: the
  call returns once the state is copied to host memory, and the write to
  storage runs on a background thread.  One save is in flight at a time;
  ``wait_pending`` ends it (and runs at exit).

Every write goes to ``path + ".tmp"``, which takes the name ``path`` once
the write has ended (an asynchronous one when its future completes, or in
``wait_pending``), so a reader never sees half a checkpoint and no file of
an earlier write (of another world size) survives in a directory.  The
directory saves coordinate over a gloo group of their own (DCP's
background thread must not share the training's group).  The JAX package's
orbax directories (an OCDBT store, no ``.metadata``) are not this format:
``flax_msgpack.read_flax_checkpoint`` and the trainers' ``restore`` read them,
and ``restore_checkpoint`` refuses them, naming those.

``latest_checkpoint`` picks the newest file or directory by modification
time (``--resume``), and ``TopKCheckpointer`` keeps the k best by a
monitored metric beside ``last.ckpt``, as the reference's ModelCheckpoint
does (gen_slices/main.py:576-597).
"""

from __future__ import annotations

import atexit
import glob
import os
import shutil
import sys
import threading
import zipfile
from concurrent.futures import Future
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..parallel.mesh import in_group, is_main_process
from ..parallel.sharding import full_tensor, shard_like
from .flax_msgpack import NOT_A_CHECKPOINT
from .flax_orbax import is_jax_orbax_dir

__all__ = ["BACKENDS", "check_backend", "save_checkpoint", "restore_checkpoint", "wait_pending",
           "is_checkpoint_dir", "latest_checkpoint", "is_torch_file", "adam_payload",
           "load_adam_payload", "optimizer_payload", "load_optimizer_payload",
           "optimizer_shards", "TopKCheckpointer"]

BACKENDS = ("msgpack", "orbax", "orbax_async")


def check_backend(backend: str) -> str:
    """``backend`` if it is one of BACKENDS, else a ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}: one of {BACKENDS}")
    return backend


def is_checkpoint_dir(path: str) -> bool:
    """A checkpoint directory of :func:`save_checkpoint`: DCP's, with its
    ``.metadata``."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, ".metadata"))


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def _replace(tmp: str, path: str) -> None:
    """Put the finished write ``tmp`` at ``path``, in place of whatever file or
    directory is there."""
    old = None
    if os.path.isdir(path) or (os.path.isdir(tmp) and os.path.lexists(path)):
        old = path + ".old"
        _remove(old)
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        _remove(old)


_GROUP: Optional[tuple] = None  # (the default group it was made in, the checkpoints' group)


def _group():
    """The gloo group the directory saves coordinate over, made by every
    process at the first save of each process group (DCP's asynchronous
    save needs a CPU group, and its collectives run on a background thread
    beside the training's); None without a group."""
    global _GROUP
    if not in_group():
        return None
    world = dist.group.WORLD
    if _GROUP is None or _GROUP[0] is not world:
        _GROUP = (world, dist.new_group(backend="gloo"))
    return _GROUP[1]


class _Pending:
    """An ``orbax_async`` save in flight: its future and, on the process that
    renames (rank 0), the temporary directory and the name it takes."""

    def __init__(self, future: Future, tmp: Optional[str], path: str):
        self.future, self.tmp, self.path = future, tmp, path
        self.lock = threading.Lock()
        self.done = False
        self.error: Optional[BaseException] = None
        future.add_done_callback(lambda _: self.finish(quiet=True))

    def finish(self, quiet: bool = False) -> None:
        """Once the future has completed: the rename (once), or the write's
        error, raised unless ``quiet``."""
        with self.lock:
            if not self.done:
                self.done = True
                try:
                    self.future.result()
                    if self.tmp is not None:
                        _replace(self.tmp, self.path)
                except Exception as e:  # noqa: BLE001 - raised by wait_pending
                    self.error = e
        if self.error is not None and not quiet:
            raise self.error


_PENDING: Optional[_Pending] = None
_AT_EXIT = False


def wait_pending() -> None:
    """Block until this process's ``orbax_async`` save (at most one) has
    reached storage and taken its name; raises its error if it failed."""
    global _PENDING
    pending, _PENDING = _PENDING, None
    if pending is not None:
        pending.future.exception()  # waits
        pending.finish()


def _wait_at_exit() -> None:
    """The backstop for a run that ends without ``wait_pending``."""
    try:
        wait_pending()
    except Exception as e:  # noqa: BLE001 - the interpreter is ending
        print(f"warning: an asynchronous checkpoint failed at exit: {e}", file=sys.stderr)


def save_checkpoint(path: str, state: Dict[str, Any], backend: str = "msgpack") -> str:
    """Write ``state`` at ``path`` (directories made as needed) in ``backend``'s
    format (BACKENDS); returns ``path``.

    ``msgpack``: one ``torch.save`` file, written by the caller alone.
    ``orbax`` / ``orbax_async``: a DCP directory, a collective of every
    process of the group (each hands its own tensors and shards); the
    asynchronous one returns once the state is staged in host memory (after
    waiting for the save before it) and raises where DCP cannot save in the
    background."""
    global _PENDING, _AT_EXIT
    check_backend(backend)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    if backend == "msgpack":
        torch.save(state, tmp)
        _replace(tmp, path)
        return path
    import torch.distributed.checkpoint as dcp

    wait_pending()  # one save in flight at a time
    group = _group()
    renames = is_main_process()
    if renames:
        _remove(tmp)  # a write cut short earlier
    if group is not None:
        dist.barrier(group=group)
    where = dict(checkpoint_id=tmp, process_group=group, no_dist=group is None)
    if backend == "orbax":
        dcp.save(state, **where)
        if renames:
            _replace(tmp, path)
        if group is not None:
            dist.barrier(group=group)  # the name is there for every process
        return path
    future = dcp.async_save(state, **where)
    if not isinstance(future, Future):
        raise RuntimeError(f"dcp.async_save returned {type(future).__name__}, not a future: "
                           "the checkpoint would not be written in the background")
    _PENDING = _Pending(future, tmp if renames else None, path)
    if not _AT_EXIT:
        atexit.register(_wait_at_exit)
        _AT_EXIT = True
    return path


def _template(path: str, keys: Optional[Sequence[str]]) -> Dict[str, Any]:
    """The nested dictionary a checkpoint directory holds (its top-level
    entries ``keys``, default all), from its metadata: an empty CPU tensor of
    each saved tensor's shape and dtype, None for each other value."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    md = dcp.FileSystemReader(path).read_metadata()
    tree: Dict[Any, Any] = {}
    for fqn, item in md.state_dict_metadata.items():
        where = md.planner_data[fqn] if md.planner_data and fqn in md.planner_data else (fqn,)
        if keys is not None and where[0] not in keys:
            continue
        node = tree
        for k in where[:-1]:
            node = node.setdefault(k, {})
        node[where[-1]] = (torch.empty(item.size, dtype=item.properties.dtype)
                          if isinstance(item, TensorStorageMetadata) else None)
    return tree


def _to(tree: Any, device: Union[str, torch.device, None]) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) and device is not None else tree


def restore_checkpoint(path: str, target: Optional[Dict[str, Any]] = None,
                       map_location: Union[str, torch.device, None] = "cpu",
                       keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Read a checkpoint of :func:`save_checkpoint`, a file or a directory
    (after this process's own save in flight, ``wait_pending``).

    Without ``target``: the checkpoint (its top-level entries ``keys``,
    default all; a directory reads no other) as plain tensors on
    ``map_location`` (a file's through ``torch.load`` with
    ``weights_only``).  With ``target``, a directory only (a nested
    dictionary of tensors, ``DTensor`` shards and other values, as the save
    was handed): its tensors take the checkpoint's values in place through
    ``dcp.load`` (each process reads the parts of its own shards, resharded
    where the target lies otherwise), its other entries are replaced, and it
    is returned; the entries it lacks are not read.  Any other directory
    raises a ``ValueError``: a JAX orbax one names its readers
    (``read_flax_checkpoint``, the trainers' ``restore``)."""
    wait_pending()
    if os.path.isdir(path):
        if is_jax_orbax_dir(path):
            raise ValueError(
                f"{path} is a JAX orbax checkpoint directory, not one of the port's: read it "
                "with flax_msgpack.read_flax_checkpoint, or restore a trainer from it with "
                "its restore")
        if not is_checkpoint_dir(path):
            raise ValueError(NOT_A_CHECKPOINT.format(path=path))
        import torch.distributed.checkpoint as dcp

        # every process reads its own parts: no collective
        if target is None:
            tree = _template(path, keys)
            dcp.load(tree, checkpoint_id=path, no_dist=True)
            return _to(tree, map_location)
        dcp.load(target, checkpoint_id=path, no_dist=True)
        return target
    if target is not None:
        raise ValueError(f"{path}: a target restores a checkpoint directory, not a file")
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload if keys is None else {k: payload[k] for k in keys}


def is_torch_file(path: str) -> bool:
    """torch.save's zip format (or its legacy pickle), as opposed to the JAX
    package's msgpack files."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2) in (b"\x80\x02", b"\x80\x04")


def adam_payload(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> Dict[str, Any]:
    """Adam's state by ``model``'s parameter names: ``count`` (the updates
    taken) and ``exp_avg`` / ``exp_avg_sq``, the layout that the JAX
    trainers' optax moments map into (``convert.py``).  Sharded moments are
    gathered (every process of the model group calls it), so a sharded run
    writes the tensors an unsharded one does."""
    adam: Dict[str, Any] = {"count": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            adam["count"] = int(st["step"])
            adam["exp_avg"][name] = full_tensor(st["exp_avg"])
            adam["exp_avg_sq"][name] = full_tensor(st["exp_avg_sq"])
    return adam


def load_adam_payload(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                      adam: Dict[str, Any]) -> None:
    """The inverse of :func:`adam_payload`, in place: each named parameter of
    ``model`` that ``optimizer`` holds takes its moments (its part of them
    where it is sharded) and the step."""
    held = {p for group in optimizer.param_groups for p in group["params"]}
    for name, p in model.named_parameters():
        if p in held and name in adam["exp_avg"]:
            optimizer.state[p] = {"step": torch.tensor(float(adam["count"])),
                                  "exp_avg": shard_like(p, adam["exp_avg"][name]),
                                  "exp_avg_sq": shard_like(p, adam["exp_avg_sq"][name])}


def optimizer_payload(optimizer: torch.optim.Optimizer,
                      params: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """``optimizer.state_dict()`` as an optimizer over ``params`` in one group
    gives it (the state by index into ``params``, the first group's
    hyperparameters), with sharded state gathered (every process of the
    model group calls it): an unsharded optimizer's own ``state_dict``, and
    the same file from a sharded run."""
    state = {}
    for i, p in enumerate(params):
        st = optimizer.state.get(p)
        if st:
            state[i] = {k: full_tensor(v) if isinstance(v, torch.Tensor) else v
                        for k, v in st.items()}
    group = {k: v for k, v in optimizer.param_groups[0].items() if k != "params"}
    group["params"] = list(range(len(params)))
    return {"state": state, "param_groups": [group]}


def load_optimizer_payload(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                           payload: Dict[str, Any]) -> None:
    """The inverse of :func:`optimizer_payload`, in place: every group takes
    the saved hyperparameters and each of ``params`` its state, its part of
    it where it is sharded (a copy of the step)."""
    saved = {k: v for k, v in payload["param_groups"][0].items() if k != "params"}
    for group in optimizer.param_groups:
        group.update(saved)
    for i, p in enumerate(params):
        st = payload["state"].get(i)
        if st is not None:
            optimizer.state[p] = {k: (v.clone() if k == "step" else shard_like(p, v))
                                  if isinstance(v, torch.Tensor) else v for k, v in st.items()}


def optimizer_shards(optimizer: torch.optim.Optimizer,
                     named: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adam's (or AdamW's) state of each of ``named``'s parameters, by name,
    as it lies, for a directory checkpoint: the ``step``, ``exp_avg`` and
    ``exp_avg_sq`` tensors themselves (a sharded parameter's moments are its
    shards; nothing is gathered or copied), so that a restore through them
    loads the optimizer in place.  A parameter without state yet gets Adam's
    initial state first (step 0, zero moments), which its first update
    takes as it would a missing one."""
    out = {}
    for name, p in named.items():
        st = optimizer.state[p]
        if not st:
            st.update(step=torch.tensor(0.0, dtype=torch.float32),
                      exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                      exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        out[name] = {k: st[k] for k in ("step", "exp_avg", "exp_avg_sq")}
    return out


def latest_checkpoint(ckpt_dir: str, pattern: str = "*.ckpt") -> Optional[str]:
    """The newest file or checkpoint directory in ``ckpt_dir`` matching
    ``pattern``, or None (a write in progress is still ``*.tmp``)."""
    files = glob.glob(os.path.join(ckpt_dir, pattern))
    return max(files, key=os.path.getmtime) if files else None


class TopKCheckpointer:
    """Keep the k best checkpoints by a monitored metric.

    Names carry the step and the metric (``step=000012-val_loss=0.12345
    .ckpt``), so ``ls`` shows training health; ``backend`` is
    :func:`save_checkpoint`'s (with a directory backend every process of the
    group calls :meth:`update` with its own tensors, and rank 0 removes what
    falls out, after ``wait_pending``).  A new instance seeds its list from
    the checkpoints already in ``ckpt_dir``, so a resumed run keeps pruning
    against the previous run's best.
    """

    def __init__(self, ckpt_dir: str, monitor: str = "val/loss_simple_ema", k: int = 3,
                 mode: str = "min", backend: str = "msgpack"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.k = k
        self.mode = mode
        self.backend = check_backend(backend)
        self.best: list = []  # [(score, path)], best first
        tag = self._tag
        for path in glob.glob(os.path.join(ckpt_dir, f"step=*-{tag}=*.ckpt")):
            try:
                value = float(path.rsplit(f"{tag}=", 1)[1][:-len(".ckpt")])
            except (IndexError, ValueError):
                continue
            self.best.append((self._score(value), path))
        self.best.sort(key=lambda item: item[0])

    @property
    def _tag(self) -> str:
        return self.monitor.replace("/", "_")

    def _score(self, value: float) -> float:
        return value if self.mode == "min" else -value

    def update(self, value: float, step: int, state: Dict[str, Any]) -> Optional[str]:
        """Save ``state`` if ``value`` ranks in the top k and drop the
        checkpoint that falls out; returns the new path, or None."""
        score = self._score(value)
        if len(self.best) >= self.k and score >= self.best[-1][0]:
            return None
        path = os.path.join(self.ckpt_dir, f"step={step:06d}-{self._tag}={value:.5f}.ckpt")
        save_checkpoint(path, state, self.backend)
        self.best.append((score, path))
        self.best.sort(key=lambda item: item[0])
        while len(self.best) > self.k:
            _, worst = self.best.pop()
            if os.path.isdir(worst):
                wait_pending()  # never remove a write in flight
            if is_main_process():
                try:
                    _remove(worst)
                except OSError:
                    pass
        return path
