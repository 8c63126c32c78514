"""Training of the regression models, SliceNet and GTSlice (the JAX package's
``slice3d_tpu/train/train_reg.py``; reference reg_slices/train.py and
train_gt.py).

Adam (b1 0.9, b2 0.999, eps 1e-8) on the step schedule ``lr *
decay^(epoch // freq_decay)``; SliceNet's loss is L1(sdf) + L1(slice images)
+ 0.001 VGG19 perceptual term (when VGG19 weights are given), GTSlice's
L1(sdf) alone; with ``pred_type occ`` the first term is the binary
cross-entropy of the occupancy logits.  The logs are ``loss_pred``,
``loss_img``, ``loss_vgg``, ``acc`` (sign agreement, or occupancy agreement
under ``occ``) and ``loss``.  Validation every ``freq_ckpt`` epochs on the
running BatchNorm statistics, then a checkpoint named
``{epoch}_{step}_{loss_pred}_{acc}_{loss_img}.ckpt``.

The model computes in ``train_dtype`` (the module's ``dtype``: parameters
stay fp32 and are cast at use, so gradients and Adam's moments are fp32);
the losses are fp32.  The head runs its plain route: its kernels have no
backward, as the JAX trainer's model never reaches its Pallas kernel.  The
BatchNorms run on batch statistics and move their running statistics; the
VGG trunk's last BatchNorm (``down5_`` / ``conv_last``) feeds no output and
does not run, so its statistics stay where they are (the JAX backbone runs
it and moves them).  Each parameter the loss does not reach gets a zero
gradient, as under optax, so Adam's state covers every parameter.

Checkpoints are written in ``opts.ckpt_backend``'s format
(``train/checkpoint.py``): a ``torch.save`` file, or a
``torch.distributed.checkpoint`` directory that every process of the group
writes together (``train`` flushes an asynchronous one, ``wait_pending``,
before it returns).  ``restore`` reads both, and the JAX trainer's msgpack
files and orbax directories (``convert.train_reg_payload``: weights, statistics, Adam's moments,
step and epoch), so ``--resume`` continues a JAX run.  A checkpoint holds
the model's state_dict under ``"model"``, which
``models/build.py::load_model`` reads for reconstruction.
``<exp_dir>/code`` gets a snapshot of this package when it is absent; a
resumed run keeps the first run's snapshot.

In a process group (``parallel.init_distributed``; one process a card) the
step is data-parallel: each process takes its loader shard, the BatchNorms
normalise with the global batch's statistics, the gradients are averaged
over the group before Adam, and the logs are the group's means, so the
step is the one-process step on the global batch, as the JAX trainer's jit
over a sharded batch.  Only rank 0 writes ``opts.txt``, the code snapshot,
the scalars and the ``msgpack`` checkpoints (every process writes its part
of a directory); every process waits for the others before ``--resume``
reads.

The trainer runs on the process mesh (``parallel.init_process_mesh``; the
default grid puts every process on ``data``).  With a ``model`` axis larger
than 1, ``init_state`` shards the parameters of at least ``fsdp_min_size``
elements over it by the JAX package's rule (``shard_params_fsdp``) and
Adam's moments take their layout; the processes of one model group read
the same batch rows, and when the query axis divides by the model axis
each takes its part of ``qry_norot`` / ``sdf`` / ``occ``, as the JAX dry
run places them with ``P("data", "model")`` (else all of them, as JAX's
``put_batch`` replicates what does not divide); the image terms are the
same along ``model``.  A ``msgpack`` checkpoint gathers the shards, so a
sharded run writes the file an unsharded one does, and loads any:
``state_payload`` gathers on every process, before rank 0 writes; a
directory holds each process's shards as they lie and loads into any
sharding.
"""

from __future__ import annotations

import copy
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import convert, resolve_device
from ..config import Options, dump_options
from ..data.dataset import Slice3DDataset
from ..data.device_transforms import DeviceTransformLoader
from ..data.pipeline import BatchLoader
from ..models.gtslice import init_gtslice
from ..models.perceptual import perceptual_loss
from ..models.slicenet import init_slicenet
from ..models.vgg import VGG19Features, load_vgg19_features
from ..parallel import (all_reduce_gradients, all_reduce_mean, barrier,
                        full_state_dict, is_main_process, load_state_dict_sharded,
                        optimizer_groups, process_mesh, shard_params_fsdp)
from .checkpoint import (adam_payload, check_backend, is_checkpoint_dir, is_torch_file,
                         latest_checkpoint, load_adam_payload, optimizer_shards,
                         restore_checkpoint, save_checkpoint, wait_pending)
from .flax_msgpack import read_flax_checkpoint

__all__ = ["RegTrainState", "RegressionTrainer", "make_lr_schedule", "sign_accuracy",
           "scalar_writer", "train"]

VGG_WEIGHT = 0.001


@dataclass
class RegTrainState:
    """The model (weights and BatchNorm statistics), Adam, and the number of
    updates taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


def make_lr_schedule(base_lr: float, steps_per_epoch: int, freq_decay: int,
                     decay: float) -> Callable[[int], float]:
    """The LR of update ``step`` (0-based): ``base_lr * decay^(epoch //
    freq_decay)`` (reference train.py:179-181)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * decay ** (epoch // freq_decay)

    return schedule


def sign_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred >= 0) == (target >= 0)).to(torch.float32).mean()


def reset_batchnorm_statistics(model: torch.nn.Module) -> torch.nn.Module:
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
    return model


class RegressionTrainer:
    """Train ``opts.name_model`` (slicenet or gtslice) with ``opts``' LR,
    schedule, loss type and ``train_dtype``; ``vgg19`` (a ``VGG19Features``)
    turns SliceNet's perceptual term on (the trainer keeps a frozen copy).
    The current process mesh's model axis (``parallel.process_mesh()``)
    shards the parameters of at least ``fsdp_min_size`` elements; ``save``
    writes in ``opts.ckpt_backend``'s format.  Runs on CUDA unless ``device``
    says otherwise."""

    def __init__(self, opts: Options, *, vgg19: Optional[VGG19Features] = None,
                 steps_per_epoch: int = 1000,
                 device: Optional[Union[str, torch.device]] = None,
                 fsdp_min_size: int = 2 ** 16):
        self.device = resolve_device(device)
        self.fsdp_min_size = fsdp_min_size
        self.opts = opts
        self.ckpt_backend = check_backend(opts.ckpt_backend)
        self.is_slicenet = opts.name_model == "slicenet"
        self.dtype = {"float32": None, "bfloat16": torch.bfloat16}[opts.train_dtype]
        self.vgg19 = (None if vgg19 is None else
                      copy.deepcopy(vgg19).to(self.device).requires_grad_(False).eval())
        self.schedule = make_lr_schedule(opts.lr, steps_per_epoch, opts.freq_decay,
                                         opts.lr_decay_factor)

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> RegTrainState:
        """A model drawn from ``seed`` (the port's init, BatchNorm statistics at
        0 / 1) on the trainer's device, on the plain route, its parameters
        sharded over the mesh's model axis (``shard_params_fsdp``), with Adam
        over every parameter (the shards in a group of their own)."""
        init = init_slicenet if self.is_slicenet else init_gtslice
        model = init(seed, n_slices=self.opts.n_slices, route="plain", dtype=self.dtype)
        model = reset_batchnorm_statistics(model).to(self.device)
        shard_params_fsdp(model, process_mesh(), self.fsdp_min_size)
        optimizer = torch.optim.Adam(optimizer_groups(model.parameters()), lr=self.opts.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return RegTrainState(model=model, optimizer=optimizer)

    # -- steps --------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, torch.float32)

    def _model_part(self, batch: Mapping[str, Any]) -> Mapping[str, Any]:
        """This process's part of the query axis over the mesh's model axis
        (the batch itself where the axis is 1 or does not divide it)."""
        mesh = process_mesh()
        n, q = mesh.model_size, batch["qry_norot"].shape[1]
        if n <= 1 or q % n:
            return batch
        lo, hi = mesh.model_index * q // n, (mesh.model_index + 1) * q // n
        return dict(batch, **{k: batch[k][:, lo:hi] for k in ("qry_norot", "sdf", "occ")
                              if k in batch})

    def _forward(self, model, batch: Mapping[str, Any]):
        """(sdf (B, M), slices_rec (B*S, H, W, 3) or None)."""
        args = [self._tensor(batch[k]) for k in ("qry_norot", "trans_mat_wo_rot_tp",
                                                 "obj_rot_mat")]
        if self.is_slicenet:
            return model(self._tensor(batch["img_input"]), *args)
        return model(self._tensor(batch["img_slices"]), *args), None

    def losses(self, sdf_pred: torch.Tensor, slices_rec: Optional[torch.Tensor],
               batch: Mapping[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The fp32 loss and the logs of one batch's outputs."""
        sdf_pred = sdf_pred.to(torch.float32)
        occ = self.opts.pred_type == "occ"
        if occ:
            target = self._tensor(batch["occ"])
            loss_pred = F.binary_cross_entropy_with_logits(sdf_pred, target)
        else:
            target = self._tensor(batch["sdf"])
            loss_pred = torch.mean(torch.abs(sdf_pred - target))
        logs = {"loss_pred": loss_pred}
        loss = loss_pred
        if slices_rec is not None:
            slices_rec = slices_rec.to(torch.float32)
            gt = self._tensor(batch["img_slices"])
            gt = gt.reshape((-1,) + gt.shape[2:])
            loss_img = torch.mean(torch.abs(slices_rec - gt))
            loss = loss + loss_img
            logs["loss_img"] = loss_img
            if self.vgg19 is not None:
                loss_vgg = VGG_WEIGHT * perceptual_loss(self.vgg19, slices_rec, gt,
                                                        dtype=self.dtype)
                loss = loss + loss_vgg
                logs["loss_vgg"] = loss_vgg
        if occ:
            logs["acc"] = ((torch.sigmoid(sdf_pred) > 0.5) == (target > 0.5)).to(
                torch.float32).mean()
        else:
            logs["acc"] = sign_accuracy(sdf_pred, target)
        return loss, logs

    def train_step(self, state: RegTrainState, batch: Mapping[str, Any]
                   ) -> Tuple[RegTrainState, Dict[str, torch.Tensor]]:
        """One update (in place): forward with batch-statistics BatchNorm on
        this process's batch (its part of the queries over the model axis),
        backward, the gradients averaged over the process group, Adam at the
        schedule's LR of this update.  Each parameter's ``.grad`` keeps the
        applied gradient until the next step.  Returns (state, logs as 0-d
        tensors, the group's means)."""
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        batch = self._model_part(batch)
        loss, logs = self.losses(*self._forward(model, batch), batch)
        loss.backward()
        lr = self.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:  # optax sees a zero gradient there
                    p.grad = torch.zeros_like(p)
        all_reduce_gradients(state.model.parameters())
        state.optimizer.step()
        state.step += 1
        logs["loss"] = loss
        return state, all_reduce_mean({k: v.detach() for k, v in logs.items()})

    @torch.no_grad()
    def eval_epoch(self, state: RegTrainState, loader) -> Dict[str, float]:
        """The mean of each log over ``loader``'s batches, on the running
        BatchNorm statistics (over every process's shard in a group)."""
        model = state.model.eval()
        sums: Dict[str, float] = {}
        n = 0
        for batch in loader:
            _, logs = self.losses(*self._forward(model, batch), batch)
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means = {k: torch.tensor(v / max(n, 1)) for k, v in sums.items()}
        return {k: float(v) for k, v in all_reduce_mean(means).items()}

    # -- checkpoints ------------------------------------------------------------------

    def state_payload(self, state: RegTrainState, epoch: int) -> Dict[str, Any]:
        """A ``msgpack`` file's tensors, shards gathered: every process of a
        model group calls it."""
        return {"model": full_state_dict(state.model),
                "adam": adam_payload(state.optimizer, state.model), "n_epoch": epoch,
                "n_iter": state.step}

    def shard_payload(self, state: RegTrainState, epoch: int) -> Dict[str, Any]:
        """A directory's tensors as they lie (a sharded parameter's shards, Adam's
        state by parameter name: ``optimizer_shards``), so a restore through
        it loads in place; nothing gathered."""
        return {"model": state.model.state_dict(),
                "adam": optimizer_shards(state.optimizer, dict(state.model.named_parameters())),
                "n_epoch": epoch, "n_iter": state.step}

    def checkpoint_payload(self, state: RegTrainState, epoch: int) -> Dict[str, Any]:
        """What ``save`` writes in the trainer's ``ckpt_backend``."""
        if self.ckpt_backend == "msgpack":
            return self.state_payload(state, epoch)
        return self.shard_payload(state, epoch)

    def load_payload(self, state: RegTrainState, payload: Mapping[str, Any]) -> RegTrainState:
        """In place: weights and statistics, Adam's moments (by parameter
        name) and step, and the trainer's step; a sharded state takes its
        part of an unsharded payload."""
        load_state_dict_sharded(state.model, payload["model"])
        load_adam_payload(state.optimizer, state.model, payload["adam"])
        state.step = int(payload["n_iter"])
        return state

    def save(self, state: RegTrainState, dir_ckpt: str, epoch: int,
             metrics: Mapping[str, float], payload: Optional[Mapping[str, Any]] = None) -> str:
        """Write ``payload`` (default: ``checkpoint_payload``'s; every process
        of a sharded state must gather a ``msgpack`` one, so ``train`` passes
        the one it gathered) under the reference's name, in ``ckpt_backend``'s
        format (a directory: every process of the group calls it)."""
        name = (f"{epoch}_{state.step}_{float(metrics.get('loss_pred', 0)):.4}_"
                f"{float(metrics.get('acc', 0)):.4}_{float(metrics.get('loss_img', 0)):.4}.ckpt")
        if payload is None:
            payload = self.checkpoint_payload(state, epoch)
        return save_checkpoint(os.path.join(dir_ckpt, name), payload, self.ckpt_backend)

    def restore(self, state: RegTrainState, path: str) -> Tuple[RegTrainState, int]:
        """In place, from the port's checkpoint (a file, or a directory read
        into ``shard_payload``'s tensors) or the JAX trainer's, a msgpack
        file or an orbax directory; returns (state, the epoch to continue
        from)."""
        if is_checkpoint_dir(path):
            payload = restore_checkpoint(path, target=self.shard_payload(state, 0))
            state.step = int(payload["n_iter"])
            return state, int(payload["n_epoch"]) + 1
        if not os.path.isdir(path) and is_torch_file(path):
            payload = restore_checkpoint(path, map_location=self.device)
        else:
            payload = convert.train_reg_payload(read_flax_checkpoint(path), self.opts.name_model)
        return self.load_payload(state, payload), int(payload["n_epoch"]) + 1


# -- the training run -------------------------------------------------------------------


def _backup_code(exp_dir: str) -> None:
    """Snapshot this package into ``<exp_dir>/code/`` (reference
    reg_slices/train.py:95-103), unless a snapshot is there: a resumed run
    keeps the first run's (the JAX package overwrites it on every start)."""
    dst = os.path.join(exp_dir, "code")
    if os.path.exists(dst):
        return
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(pkg_root, os.path.join(dst, os.path.basename(pkg_root)),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o", "_build"))


class _PrintWriter:
    """Prints the scalars where no TensorBoard writer imports."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        print(f"[scalar] {tag} {float(value):.6g} at step {step}")

    def close(self) -> None:
        pass


class _NullWriter(_PrintWriter):
    """The writer of a process other than rank 0: drops the scalars."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass


def scalar_writer(log_dir: str):
    """TensorBoard's ``SummaryWriter`` when it imports, else a printer; on a
    process other than rank 0, nothing."""
    if not is_main_process():
        return _NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _PrintWriter()
    return SummaryWriter(log_dir)


def _load_vgg19(path: str) -> VGG19Features:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_vgg19_features(sd.get("state_dict", sd))


def train(opts: Options, *,
          device: Optional[Union[str, torch.device]] = None) -> RegTrainState:
    """The training run of root ``train.py`` / ``train_gt.py`` (reference
    train.py:105-183): datasets, loaders, ``--resume`` from the newest
    checkpoint, epochs of steps with a log line every ``freq_log`` steps,
    validation and a checkpoint every ``freq_ckpt`` epochs.  In a process
    group every process runs it on its shard and rank 0 writes.  Returns
    the final state."""
    dev = resolve_device(device)
    main = is_main_process()
    dir_ckpt = os.path.join(opts.exp_dir, "ckpt")
    os.makedirs(dir_ckpt, exist_ok=True)
    if main:
        dump_options(opts, os.path.join(opts.exp_dir, "opts.txt"))
        _backup_code(opts.exp_dir)
    writer = scalar_writer(os.path.join(opts.exp_dir, "log"))

    # device_preprocess covers GT slice PNGs only (generated and
    # reconstructed slices are stored composited)
    dev_pre = opts.device_preprocess and (
        opts.name_model != "gtslice" or opts.from_which_slices == "gt")
    common = dict(img_size=opts.img_size, n_qry=opts.n_qry, n_views=opts.n_views,
                  use_white_bg=opts.use_white_bg, load_slices=True,
                  from_which_slices=(opts.from_which_slices if opts.name_model == "gtslice"
                                     else "gt"),
                  categories=opts.categories, device_preprocess=dev_pre)
    train_loader = BatchLoader(Slice3DDataset(opts.dataset_root, split="train", **common),
                               opts.n_bs, shuffle=True, num_workers=opts.n_wk)
    val_loader = BatchLoader(Slice3DDataset(opts.dataset_root, split="val", **common),
                             opts.n_bs, shuffle=False, num_workers=opts.n_wk)
    if dev_pre:
        train_loader = DeviceTransformLoader(train_loader, opts.img_size, opts.use_white_bg, dev)
        val_loader = DeviceTransformLoader(val_loader, opts.img_size, opts.use_white_bg, dev)

    vgg19 = None
    if opts.vgg19_ckpt and opts.name_model == "slicenet":
        vgg19 = _load_vgg19(opts.vgg19_ckpt)
        print(f"loaded VGG19 perceptual weights from {opts.vgg19_ckpt}")

    trainer = RegressionTrainer(opts, vgg19=vgg19, steps_per_epoch=max(len(train_loader), 1),
                                device=dev)
    state = trainer.init_state()
    epoch0 = 0
    if opts.resume:
        barrier()  # rank 0's writes of an earlier run are done
        ckpt = latest_checkpoint(dir_ckpt)
        if ckpt:
            state, epoch0 = trainer.restore(state, ckpt)
            if main:
                print(f"resumed from {ckpt} at epoch {epoch0}")

    t0 = time.time()
    try:
        for epoch in range(epoch0, opts.n_epochs):
            for batch in train_loader:
                state, logs = trainer.train_step(state, batch)
                step = state.step
                if main and step % opts.freq_log == 0:
                    line = ", ".join(f"{k}: {float(v):.5f}" for k, v in logs.items())
                    print(f"[train] epoch {epoch} iter {step} lr {trainer.schedule(step - 1):.6g} "
                          f"{line} ({time.time() - t0:.0f}s)")
                    writer.add_scalar("Loss/train", float(logs["loss_pred"]), step)
                    writer.add_scalar("Acc/train", float(logs["acc"]), step)
            if epoch % opts.freq_ckpt == 0:
                metrics = trainer.eval_epoch(state, val_loader)
                # every process gathers a msgpack payload, or writes its shards
                payload = trainer.checkpoint_payload(state, epoch)
                if main:
                    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 1e9:.4f} GB"
                            if dev.type == "cuda" else "")
                    print(f"[val] epoch {epoch} {metrics}{peak}")
                    writer.add_scalar("Loss/val", metrics.get("loss_pred", 0), state.step)
                    writer.add_scalar("Acc/val", metrics.get("acc", 0), state.step)
                if main or trainer.ckpt_backend != "msgpack":
                    path = trainer.save(state, dir_ckpt, epoch, metrics, payload)
                    if main:
                        print(f"saved {path}")
        wait_pending()  # an asynchronous checkpoint reaches storage before the return
    finally:
        writer.close()
    return state
