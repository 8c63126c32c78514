"""The generation route's CLI on the card: LDM training, slice sampling, the
VAE finetune and the VAE round trip.

    python -m slice3d_tpu_torch.main -b configs/objaverse-ldm-kl-8.yaml -t \\
        [--max_steps N] [--ckpt_every 2000] [--val_every 2000] \\
        [--log_images_every 2000] [--ddim_steps 200] [--log_progressive_rows] \\
        [-r logs/<run> | <ckpt>]              # trains the LDM under <logdir>/
    python -m slice3d_tpu_torch.main -b configs/autoencoder_kl_f8_finetune.yaml -t
                                              # finetunes the kl-f8 VAE
    python -m slice3d_tpu_torch.main -b configs/objaverse-ldm-kl-8-infer.yaml \\
        -r logs/<run> [--sampler ddim|dpm|plms|ancestral] [--ddim_steps 200] \\
        [--ddim_eta 1.0] [--guidance_scale 1.0]
                                              # writes <logdir>/images_testing_sampled/
    python -m slice3d_tpu_torch.main -b <ldm or autoencoder config> -r logs/<run> \\
        --mode rec                            # writes <logdir>/images_reconstructed/
    ... [--device cpu --dtype float32]

The root ``main.py``: the module and the data come from the YAML config (read
without PyYAML, ``utils/yaml_config.py``; ``key=value`` dotlist overrides
after the flags); ``-r`` names a logdir (its newest ``checkpoints/*.ckpt``) or
a checkpoint, the port's ``torch.save`` file or checkpoint directory or the
JAX package's msgpack file or orbax directory (the root ``main.py -t`` writes
those); without
one the weights are drawn from ``-s``.  A new run's logdir is
``<-l>/<time>_<name>``, with the merged config in ``configs/``.

* ``-t`` on an LDM config (root ``main.py:430-539``): ``maybe_set_scale``
  before the first step, then steps until ``--max_steps``; ``last.ckpt``
  every ``--ckpt_every``; every ``--val_every`` the whole validation split
  with and without the EMA, the three best on ``val/loss_simple_ema`` kept;
  every ``--log_images_every`` the montages ``inputs_gs-*``,
  ``reconstruction_gs-*``, ``samples_gs-*`` (DDIM at ``--ddim_steps``) and,
  with ``--log_progressive_rows``, ``progressive_row_gs-*`` and
  ``diffusion_row_gs-*`` under ``images/train/``.  The scalars
  (``train/loss``, ``train/loss_simple``, ``train/loss_vlb``, ``lr_abs``
  every 50 steps; ``val/*``) go to TensorBoard when it imports, else to the
  output.  SIGUSR1 writes ``last.ckpt`` after the step; an exception writes
  it and re-raises.  A JAX ``last.ckpt`` resumes without AdamW's moments.
* ``-t`` on an autoencoder config (root ``run_vae_finetune``,
  ``main.py:226-380``): ``VAEFinetuneTrainer`` with ``lossconfig.params``
  (``disc_start``, ``kl_weight``, ``disc_weight``, ``disc_num_layers``,
  ``lpips_ckpt``: a taming LPIPS torch file), the VAE from ``ckpt_path`` (a
  reference kl-f8 torch checkpoint) when it names a file; stacks of 13
  images flattened to 13B images a step; the three best on ``val/rec_loss``;
  ``inputs_gs-*`` and ``reconstruction_gs-*``; resume; the emergency
  checkpoint.
* Sampling runs under the EMA weights, one batch of the test split at a time
  in order, each batch's draws from a generator seeded ``seed + batch``.
* ``--mode rec`` round-trips the ``trainval_rec`` split's 12 slices through
  the VAE: an LDM config's first stage, or an autoencoder config's VAE (built
  from ``ddconfig``; ``-r`` a VAE finetune run, the port's or the JAX
  package's).  The root CLI builds an LDM trainer there and fails to restore
  a finetune checkpoint (ROADMAP.md Queue 3).

With ``SLICE3D_COORDINATOR`` / ``SLICE3D_NUM_PROCESSES`` /
``SLICE3D_PROCESS_ID`` set, ``-t`` trains data-parallel, one process a card
(``parallel.init_distributed``): every process takes its loader shard and
the trainers average over the group; rank 0 picks the logdir and writes the
config, the checkpoints, the montages and the scalars; validation means are
the whole split's.  Sampling and ``--mode rec`` run on rank 0 alone.

``--ckpt_backend`` keeps the root CLI's values (``train/checkpoint.py``):
``msgpack`` writes one ``torch.save`` file (rank 0 alone; a sharded state is
gathered first), ``orbax`` a ``torch.distributed.checkpoint`` directory
(``.metadata`` and ``__<rank>_<n>.distcp`` files, not orbax's format) that
every process writes together, each its own shards, and ``orbax_async`` the
same directory written in the background (flushed after the last and the
emergency checkpoint).  An emergency checkpoint is written where one
process can write it alone: not of a sharded state, nor a directory in a
group.  At ``--max_steps`` ``last.ckpt`` is written unless that step's
``--ckpt_every`` one already was (the root CLI writes it again).

Runs on CUDA unless ``--device cpu``; ``--dtype`` is the networks' compute
dtype over fp32 master weights (``bfloat16``: the attention kernels, forward
and backward; ``float32`` takes the attention's plain path).
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.ldm_data import LDMSliceDataset
from .data.pipeline import BatchLoader
from .diffusion.latent import LatentDiffusion
from .diffusion.sampler import SAMPLERS
from .models.random_init import random_init_
from .parallel import (all_reduce_mean, all_reduce_sum, barrier, broadcast_object, in_group,
                       init_distributed, is_main_process, is_sharded)
from .train.checkpoint import (BACKENDS, TopKCheckpointer, is_checkpoint_dir, latest_checkpoint,
                               wait_pending)
from .train.flax_orbax import is_jax_orbax_dir
from .train.train_ldm import LDMTrainer
from .train.train_reg import scalar_writer
from .train.train_vae import VAEFinetuneTrainer, vae_weights
from .utils.montage import save_image, slices_to_montage, to_uint8
from .utils.yaml_config import dump_yaml, load_config

__all__ = ["get_parser", "build_module_and_trainer", "build_vae_trainer", "build_dataset",
           "validate_full", "main"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_parser() -> argparse.ArgumentParser:
    """The root ``main.py``'s flags, plus ``--device`` and ``--dtype``."""
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[])
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--gpus", type=str, default="", help="accepted and ignored, as at the root")
    p.add_argument("--scale_lr", type=str, default="True",
                   help="LR = accumulate * batch size * base_lr (False: base_lr)")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--mode", type=str, default="", choices=["", "sample", "rec"])
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--log_images_every", type=int, default=2000)
    p.add_argument("--val_every", type=int, default=2000)
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("--sampler", type=str, default="ddim", choices=list(SAMPLERS),
                   help="dpm = DPM-Solver++(2M) (pair with --ddim_steps 20); plms = "
                        "pseudo linear multistep (eta 0); ancestral = the full-T DDPM chain")
    p.add_argument("--log_progressive_rows", action="store_true",
                   help="also log the full-T progressive-denoise and forward-diffusion rows")
    p.add_argument("--log_every_t", type=int, default=200,
                   help="ddpm-step stride of the progressive and diffusion rows")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale (1.0 = off), one 2B-batched UNet "
                        "call a step")
    p.add_argument("--ckpt_backend", type=str, default="msgpack", choices=list(BACKENDS),
                   help="msgpack (the default): one torch.save file; orbax: a sharded "
                        "torch.distributed.checkpoint directory; orbax_async: the same "
                        "written in the background")
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=list(DTYPES),
                   help="the networks' compute dtype (float32: plain attention)")
    return p


def is_autoencoder_target(cfg) -> bool:
    return "autoencoder" in str((cfg.get("model") or {}).get("target", "")).lower()


def _params(cfg, *path):
    node = cfg
    for key in path:
        node = (node or {}).get(key) or {}
    return node


def _img_size(cfg) -> int:
    """The first split's ``size`` (train, validation, test), else 128."""
    for split in ("train", "validation", "test"):
        sp = _params(cfg, "data", "params", split, "params")
        if "size" in sp:
            return int(sp["size"])
    return 128


def build_module_and_trainer(cfg, device, dtype: torch.dtype, scale_lr: bool = True,
                             ckpt_backend: str = "msgpack"):
    """(module on ``device``, trainer, img_size, batch size) from the config,
    as the root ``build_module_and_trainer``: widths from ``unet_config`` and
    ``first_stage_config``, the image size from the first split that sets
    one, checkpoints in ``ckpt_backend``'s format.  The module is built on
    ``device`` with the default init."""
    mp = _params(cfg, "model", "params")
    unet = _params(mp, "unet_config", "params")
    dd = _params(mp, "first_stage_config", "params", "ddconfig")
    bs = int(_params(cfg, "data", "params").get("batch_size", 8))
    img_size = _img_size(cfg)
    vae_mult = tuple(dd.get("ch_mult", (1, 2, 4, 4)))
    with torch.device(device):
        module = LatentDiffusion(
            timesteps=int(mp.get("timesteps", 1000)),
            linear_start=float(mp.get("linear_start", 0.0015)),
            linear_end=float(mp.get("linear_end", 0.0155)),
            vae_ch=int(dd.get("ch", 128)), vae_mult=vae_mult,
            vae_nres=int(dd.get("num_res_blocks", 2)),
            unet_channels=int(unet.get("model_channels", 192)),
            unet_mult=tuple(unet.get("channel_mult", (1, 2, 2, 4, 4))),
            unet_nres=int(unet.get("num_res_blocks", 2)),
            unet_attention_ds=tuple(unet.get("attention_resolutions", (1, 2, 4, 8))),
            latent_size=img_size // 2 ** (len(vae_mult) - 1),
            fused=dtype == torch.bfloat16, dtype=None if dtype == torch.float32 else dtype)
    trainer = LDMTrainer(
        img_size=img_size, batch_size=bs,
        base_lr=float(_params(cfg, "model").get("base_learning_rate", 5e-5)),
        scale_lr=scale_lr,
        accumulate=int(_params(cfg, "lightning", "trainer").get("accumulate_grad_batches", 1)),
        timesteps=module.timesteps, linear_start=module.linear_start,
        linear_end=module.linear_end, loss_type=str(mp.get("loss_type", "l1")),
        module=module, scheduler_config=mp.get("scheduler_config") or None,
        learn_logvar=bool(mp.get("learn_logvar", False)),
        scale_by_std=bool(mp.get("scale_by_std", True)),
        use_ema=bool(mp.get("use_ema", True)), device=device, ckpt_backend=ckpt_backend)
    return module, trainer, img_size, bs


def build_vae_trainer(cfg, device, dtype: torch.dtype, ckpt_backend: str = "msgpack"):
    """(``VAEFinetuneTrainer``, img_size, batch size) from an autoencoder
    config, as the root ``run_vae_finetune``: widths from ``ddconfig``, the
    losses from ``lossconfig.params`` (``lpips_ckpt`` read when it names a
    file), checkpoints in ``ckpt_backend``'s format."""
    mp = _params(cfg, "model", "params")
    dd = _params(mp, "ddconfig")
    lossp = _params(mp, "lossconfig", "params")
    lpips = None
    if lossp.get("lpips_ckpt") and os.path.exists(lossp["lpips_ckpt"]):
        sd = torch.load(lossp["lpips_ckpt"], map_location="cpu", weights_only=True)
        lpips = sd.get("state_dict", sd)
    img_size = _img_size(cfg)
    trainer = VAEFinetuneTrainer(
        img_size=img_size, lr=float(_params(cfg, "model").get("base_learning_rate", 4.5e-6)),
        kl_weight=float(lossp.get("kl_weight", 1e-6)),
        disc_start=int(lossp.get("disc_start", 50001)),
        disc_weight=float(lossp.get("disc_weight", 0.5)),
        disc_n_layers=int(lossp["disc_num_layers"]) if "disc_num_layers" in lossp else None,
        vae_ch=int(dd.get("ch", 128)), vae_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        vae_nres=int(dd.get("num_res_blocks", 2)), lpips_params=lpips, dtype=dtype,
        device=device, ckpt_backend=ckpt_backend)
    return trainer, img_size, int(_params(cfg, "data", "params").get("batch_size", 2))


def build_dataset(cfg, split: str, img_size: int, data_root: str) -> LDMSliceDataset:
    sp = _params(cfg, "data", "params", split, "params")
    root = data_root or sp.get("root") or "./data/objaverse"
    return LDMSliceDataset(root=root, split=split, size=img_size,
                           n_views=int(sp.get("n_views", 12)))


def validate_full(eval_fn, val_loader, keys):
    """The mean of each metric of ``keys`` over the whole validation split
    (every process's shard in a group), as Lightning's validation loop (root
    ``main.py:108-117``)."""
    sums = torch.zeros(len(keys) + 1, dtype=torch.float64)
    for vb in val_loader:
        out = eval_fn(vb)
        sums += torch.tensor([float(out[k]) for k in keys] + [1.0], dtype=torch.float64)
    if torch.distributed.is_initialized() and torch.distributed.get_backend() == "nccl":
        sums = sums.cuda()
    sums = all_reduce_sum(sums).cpu()
    return {k: float(sums[i] / max(float(sums[-1]), 1.0)) for i, k in enumerate(keys)}


def write_sample_outputs(logdir: str, batch_idx: int, batch, gen: np.ndarray) -> None:
    out_dir = os.path.join(logdir, "images_testing_sampled")
    os.makedirs(out_dir, exist_ok=True)
    for case in range(gen.shape[0]):
        save_image(to_uint8(batch["img_ipt_view"][case]),
                   os.path.join(out_dir, f"{batch_idx}_{case}_ipt.png"))
        save_image(to_uint8(slices_to_montage(gen[case])),
                   os.path.join(out_dir, f"{batch_idx}_{case}.png"))


def write_rec_outputs(logdir: str, batch_idx: int, rec: np.ndarray) -> None:
    out_dir = os.path.join(logdir, "images_reconstructed")
    os.makedirs(out_dir, exist_ok=True)
    for case in range(rec.shape[0]):
        save_image(to_uint8(slices_to_montage(rec[case])),
                   os.path.join(out_dir, f"{batch_idx}_{case}.png"))


def _save_montage(img_dir: str, name: str, step: int, slices) -> None:
    save_image(to_uint8(slices_to_montage(np.asarray(slices))),
               os.path.join(img_dir, f"{name}_gs-{step:06}.png"))


def _resume_target(args):
    """(logdir or None, checkpoint or None) of ``-r``, read once every
    process of a group has got here: a checkpoint file or directory, the
    port's or a JAX orbax one (``<logdir>/checkpoints/<name>``), else a
    logdir."""
    if not args.resume:
        return None, None
    barrier()
    if (os.path.isfile(args.resume) or is_checkpoint_dir(args.resume)
            or is_jax_orbax_dir(args.resume)):
        ckpt = args.resume.rstrip("/")
        return os.path.dirname(os.path.dirname(ckpt)), ckpt
    logdir = args.resume.rstrip("/")
    return logdir, latest_checkpoint(os.path.join(logdir, "checkpoints"))


def _new_logdir(cfg, args, logdir: Optional[str], default_name: str) -> str:
    """The run's logdir (rank 0's choice in a group), its merged config
    written by rank 0."""
    if logdir is None:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = args.name or (os.path.splitext(os.path.basename(args.base[0]))[0]
                             if args.base else default_name)
        logdir = os.path.join(args.logdir, f"{now}_{name}")
    logdir = broadcast_object(logdir)
    os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
    if is_main_process():
        with open(os.path.join(logdir, "configs", "merged.yaml"), "w") as f:
            f.write(dump_yaml(cfg))
    return logdir


def _loaders(cfg, args, img_size: int, bs: int):
    """The training loader, and the validation one unless the split is
    missing (as the root CLI)."""
    loader = BatchLoader(build_dataset(cfg, "train", img_size, args.data_root), bs,
                         shuffle=True, num_workers=4)
    try:
        val_loader = BatchLoader(build_dataset(cfg, "validation", img_size, args.data_root),
                                 bs, shuffle=False, drop_last=False, num_workers=2)
    except (FileNotFoundError, KeyError):
        val_loader = None
    return loader, val_loader


def _every(step: int, n: int) -> bool:
    return n > 0 and step % n == 0


def _seeded(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


class _Saves:
    """The training loops' checkpoint writes in the trainer's ``ckpt_backend``:
    a ``msgpack`` file by rank 0 (the other processes of a sharded state
    gathering with it), a directory by every process together."""

    def __init__(self, trainer, main: bool, sharded: bool):
        self.trainer, self.main, self.sharded = trainer, main, sharded
        self.every = trainer.ckpt_backend != "msgpack"
        self.saved = None  # the step of the last ``last.ckpt``

    def last(self, state, path: str) -> None:
        if self.main or self.every:
            self.trainer.save(state, path)
        elif self.sharded:
            self.trainer.state_payload(state)  # the gather of rank 0's write
        self.saved = state.step

    def final(self, state, path: str) -> None:
        """``last.ckpt`` at ``--max_steps`` unless the step's own one is there,
        then flushed."""
        if state.step != self.saved:
            self.last(state, path)
        wait_pending()

    def top_k(self, state, topk: TopKCheckpointer, value: float, step: int) -> None:
        if self.main or self.every:
            kept = topk.update(value, step, self.trainer.checkpoint_payload(state))
            if kept and self.main:
                print(f"saved top-k checkpoint {kept}")
        elif self.sharded:
            self.trainer.state_payload(state)

    def emergency(self, state, path: str, step: int) -> None:
        """``last.ckpt`` after a failure, where one process can write it alone
        (not a sharded state, nor a directory in a group), then flushed."""
        if not self.main:
            return
        if self.sharded or (self.every and in_group()):
            print(f"no emergency checkpoint at step {step}: every process writes this "
                  f"checkpoint together")
            return
        self.trainer.save(state, path)
        wait_pending()
        print(f"saved emergency checkpoint at step {step}")


def _train_ldm(cfg, args, trainer: LDMTrainer, state, logdir: str, img_size: int, bs: int,
               device) -> str:
    want_ckpt = {"flag": False}
    try:
        signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(flag=True))
    except (ValueError, OSError):  # not the main thread
        pass
    loader, val_loader = _loaders(cfg, args, img_size, bs)
    ckpt_dir = os.path.join(logdir, "checkpoints")
    last = os.path.join(ckpt_dir, "last.ckpt")
    writer = scalar_writer(os.path.join(logdir, "tensorboard"))
    topk = TopKCheckpointer(ckpt_dir, monitor="val/loss_simple_ema", k=3,
                            backend=trainer.ckpt_backend)
    g = _seeded(device, args.seed)
    main = is_main_process()
    # a sharded state (parallel.shard_params_fsdp) runs its forwards on every
    # process together, so every process samples the image logs that rank 0
    # writes; its msgpack checkpoints are gathered by every process while
    # rank 0 writes, and a directory checkpoint is written by every process
    sharded = is_sharded(state.ldm)
    saves = _Saves(trainer, main, sharded)
    t0 = time.time()
    step = state.step
    try:
        while True:
            for batch in loader:
                if state.step == 0:
                    trainer.maybe_set_scale(state, batch, g)
                state, logs = trainer.train_step(state, batch, g)
                step = state.step
                if main and step % 50 == 0:
                    print(f"step {step}: loss {float(logs['loss']):.5f} "
                          f"simple {float(logs['loss_simple']):.5f} ({time.time() - t0:.0f}s)")
                    for k in ("loss", "loss_simple", "loss_vlb"):
                        writer.add_scalar(f"train/{k}", float(logs[k]), step)
                    writer.add_scalar("lr_abs", trainer.current_lr(step), step)
                ckpt_now = step % args.ckpt_every == 0 or want_ckpt["flag"]
                if sharded:  # the signal may reach one process only
                    ckpt_now = float(all_reduce_mean({"c": torch.tensor(float(ckpt_now))})["c"]) > 0
                if ckpt_now:
                    want_ckpt["flag"] = False
                    saves.last(state, last)
                if val_loader is not None and _every(step, args.val_every):
                    v, ve = (validate_full(lambda vb: trainer.eval_loss(
                        state, vb, _seeded(device, 0), use_ema=ema), val_loader,
                        ("loss", "loss_simple", "loss_vlb")) for ema in (False, True))
                    if main:
                        print(f"step {step}: val/loss_simple {v['loss_simple']:.5f} "
                              f"ema {ve['loss_simple']:.5f}")
                        writer.add_scalar("val/loss_simple", v["loss_simple"], step)
                        writer.add_scalar("val/loss_simple_ema", ve["loss_simple"], step)
                    saves.top_k(state, topk, ve["loss_simple"], step)
                if (main or sharded) and _every(step, args.log_images_every):
                    rec = trainer.reconstruct_slices(state, batch["image"],
                                                     generator=_seeded(device, 0))
                    gen = trainer.sample_slices(state, batch["img_ipt_view"],
                                                ddim_steps=args.ddim_steps, eta=args.ddim_eta,
                                                generator=_seeded(device, step))
                    montages = {"inputs": batch["image"][0, :12], "reconstruction": rec[0].cpu(),
                                "samples": gen[0].cpu()}
                    if args.log_progressive_rows:
                        _, prog = trainer.sample_progressive(
                            state, batch["img_ipt_view"], log_every_t=args.log_every_t,
                            generator=_seeded(device, step))
                        diff = trainer.diffusion_row(state, batch["image"],
                                                     log_every_t=args.log_every_t,
                                                     generator=_seeded(device, step))
                        montages["progressive_row"] = torch.cat(list(prog[:, 0]), dim=2).cpu()
                        montages["diffusion_row"] = torch.cat(list(diff[:, 0]), dim=2).cpu()
                    if main:
                        img_dir = os.path.join(logdir, "images", "train")
                        os.makedirs(img_dir, exist_ok=True)
                        for name, montage in montages.items():
                            _save_montage(img_dir, name, step, montage)
                if args.max_steps > 0 and step >= args.max_steps:
                    saves.final(state, last)
                    return logdir
    except (Exception, KeyboardInterrupt):
        saves.emergency(state, last, step)
        raise


def _flatten_stack(batch):
    """(B, 13, H, W, 3) stacks -> (13B, H, W, 3) images: the VAE trains on
    single images (reference autoencoder.py:325-331)."""
    x = np.asarray(batch["image"])
    return {"image": x.reshape((-1,) + x.shape[2:])}


def _finetune_vae(cfg, args, device, dtype: torch.dtype) -> str:
    trainer, img_size, bs = build_vae_trainer(cfg, device, dtype, args.ckpt_backend)
    state = trainer.init_state(args.seed)
    ckpt_path = str(_params(cfg, "model", "params").get("ckpt_path") or "")
    if ckpt_path and os.path.exists(ckpt_path):
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        state.vae.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
        print(f"initialized VAE from {ckpt_path}")
    logdir, ckpt = _resume_target(args)
    if ckpt:
        state = trainer.restore(state, ckpt)
        print(f"restored from {ckpt} (step {state.step})")
    logdir = _new_logdir(cfg, args, logdir, "vae_finetune")
    loader, val_loader = _loaders(cfg, args, img_size, bs)
    ckpt_dir = os.path.join(logdir, "checkpoints")
    last = os.path.join(ckpt_dir, "last.ckpt")
    writer = scalar_writer(os.path.join(logdir, "tensorboard"))
    topk = TopKCheckpointer(ckpt_dir, monitor="val/rec_loss", k=3,
                            backend=trainer.ckpt_backend)
    g = _seeded(device, args.seed)
    main = is_main_process()
    saves = _Saves(trainer, main, False)
    t0 = time.time()
    step = state.step
    try:
        while True:
            for batch in loader:
                state, logs = trainer.train_step(state, _flatten_stack(batch), g)
                step = state.step
                if main and step % 50 == 0:
                    print(f"step {step}: rec {float(logs['rec_loss']):.5f} "
                          f"kl {float(logs['kl']):.3f} disc {float(logs['disc_loss']):.5f} "
                          f"({time.time() - t0:.0f}s)")
                    for k in ("rec_loss", "kl", "g_loss", "d_weight", "ae_loss", "disc_loss"):
                        writer.add_scalar(f"train/{k}", float(logs[k]), step)
                if step % args.ckpt_every == 0:
                    saves.last(state, last)
                if val_loader is not None and _every(step, args.val_every):
                    keys = ("rec_loss", "kl") + (("lpips",) if trainer.lpips is not None
                                                 and trainer.perceptual_weight > 0 else ())
                    v = validate_full(lambda vb: trainer.eval_loss(
                        state, _flatten_stack(vb), _seeded(device, 0)), val_loader, keys)
                    if main:
                        print(f"step {step}: val/rec_loss {v['rec_loss']:.5f}")
                        for k, val in v.items():
                            writer.add_scalar(f"val/{k}", val, step)
                    saves.top_k(state, topk, v["rec_loss"], step)
                if main and _every(step, args.log_images_every):
                    img_dir = os.path.join(logdir, "images", "train")
                    os.makedirs(img_dir, exist_ok=True)
                    rec = trainer.reconstruct(state, batch["image"][0],
                                              generator=_seeded(device, 0))
                    _save_montage(img_dir, "inputs", step, batch["image"][0, :12])
                    _save_montage(img_dir, "reconstruction", step, rec[:12].cpu())
                if args.max_steps > 0 and step >= args.max_steps:
                    saves.final(state, last)
                    return logdir
    except (Exception, KeyboardInterrupt):
        saves.emergency(state, last, step)
        raise


def _reconstruct_with_vae(cfg, args, device, dtype: torch.dtype) -> str:
    """``--mode rec`` on an autoencoder config: the VAE of ``ddconfig`` with a
    finetune run's weights (or weights drawn from ``-s``)."""
    trainer, img_size, bs = build_vae_trainer(cfg, device, dtype)
    state = trainer.init_state(args.seed)
    logdir, ckpt = _resume_target(args)
    if ckpt:
        state.vae.load_state_dict(vae_weights(ckpt))
        print(f"restored the VAE from {ckpt}")
    logdir = _new_logdir(cfg, args, logdir, "run")
    ds = build_dataset(cfg, "test", img_size, args.data_root)
    ds.split = "trainval_rec"
    ds.__post_init__()
    for batch_idx, batch in enumerate(BatchLoader(ds, bs, shuffle=False, drop_last=False,
                                                  num_workers=4, num_shards=1, shard=0)):
        x = np.asarray(batch["image"])[:, :12]
        t0 = time.perf_counter()
        rec = trainer.reconstruct(state, x.reshape((-1,) + x.shape[2:]),
                                  generator=_seeded(device, args.seed + batch_idx))
        rec = rec.reshape(x.shape).cpu().numpy()
        write_rec_outputs(logdir, batch_idx, rec)
        print(f"batch {batch_idx} done ({len(rec)} cases in {time.perf_counter() - t0:.4f} s)")
    return logdir


def main(argv=None) -> Optional[str]:
    """Run the CLI; returns the logdir it wrote to."""
    args, unknown = get_parser().parse_known_args(argv)
    cfg = load_config(args.base, unknown)
    init_distributed(device=args.device)
    if not args.train and not is_main_process():
        return None  # sampling and --mode rec run on rank 0 alone
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if is_autoencoder_target(cfg):
        if args.train:
            return _finetune_vae(cfg, args, device, dtype)
        if args.mode != "rec":
            raise ValueError(f"{cfg['model']['target']}: an autoencoder config samples "
                             "nothing; pass -t or --mode rec")
        return _reconstruct_with_vae(cfg, args, device, dtype)
    _, trainer, img_size, bs = build_module_and_trainer(
        cfg, device, dtype, scale_lr=str(args.scale_lr).lower() != "false",
        ckpt_backend=args.ckpt_backend)

    logdir, ckpt = _resume_target(args)
    if ckpt is None:
        random_init_(trainer.module, _seeded(device, args.seed))
    state = trainer.init_state(args.seed)
    if ckpt:
        state = trainer.restore(state, ckpt)
        print(f"restored from {ckpt} (step {state.step})")
    trainer.module = None  # the state holds the model now
    logdir = _new_logdir(cfg, args, logdir, "run")
    if args.train:
        return _train_ldm(cfg, args, trainer, state, logdir, img_size, bs, device)

    mode = args.mode or "sample"
    ds = build_dataset(cfg, "test", img_size, args.data_root)
    if mode == "rec":
        ds.split = "trainval_rec"
        ds.__post_init__()
    loader = BatchLoader(ds, bs, shuffle=False, drop_last=False, num_workers=4, num_shards=1,
                         shard=0)
    for batch_idx, batch in enumerate(loader):
        g = _seeded(device, args.seed + batch_idx)
        t0 = time.perf_counter()
        if mode == "rec":
            out = trainer.reconstruct_slices(state, batch["image"], generator=g)
        else:
            out = trainer.sample_slices(state, batch["img_ipt_view"], sampler=args.sampler,
                                        ddim_steps=args.ddim_steps, eta=args.ddim_eta,
                                        guidance_scale=args.guidance_scale, generator=g)
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        if mode == "rec":
            write_rec_outputs(logdir, batch_idx, out)
        else:
            write_sample_outputs(logdir, batch_idx, batch, out)
        print(f"batch {batch_idx} done ({len(out)} cases in {dt:.4f} s)")
    return logdir


if __name__ == "__main__":
    main()
