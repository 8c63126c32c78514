"""The generation route's CLI on the card: slice sampling and the VAE round trip.

    python -m slice3d_tpu_torch.main -b configs/objaverse-ldm-kl-8-infer.yaml \\
        -r logs/<run> [--sampler ddim|dpm|plms|ancestral] [--ddim_steps 200] \\
        [--ddim_eta 1.0] [--guidance_scale 1.0] [--device cpu --dtype float32]
                                     # writes <logdir>/images_testing_sampled/
    python -m slice3d_tpu_torch.main -b <ldm config> -r logs/<run> --mode rec
                                     # writes <logdir>/images_reconstructed/

The inference half of the root ``main.py`` (``main.py:143-224, 545-565``):
the module and the data come from the YAML config (read without PyYAML,
``utils/yaml_config.py``; ``key=value`` dotlist overrides after the flags),
``-r`` names a logdir (its newest ``checkpoints/*.ckpt``) or a checkpoint
file, which may be the port trainer's ``torch.save`` file or the JAX
trainer's msgpack one; without one the weights are drawn from ``-s``.
Sampling runs under the EMA weights, one batch of the test split at a time in
order, each batch's draws from a generator seeded ``seed + batch``; montages
are written as ``{batch}_{case}.png`` beside the input views
``{batch}_{case}_ipt.png``.  ``--mode rec`` round-trips the ``trainval_rec``
split's 12 slices through the VAE.  Without a logdir a new one is made under
``-l`` (``<time>_<name>``), with the merged config in ``configs/``.

Runs on CUDA unless ``--device cpu``; ``--dtype`` is the networks' compute
dtype (``bfloat16``, the attention kernel's; ``float32`` takes the attention's
plain path).  Training (``-t``) and autoencoder configs (the VAE finetune's
checkpoints) are not ported yet: ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

import argparse
import datetime
import os
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
from .train.checkpoint import latest_checkpoint
from .train.train_ldm import LDMTrainer
from .utils.montage import save_image, slices_to_montage, to_uint8
from .utils.yaml_config import dump_yaml, load_config

__all__ = ["get_parser", "build_module_and_trainer", "build_dataset", "main"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_TRAINING = "training is not ported yet (ROADMAP.md Queue 1 item 10)"


def get_parser() -> argparse.ArgumentParser:
    """The root ``main.py``'s inference flags (``-t`` only to refuse it),
    plus ``--device`` and ``--dtype``."""
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[])
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--mode", type=str, default="", choices=["", "sample", "rec"])
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("--sampler", type=str, default="ddim", choices=list(SAMPLERS),
                   help="dpm = DPM-Solver++(2M) (pair with --ddim_steps 20); plms = "
                        "pseudo linear multistep (eta 0); ancestral = the full-T DDPM chain")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale (1.0 = off), one 2B-batched UNet "
                        "call a step")
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


def build_module_and_trainer(cfg, device, dtype: torch.dtype):
    """(module on ``device``, trainer, img_size, batch size) from the config,
    as the root ``build_module_and_trainer``: widths from ``unet_config`` and
    ``first_stage_config``, the image size from the first split that sets
    one.  The module is built on ``device`` with the default init."""
    mp = _params(cfg, "model", "params")
    unet = _params(mp, "unet_config", "params")
    dd = _params(mp, "first_stage_config", "params", "ddconfig")
    data_p = _params(cfg, "data", "params")
    bs = int(data_p.get("batch_size", 8))
    img_size = 128
    for split in ("train", "validation", "test"):
        sp = _params(data_p, split, "params")
        if "size" in sp:
            img_size = int(sp["size"])
            break
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
        accumulate=int(_params(cfg, "lightning", "trainer").get("accumulate_grad_batches", 1)),
        timesteps=module.timesteps, linear_start=module.linear_start,
        linear_end=module.linear_end, loss_type=str(mp.get("loss_type", "l1")),
        module=module, scheduler_config=mp.get("scheduler_config") or None,
        learn_logvar=bool(mp.get("learn_logvar", False)),
        scale_by_std=bool(mp.get("scale_by_std", True)),
        use_ema=bool(mp.get("use_ema", True)), device=device)
    return module, trainer, img_size, bs


def build_dataset(cfg, split: str, img_size: int, data_root: str) -> LDMSliceDataset:
    sp = _params(cfg, "data", "params", split, "params")
    root = data_root or sp.get("root") or "./data/objaverse"
    return LDMSliceDataset(root=root, split=split, size=img_size,
                           n_views=int(sp.get("n_views", 12)))


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


def main(argv=None) -> Optional[str]:
    """Run the CLI; returns the logdir it wrote to."""
    args, unknown = get_parser().parse_known_args(argv)
    cfg = load_config(args.base, unknown)
    if args.train:
        raise NotImplementedError(f"-t: {_TRAINING}")
    if is_autoencoder_target(cfg):
        raise NotImplementedError(f"{cfg['model']['target']}: the autoencoder's own "
                                  f"checkpoints come from its finetune, whose {_TRAINING}")
    device = resolve_device(args.device)
    _, trainer, img_size, bs = build_module_and_trainer(cfg, device, DTYPES[args.dtype])

    # -r: a logdir (its newest checkpoint) or a checkpoint file
    logdir, ckpt = None, None
    if args.resume:
        if os.path.isfile(args.resume):
            ckpt = args.resume
            logdir = os.path.dirname(os.path.dirname(args.resume))
        else:
            logdir = args.resume.rstrip("/")
            ckpt = latest_checkpoint(os.path.join(logdir, "checkpoints"))
    if ckpt is None:
        random_init_(trainer.module, torch.Generator(device).manual_seed(args.seed))
    state = trainer.init_state(args.seed)
    if ckpt:
        state = trainer.restore(state, ckpt)
        print(f"restored from {ckpt} (step {state.step})")
    trainer.module = None  # the state holds the model now

    if logdir is None:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = args.name or (os.path.splitext(os.path.basename(args.base[0]))[0]
                             if args.base else "run")
        logdir = os.path.join(args.logdir, f"{now}_{name}")
    os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
    with open(os.path.join(logdir, "configs", "merged.yaml"), "w") as f:
        f.write(dump_yaml(cfg))

    mode = args.mode or "sample"
    ds = build_dataset(cfg, "test", img_size, args.data_root)
    if mode == "rec":
        ds.split = "trainval_rec"
        ds.__post_init__()
    loader = BatchLoader(ds, bs, shuffle=False, drop_last=False, num_workers=4)
    for batch_idx, batch in enumerate(loader):
        g = torch.Generator(device).manual_seed(args.seed + batch_idx)
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
