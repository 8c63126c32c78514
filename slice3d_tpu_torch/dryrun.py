"""The multi-process dry run: the JAX package's ``__graft_entry__.py::
dryrun_multichip(n)`` on ``torch.distributed``.

    SLICE3D_COORDINATOR=127.0.0.1:<port> SLICE3D_NUM_PROCESSES=<n> \\
        SLICE3D_PROCESS_ID=<p> python -m slice3d_tpu_torch.dryrun [--device cpu]

Run once per process (p = 0 .. n-1); with no coordinator one process runs
every leg in a process group of its own, so the collectives still run.  The
n processes form the process mesh (2, n/2) when n >= 4, else (n, 1), as the
JAX dry run's device mesh, and take five legs, every one of them, each
printing JAX's ``dryrun_multichip ... ok:`` line on rank 0:

1. one SliceNet training step (fp32, img 32, ``n_qry`` 32, one object a
   data index), the parameters of at least 2^12 elements and Adam's moments
   sharded over ``model`` (``parallel.shard_params_fsdp``), the queries
   split over ``model`` (JAX's ``P("data", "model")``);
2. one step of the tiny LDM (JAX's widths: VAE 32 x (1, 2), UNet 32 x (1,
   2) with attention at ds 2, conditioner (32, 64), 16 px), sharded alike;
3. GTSlice (2 slices, 16 px) reconstruction of n objects with the batch
   split over a mesh of n replicas of the process's device (the port's
   reconstruction mesh, ``parallel.create_mesh``), res0 8 / up 1 / chunk 256;
4. the same GTSlice reconstructing one object with each head call's points
   split over that mesh;
5. 3 DDIM steps (eta 1) of the LDM of leg 2 under its EMA: process p
   samples view p of n, and rank 0 gathers the (n, 12, 16, 16, 3) slices.

The inputs are JAX's: one ``numpy.random.default_rng(0)`` drawn in the JAX
dry run's order.  The weights are the port's seeded draws (GTSlice's from a
state_dict when one is given, as the tests give JAX's).  Every process
checks that the reconstruction legs gave it rank 0's counts.  A failed leg
raises, and the command exits non-zero.  Runs on CUDA unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import socket
import sys
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import camera, resolve_device
from .config import Options
from .diffusion.latent import LatentDiffusion
from .models.gtslice import init_gtslice
from .models.random_init import random_init_
from .parallel import (broadcast_object, create_mesh, data_index, in_group, init_distributed,
                       init_process_mesh, is_main_process, rank, world_size)
from .pipeline import Reconstructor
from .train.train_ldm import LDMTrainer
from .train.train_reg import RegressionTrainer

__all__ = ["dryrun_multichip", "main"]

MIN_SIZE = 2 ** 12  # the dry run's sharding floor (__graft_entry__.py:105-106, 181-182)
LDM_TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
                unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(2,),
                unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=8)


def _say(*parts) -> None:
    if is_main_process():
        print(*parts, flush=True)


def _floats(logs: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in logs.items()}


def _same_everywhere(value, what: str):
    """``value``, checked equal to rank 0's on every process."""
    if broadcast_object(value) != value:
        raise RuntimeError(f"dryrun: {what} on rank {rank()} is {value}, not rank 0's")
    return value


def dryrun_multichip(device=None, gtslice_state: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, object]:
    """The five legs in this process, one of ``world_size()`` (joined by the
    caller, or none).  Returns what each leg printed."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = world_size()
    shape = (2, n // 2) if n >= 4 else (n, 1)
    init_process_mesh(shape)
    data_n = shape[0]
    rng = np.random.default_rng(0)
    out: Dict[str, object] = {"mesh": shape}

    # -- leg 1: the sharded SliceNet step, queries over (data, model) ------------------
    opts = Options(name_model="slicenet", img_size=32, n_qry=32, n_bs=1)
    trainer = RegressionTrainer(opts, steps_per_epoch=10, device=dev, fsdp_min_size=MIN_SIZE)
    state = trainer.init_state()
    eye3 = np.broadcast_to(np.eye(3, dtype=np.float32), (data_n, 3, 3)).copy()
    eye43 = np.broadcast_to(np.eye(4, 3, dtype=np.float32), (data_n, 4, 3)).copy()
    batch = {"img_input": rng.normal(size=(data_n, 32, 32, 3)).astype(np.float32),
             "img_slices": rng.normal(size=(data_n, 12, 32, 32, 3)).astype(np.float32),
             "qry_norot": rng.uniform(-0.5, 0.5, (data_n, 32, 3)).astype(np.float32),
             "sdf": rng.normal(size=(data_n, 32)).astype(np.float32),
             "occ": (rng.random((data_n, 32)) > 0.5).astype(np.float32),
             "obj_rot_mat": eye3, "trans_mat_wo_rot_tp": eye43}
    mine = slice(data_index(), data_index() + 1)
    t0 = time.perf_counter()
    _, logs = trainer.train_step(state, {k: v[mine] for k, v in batch.items()})
    out["ok"] = _floats(logs)
    _say("dryrun_multichip ok:", out["ok"], f"[{time.perf_counter() - t0:.1f}s]")
    del trainer, state

    # -- leg 2: the sharded LDM step -------------------------------------------------------
    module = random_init_(LatentDiffusion(**LDM_TINY), torch.Generator().manual_seed(0))
    ldm = LDMTrainer(img_size=16, batch_size=1, timesteps=20, module=module.eval(),
                     scale_by_std=False, device=dev, fsdp_min_size=MIN_SIZE)
    lstate = ldm.init_state()
    lbatch = {"image": rng.normal(size=(data_n, 13, 16, 16, 3)).astype(np.float32),
              "img_ipt_view": rng.normal(size=(data_n, 16, 16, 3)).astype(np.float32)}
    t0 = time.perf_counter()
    _, llogs = ldm.train_step(lstate, {k: v[mine] for k, v in lbatch.items()},
                              torch.Generator(device=dev).manual_seed(0))
    out["ldm ok"] = _floats(llogs)
    _say("dryrun_multichip ldm ok:", out["ldm ok"], f"[{time.perf_counter() - t0:.1f}s]")

    # -- leg 3: reconstruction, the object batch over a mesh of n replicas ----------------
    rng.normal(size=(1, 2, 16, 16, 3))  # the JAX dry run's GTSlice init input
    gmodel = init_gtslice(0, n_slices=2, route="plain")
    if gtslice_state is not None:
        gmodel.load_state_dict(gtslice_state)
    imesh = create_mesh((n, 1), devices=[dev] * n)
    _, proj = camera.camera_matrices(0.2, 0.1, 1.2)
    feeds = [{"img_slices": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
              "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(n)]
    recon = Reconstructor(gmodel, resolution0=8, upsampling_steps=1, chunk_size=256,
                          batch_size=n, device=dev, mesh=imesh)
    t0 = time.perf_counter()
    meshes = recon.reconstruct_batch(feeds)
    out["recon ok"] = _same_everywhere(
        [(len(m.vertices), int(st["n_points_evaluated"])) for m, st in meshes[:2]],
        "the batch reconstruction")
    _say("dryrun_multichip recon ok:", out["recon ok"], f"[{time.perf_counter() - t0:.1f}s]")

    # -- leg 4: reconstruction of one object, each head call's points over the mesh -------
    recon_pts = Reconstructor(gmodel, resolution0=8, upsampling_steps=1, chunk_size=256,
                              batch_size=1, device=dev, mesh=imesh, shard_axis="points")
    t0 = time.perf_counter()
    m1, st1 = recon_pts.reconstruct(feeds[0])
    out["recon-points ok"] = _same_everywhere((len(m1.vertices), int(st1["n_points_evaluated"])),
                                              "the points reconstruction")
    _say("dryrun_multichip recon-points ok:", out["recon-points ok"],
         f"[{time.perf_counter() - t0:.1f}s]")

    # -- leg 5: DDIM under the sharded EMA, one view a process ------------------------------
    rng.normal(size=(n, 13, 16, 16, 3))  # the JAX dry run's sampling batch: images, then views
    views = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    t0 = time.perf_counter()
    mine_s = ldm.sample_slices(lstate, views[rank():rank() + 1], ddim_steps=3, eta=1.0,
                               generator=torch.Generator(device=dev).manual_seed(2 + rank()),
                               use_ema=True)
    if not torch.isfinite(mine_s).all():
        raise RuntimeError("dryrun: the sampled slices are not finite")
    if in_group():
        parts = [torch.empty_like(mine_s) for _ in range(n)]
        dist.all_gather(parts, mine_s.contiguous())
        slices = torch.cat(parts)
    else:
        slices = mine_s
    out["ddim ok"] = tuple(slices.shape)
    _say("dryrun_multichip ddim ok:", out["ddim ok"], f"[{time.perf_counter() - t0:.1f}s]")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None, gtslice_state: Optional[Mapping[str, torch.Tensor]] = None) -> int:
    """The command: join the group, run ``dryrun_multichip`` (``gtslice_state``
    as there), leave the group."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if init_distributed(device=dev) == 1 and not in_group():
        # one process: a group of its own, so that every collective still runs
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        dryrun_multichip(dev, gtslice_state)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
