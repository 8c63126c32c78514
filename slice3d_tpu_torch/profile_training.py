"""Where a training step spends its time on the card.

    python -m slice3d_tpu_torch.profile_training [--steps N] [--trainer ldm|slicenet]

Runs the training path of chip_smoke.py (``LDMTrainer`` on LatentDiffusion at
the 128 px operating point with seeded random weights, bf16 networks on fp32
master weights, batches of 8 seeded synthetic images made on the card):
sets the scale factor, warms up, then traces ``--steps`` training steps with
``torch.profiler`` and prints the host wall time per step, the card's busy
time and idle share, device time by category (convolution forward and
backward, the spatial_attention kernels, GEMM, normalisation, the
multi-tensor optimizer and EMA updates, elementwise) and the top kernels by
name.  ``--trainer slicenet`` runs the regression path of chip_smoke.py's
phase 13 instead: ``RegressionTrainer`` on SliceNet with the VGG19 term
(seeded weights), fp32, n_bs 16 of 128 px, 256 queries.  Needs a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .profile_sampling import report

BATCH = 8  # configs/objaverse-ldm-kl-8.yaml's batch
REG_BATCH = 16  # the regression options' n_bs

# (category, substrings of the lower-cased kernel name), first match wins
CATEGORIES = (
    ("spatial_attention backward kernel", ("attention_bwd",)),
    ("spatial_attention kernel", ("attention_fwd_kernel",)),
    ("softmax (plain attention)", ("softmax",)),
    ("AdamW / EMA (multi-tensor)", ("multi_tensor", "foreach")),
    ("layout (NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw")),
    ("convolution backward", ("dgrad", "wgrad", "bwd_filter", "bwd_data")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "fprop")),
    ("GEMM", ("gemm", "cutlass", "sm90_")),
    ("gathers and their scatter-add (grid_sample)", ("index_select", "indexselect",
                                                    "index_add", "indexfunc",
                                                    "indexing_backward")),
    ("max pool", ("max_pool", "maxpool")),
    ("GroupNorm / BatchNorm", ("group_norm", "groupnorm", "rowwisemoments", "fusedparams",
                               "batch_norm", "batchnorm", "gammabeta", "gamma_beta")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trainer", choices=("ldm", "slicenet"), default="ldm")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(11)
    step, batches, what = (_slicenet if args.trainer == "slicenet" else _ldm)(g, 2 + args.steps)
    for b in batches[:2]:  # warm-up
        step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            step(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    report(prof, wall, args.steps, category, args.top, f"{what}, {args.steps} training steps")
    return 0


def _ldm(g: torch.Generator, n: int):
    from .diffusion.latent import init_latent_diffusion
    from .train.train_ldm import LDMTrainer

    trainer = LDMTrainer(module=init_latent_diffusion(seed=0, dtype=torch.bfloat16))
    state = trainer.init_state()
    batches = [{"image": torch.rand((BATCH, 13, 128, 128, 3), generator=g, device="cuda") * 2 - 1,
                "img_ipt_view": torch.rand((BATCH, 128, 128, 3), generator=g,
                                           device="cuda") * 2 - 1} for _ in range(n)]
    trainer.maybe_set_scale(state, batches[0], g)
    return lambda b: trainer.train_step(state, b, g), batches, f"LDM, batch {BATCH}"


def regression_batches(n: int, g: torch.Generator, b: int = REG_BATCH, size: int = 128,
                       n_qry: int = 256, n_pcd: int = 2048):
    """``n`` seeded regression batches made on ``g``'s device: input views and
    GT slices in [-1, 1], queries in the unit cube with a sphere's SDF,
    cameras of random azimuth and elevation (the dataset's
    ``camera_matrices``), and CameraNet's point clouds, regression matrices
    and intrinsics."""
    from . import camera

    dev = g.device
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,), generator=g,
                                                  device=dev).item()))

    def put(arrays):
        return torch.from_numpy(np.stack(arrays).astype(np.float32)).to(dev)

    out = []
    for _ in range(n):
        cams = [camera.camera_matrices(az, el, 1.2)
                for az, el in rng.uniform((0.0, -0.17), (2 * np.pi, 0.7), (b, 2))]
        regress = [(camera.blender_rt(-az, el, 1.2) @ camera.canonical_rot4()).T
                   for az, el in rng.uniform((0.0, -0.17), (2 * np.pi, 0.7), (b, 2))]
        qry = torch.rand((b, n_qry, 3), generator=g, device=dev) - 0.5
        sdf = qry.norm(dim=-1) - 0.3
        pcd = torch.randn((b, n_pcd, 3), generator=g, device=dev)
        out.append({
            "img_input": torch.rand((b, size, size, 3), generator=g, device=dev) * 2 - 1,
            "img_slices": torch.rand((b, 12, size, size, 3), generator=g, device=dev) * 2 - 1,
            "qry_norot": qry, "sdf": sdf, "occ": (sdf <= 0).float(),
            "obj_rot_mat": put([c[0] for c in cams]),
            "trans_mat_wo_rot_tp": put([c[1] for c in cams]),
            "pcd": 0.3 * pcd / pcd.norm(dim=-1, keepdim=True), "regress_mat": put(regress),
            "norm_mat": torch.eye(4, device=dev).expand(b, 4, 4).contiguous(),
            "K": put([camera.intrinsics(1.0, 1.0)] * b)})
    return out


def seeded_vgg19(seed: int = 19):
    """VGG19 features up to conv5_2 in torchvision's layout, drawn from a
    seeded generator (``random_init_``'s torch default bounds), frozen."""
    from .models.random_init import random_init_
    from .models.vgg import VGG19Features

    return random_init_(VGG19Features(), torch.Generator().manual_seed(seed)).requires_grad_(
        False)


def _slicenet(g: torch.Generator, n: int):
    from .config import Options
    from .train.train_reg import RegressionTrainer

    trainer = RegressionTrainer(Options(n_bs=REG_BATCH, img_size=128, n_qry=256),
                                vgg19=seeded_vgg19())
    state = trainer.init_state()
    return (lambda b: trainer.train_step(state, b), regression_batches(n, g),
            f"SliceNet with the VGG19 term, fp32, batch {REG_BATCH}")


if __name__ == "__main__":
    raise SystemExit(main())
