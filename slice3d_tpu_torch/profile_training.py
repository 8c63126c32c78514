"""Where an LDM training step spends its time on the card.

    python -m slice3d_tpu_torch.profile_training [--steps N]

Runs the training path of chip_smoke.py (``LDMTrainer`` on LatentDiffusion at
the 128 px operating point with seeded random weights, bf16 networks on fp32
master weights, batches of 8 seeded synthetic images made on the card):
sets the scale factor, warms up, then traces ``--steps`` training steps with
``torch.profiler`` and prints the host wall time per step, the card's busy
time and idle share, device time by category (convolution forward and
backward, the spatial_attention kernels, GEMM, normalisation, the
multi-tensor optimizer and EMA updates, elementwise) and the top kernels by
name.  Needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from .profile_sampling import report

BATCH = 8  # configs/objaverse-ldm-kl-8.yaml's batch

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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from .diffusion.latent import init_latent_diffusion
    from .train.train_ldm import LDMTrainer

    trainer = LDMTrainer(module=init_latent_diffusion(seed=0, dtype=torch.bfloat16))
    state = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(11)

    def batch():
        return {"image": torch.rand((BATCH, 13, 128, 128, 3), generator=g, device="cuda") * 2 - 1,
                "img_ipt_view": torch.rand((BATCH, 128, 128, 3), generator=g,
                                           device="cuda") * 2 - 1}

    batches = [batch() for _ in range(2 + args.steps)]
    trainer.maybe_set_scale(state, batches[0], g)
    for b in batches[:2]:  # warm-up
        trainer.train_step(state, b, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            trainer.train_step(state, b, g)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    report(prof, wall, args.steps, category, args.top,
           f"batch {BATCH}, {args.steps} LDM training steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
