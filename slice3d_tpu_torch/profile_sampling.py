"""Where DDIM sampling spends its time on the card.

    python -m slice3d_tpu_torch.profile_sampling [--steps N]

Runs the sampler of chip_smoke.py's generation path (LatentDiffusion at the
128 px operating point with seeded random weights, bf16, a batch of 8
seeded views): encodes and conditions once, warms up, then traces ``--steps``
DDIM steps (one UNet call each) with ``torch.profiler`` and prints the host
wall time per step, the card's busy time (union of kernel intervals) and
idle share, device time by category (convolution, the spatial_attention
kernel, plain attention, GEMM, GroupNorm, layout and elementwise) and the top
kernels by name.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .profile_reconstruct import _busy_us, device_kernels

BATCH = 8  # the operating point's batch of views

# (category, substrings of the lower-cased kernel name), first match wins
CATEGORIES = (
    ("spatial_attention kernel", ("attention_fwd_kernel",)),
    ("softmax (plain attention)", ("softmax",)),
    ("layout (NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "fprop")),
    ("GEMM", ("gemm", "cutlass", "sm90_")),
    ("GroupNorm", ("group_norm", "groupnorm", "rowwisemoments", "fusedparams")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def report(prof, wall: float, steps: int, categorize, top: int, what: str) -> None:
    """Print a trace's device time per step by category and by kernel, the
    card's busy time and idle share against ``wall`` seconds per step, and
    one JSON line of them."""
    kernels = device_kernels(prof)
    busy = _busy_us(kernels) / 1e6 / steps
    by_name, by_cat = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_cat[categorize(e.name)] = by_cat.get(categorize(e.name), 0.0) + us
    total = sum(by_name.values())
    print(f"[profile] {torch.cuda.get_device_name(0)}; {what}")
    print(f"[profile] wall {wall * 1e3:.3f} ms/step, device busy {busy * 1e3:.3f} ms/step, "
          f"idle share {1 - busy / wall:.4f}")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {us / 1e3 / steps:9.3f} ms/step {us / total:6.1%}  {cat}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile] {us / 1e3 / steps:9.3f} ms/step {us / total:6.1%}  "
              f"[{categorize(name)}] {name[:80]}")
    print(json.dumps({"wall_ms_per_step": wall * 1e3, "busy_ms_per_step": busy * 1e3,
                      "idle_share": 1 - busy / wall,
                      "category_ms_per_step": {c: us / 1e3 / steps
                                               for c, us in by_cat.items()}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling: needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from .diffusion.ddim import ddim_sample
    from .diffusion.latent import init_latent_diffusion
    from .diffusion.sampler import make_eps_fn
    from .diffusion.schedule import DDIMParams

    ldm = init_latent_diffusion(seed=0, dtype=torch.bfloat16).to("cuda")
    rng = np.random.default_rng(5)
    views = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 128, 128, 3))
                             .astype(np.float32)).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        cond = ldm.build_cond(ldm.encode_images(views[:, None], generator=g), views)
    eps_fn = make_eps_fn(ldm, cond)
    params = DDIMParams.create(ldm.schedule, args.steps, 1.0)
    shape = (BATCH, 64, 64, 4)
    with torch.no_grad():
        ddim_sample(eps_fn, params, shape, generator=g, device=views.device)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ddim_sample(eps_fn, params, shape, generator=g, device=views.device)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
    report(prof, wall, args.steps, category, args.top,
           f"batch {BATCH}, {args.steps} DDIM steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
