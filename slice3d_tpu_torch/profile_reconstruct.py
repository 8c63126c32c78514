"""Where one reconstruction spends its time on the card.

    python -m slice3d_tpu_torch.profile_reconstruct [--requests N]

Runs the main path of chip_smoke.py (SliceNet with seeded random weights,
bf16, one 128x128 image, res0 64 / up 2 / chunk 32768), warms it up once, then
traces ``--requests`` reconstructions with ``torch.profiler`` and prints:
the host wall time per request, the card's busy time (union of kernel
intervals) and idle share, and device time by kernel name.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def device_kernels(prof) -> list:
    """A trace's kernels on the card (not the GPU-side user annotations, such
    as ``Optimizer.step``, whose spans cover idle time too)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def _busy_us(events) -> float:
    """Union of device kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_reconstruct: needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from .camera import camera_matrices
    from .models.slicenet import init_slicenet
    from .pipeline import Reconstructor

    model = init_slicenet(seed=0, dtype=torch.bfloat16).to("cuda")
    _, proj = camera_matrices(0.0, 0.0, 1.2)
    rng = np.random.default_rng(0)
    feed = {"img_input": rng.uniform(-1, 1, (128, 128, 3)).astype(np.float32),
            "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    probe, _ = Reconstructor(model, resolution0=16, upsampling_steps=0).build_grid(feed)
    threshold = float(1.0 / (1.0 + np.exp(-np.median(probe))))
    rec = Reconstructor(model, resolution0=64, upsampling_steps=2, chunk_size=32768,
                        threshold=threshold)
    rec.reconstruct(feed)  # warm-up
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            t0 = time.perf_counter()
            _, stats = rec.reconstruct(feed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy_s = _busy_us(kernels) / 1e6 / args.requests
    wall = float(np.mean(walls))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"[profile] {torch.cuda.get_device_name(0)}; requests {args.requests}; "
          f"points/request {stats['n_points_evaluated']}")
    print(f"[profile] wall {wall:.4f} s/request, device busy {busy_s:.4f} s/request, "
          f"idle share {1 - busy_s / wall:.4f}; host marching "
          f"{stats['time_marching']:.4f} s")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    for name, us in rows:
        print(f"[profile] {us / 1e3 / args.requests:9.3f} ms/request "
              f"{us / total:6.1%}  {name[:90]}")
    print(json.dumps({"wall_s": wall, "busy_s": busy_s, "idle_share": 1 - busy_s / wall,
                      "kernel_ms": {n[:60]: us / 1e3 / args.requests for n, us in rows}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
