"""Drive the PyTorch/CUDA port of slice3d_tpu on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: name and power limit;
  2. build every kernel of the main path from the sources in the checkout;
  3. each kernel against its plain PyTorch version at the main path's shapes,
     with times (CUDA events) beside the card's bound and a library call;
  4. the main path: ``Reconstructor.reconstruct`` on 3 seeded 128x128 images
     (SliceNet, random seeded weights, bf16, res0 64 / up 2 / chunk 32768),
     with every kernel's launch count read around that run;
  5. correctness on a small input: kernel path vs plain path on the card,
     and the card's fp32 plain path vs the CPU's (which the CPU tests hold
     against the JAX reference).
The last two lines are the kernels' JSON record and the run's status JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
N_POINTS = 8 * 65 * 65  # one coarse-level slab group: 8 z-slabs of 65^2
TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 outputs of LayerNorm: ~2.5 ulp


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def encoder_work(n: int, t: int, head_tokens: int, d: int = 128, f: int = 2048,
                 heads: int = 4):
    """(flops, bytes) one layer needs: q for the kept tokens, k/v for all,
    attention, out-proj and FFN on the kept tokens; x read and the output
    written once, weights and vectors read once."""
    t_out = head_tokens or t
    dh = d // heads
    flops = 2 * n * (d * (t_out * d + t * 2 * d) + heads * t_out * t * dh * 2
                     + t_out * d * d + 2 * t_out * d * f)
    weights = 2 * (4 * d * d + 2 * d * f) + 4 * (3 * d + 6 * d + f)
    return flops, n * (t + t_out) * d * 2 + weights


def phase_kernels(model):
    from slice3d_tpu_torch import native
    from slice3d_tpu_torch.ops import fused_encoder as fe

    from slice3d_tpu_torch.mesh import load_library

    t0 = time.perf_counter()
    fe.library()
    print(f"[build] fused_encoder built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    load_library()
    print(f"[build] host mesh library built in {time.perf_counter() - t0:.2f} s")
    for line in native.BUILD_LOG:
        print(line)

    g = torch.Generator(device="cuda").manual_seed(1)
    layers = model.att_decoder.layers
    modes = []
    lib_layer = torch.nn.TransformerEncoderLayer(128, 4, 2048, batch_first=True)
    lib_layer = lib_layer.eval().to("cuda", torch.bfloat16)
    for head_tokens, layer in ((0, layers[0]), (1, layers[2])):
        params = dict(layer.named_parameters())
        x = torch.randn((1, N_POINTS, 13, 128), generator=g, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            got = fe.fused_encoder_layer(x, params, head_tokens=head_tokens)
            torch.cuda.synchronize()
            want = fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens)
            err = (got.float() - want.float()).abs()
            bad = err > TOL["atol"] + TOL["rtol"] * want.float().abs()
            max_err = err.max().item()
            print(f"[kernel] fused_encoder_layer head_tokens={head_tokens} N={N_POINTS}: "
                  f"max_abs_err {max_err:.6g}, tolerance |k-p| <= {TOL['atol']} + "
                  f"{TOL['rtol']}*|p|, violations {int(bad.sum())}")
            check(got.shape == want.shape and not bad.any()
                  and bool(torch.isfinite(got).all()),
                  f"fused_encoder_layer head_tokens={head_tokens} disagrees with plain")
            ms = cuda_ms(lambda: fe.fused_encoder_layer(x, params, head_tokens=head_tokens), 20)
            plain_ms = cuda_ms(
                lambda: fe.fused_encoder_layer_ref(x, params, head_tokens=head_tokens), 5)
            library_ms = None
            if head_tokens == 0:
                xs = x.reshape(N_POINTS, 13, 128)
                library_ms = cuda_ms(lambda: lib_layer(xs), 20)
        flops, nbytes = encoder_work(N_POINTS, 13, head_tokens)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        modes.append({"head_tokens": head_tokens, "n_points": N_POINTS,
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"[kernel] head_tokens={head_tokens}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)")
    del lib_layer
    return modes


def make_feeds(n: int, seed: int = 0):
    from slice3d_tpu_torch.camera import camera_matrices

    _, proj = camera_matrices(0.0, 0.0, 1.2)
    rng = np.random.default_rng(seed)
    return [{"img_input": rng.uniform(-1, 1, (128, 128, 3)).astype(np.float32),
             "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(n)]


def phase_main_path(model):
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.pipeline import Reconstructor

    feeds = make_feeds(3)
    # random weights: put the iso level at the median coarse logit of the
    # first image (a res0 16 probe), so a real surface exists and the
    # refinement levels run
    probe, _ = Reconstructor(model, resolution0=16, upsampling_steps=0).build_grid(feeds[0])
    threshold = float(1.0 / (1.0 + np.exp(-np.median(probe))))
    print(f"[main] threshold {threshold:.6f} (median coarse logit {np.median(probe):.6f})")
    rec = Reconstructor(model, resolution0=64, upsampling_steps=2, chunk_size=32768,
                        threshold=threshold)
    fe.launches = 0
    results = []
    for i, feed in enumerate(feeds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh, stats = rec.reconstruct(feed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results.append((mesh, stats))
        print(f"[main] request {i}: latency {dt:.4f} s, n_points_evaluated "
              f"{stats['n_points_evaluated']}, final_resolution "
              f"{stats['final_resolution']}, vertices {len(mesh.vertices)}, faces "
              f"{len(mesh.faces)}, eval {stats['time_eval_points']:.4f} s, marching "
              f"{stats['time_marching']:.4f} s")
    launches = fe.launches
    print(f"[main] fused_encoder_layer launches over 3 requests: {launches}")
    check(launches > 0, "the main path launched no fused_encoder_layer kernel")
    for mesh, stats in results:
        check(stats["n_points_evaluated"] > 65 ** 3, "the refinement levels did not run")
        check(stats["final_resolution"] == 256, "wrong final resolution")
        check(not mesh.is_empty and bool(np.isfinite(mesh.vertices).all()),
              "empty mesh or non-finite vertices")
    return launches, rec, feeds


def phase_correctness(model, rec, feed):
    """Checks of the path around the kernel, on the card."""
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.pipeline import Reconstructor

    grid, _ = rec.build_grid(feed)
    check(grid.shape == (257,) * 3 and bool(np.isfinite(grid).all()),
          f"main-path grid not finite or of shape {grid.shape}")

    small = dict(resolution0=16, upsampling_steps=0, chunk_size=4096)
    for lattice in (True, False):
        route = "lattice" if lattice else "gather"
        # 1. bf16 kernel path vs the bf16 plain path, same weights
        kern, _ = Reconstructor(model, lattice_dense=lattice, **small).build_grid(feed)
        for layer in model.att_decoder.layers:
            layer.fused = False
        plain, _ = Reconstructor(model, lattice_dense=lattice, **small).build_grid(feed)
        for layer in model.att_decoder.layers:
            layer.fused = True
        err_k = float(np.abs(kern - plain).max())
        print(f"[check] {route}: 17^3 logits, kernel path vs plain path (bf16): "
              f"max_abs_err {err_k:.6g} (tolerance 5e-2: bf16 rounding flips "
              f"through 3 layers and fc_out)")
        check(err_k <= 5e-2, f"{route}: kernel path disagrees with the plain path")

        # 2. fp32 plain path: card vs CPU (the CPU tests hold it against JAX)
        torch.backends.cudnn.allow_tf32 = False
        m32 = init_slicenet(0, fused=False)
        cpu, _ = Reconstructor(m32, device="cpu", lattice_dense=lattice,
                               **small).build_grid(feed)
        gpu, _ = Reconstructor(m32, lattice_dense=lattice, **small).build_grid(feed)
        torch.backends.cudnn.allow_tf32 = True
        err_f = float(np.abs(cpu - gpu).max())
        print(f"[check] {route}: 17^3 logits, fp32 card vs CPU: max_abs_err "
              f"{err_f:.6g} (tolerance 1e-3: fp32 summation order)")
        check(err_f <= 1e-3, f"{route}: card and CPU fp32 paths disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from slice3d_tpu_torch.models.slicenet import init_slicenet

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")

    model = init_slicenet(seed=0, dtype=torch.bfloat16).to("cuda")
    modes = phase_kernels(model)
    launches, rec, feeds = phase_main_path(model)
    phase_correctness(model, rec, feeds[0])

    full = modes[0]
    record = {"name": "fused_encoder_layer", "route": "cuda",
              "source": "slice3d_tpu_torch/csrc/fused_encoder.cu",
              "replaces": "slice3d_tpu/ops/pallas_encoder.py:463",
              "launches": launches,
              "max_abs_err": max(m["max_abs_err"] for m in modes),
              "tol": f"|k-p| <= {TOL['atol']} + {TOL['rtol']}*|p|",
              "ms": full["ms"], "kernel_ms": full["ms"], "plain_ms": full["plain_ms"],
              "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
              "library_ms": full["library_ms"], "modes": modes}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
