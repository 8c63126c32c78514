"""Drive the PyTorch/CUDA port of slice3d_tpu on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: name and power limit;
  2. build every kernel of both paths from the sources in the checkout, one
     compiler per source, all started together (ptxas register and shared
     memory use printed);
  3. each kernel against its plain PyTorch version at the paths' shapes,
     with times (CUDA events) beside the card's bound and a library call,
     all in this run (the attention kernels also print kernel / library and
     bound / kernel):
     fused_encoder_layer at N = 33,800 points, spatial_attention at
     (8, 8, 4096, 24) and (8, 8, 1024, 48), fused_ffn at N = 439,400 and
     33,800 rows (the split route's full and trimmed layers of one slab group);
  4. the regression path: ``Reconstructor.reconstruct`` on 3 seeded 128x128
     images (SliceNet, random seeded weights, bf16, res0 64 / up 2 / chunk
     32768), with every kernel's launch count read around that run;
  5. the generation path: ``sample_slices`` (kl-f8 VAE, LDM UNet 192 ch,
     VGG16-BN conditioner, random seeded weights, bf16) on a batch of 8
     seeded 128x128 views with DDIM-200, eta 1, then GTSlice
     ``Reconstructor.reconstruct`` of every generated object at res0 64 /
     up 2, with the launch counts read around the sampling and around the
     reconstructions (the res0 16 probe that sets the iso level between
     them is not counted);
  6. correctness on small inputs: kernel path vs plain path on the card, and
     the card's fp32 plain path vs the CPU's (which the CPU tests hold
     against the JAX reference), for SliceNet (fused and split routes), the
     sampler's atlas and GTSlice;
  7. spatial_attention's backward kernel against its plain version at the
     training path's shapes (through autograd), with its time beside the
     bound, the plain version's and scaled_dot_product_attention's backward
     (through autograd, against ours through autograd), and the host time to
     issue each;
  8. the training path: ``LDMTrainer`` at configs/objaverse-ldm-kl-8.yaml's
     widths (batch 8 of seeded synthetic 128x128 images, bf16 networks on
     fp32 master weights, AdamW at lr 4e-4, EMA, scale_by_std, train-mode
     BatchNorm in the conditioner): ``maybe_set_scale``, 2 warm-up steps,
     10 timed steps with the launch counts read around them (10 forward and
     10 backward attention launches per step), the losses and peak memory,
     then one step's gradients at batch 1 kernel path vs plain path (bf16)
     and the fp32 plain path card vs CPU on the tiny configuration;
  9. the serving path: the port's ``Slice3DService`` (SliceNet, img 128, bf16,
     seeded weights, res0 64 / up 2 / chunk 32768, ``mc_batch_size`` 4, an
     80 ms window) over HTTP on 127.0.0.1, 8 seeded 128x128 RGBA PNG
     requests at concurrency 8 (latency per request, p50, p90, requests per
     second, ``reconstruct_batch`` calls, launch counts), then the same 8
     images one at a time through ``reconstruct`` (batch 1) against the
     batched answers;
 10. the split-encoder route: the same weights with ``route="split"`` on 2 of
     the images, 0 encoder launches and 3 fused_ffn launches per head call.
The last two lines are the kernels' JSON record and the run's status JSON.
"""

from __future__ import annotations

import ctypes
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3; the
# special function units issue 16 exp2 per clock per SM (132 SMs)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK = 16 * 132
N_POINTS = 8 * 65 * 65  # one coarse-level slab group: 8 z-slabs of 65^2
TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 outputs of LayerNorm: ~2.5 ulp
# fused_ffn kernel vs plain: both round h and the output to bf16 from fp32 sums
# taken in another order (readings on an NVIDIA H100 80GB HBM3 at 700 W, N =
# 1,500 to 439,400: largest error 0.0156 = one bf16 ulp in [2, 4), outputs up
# to 5)
FFN_TOL = dict(atol=2e-2, rtol=1e-2)
FFN_ROWS = (13 * N_POINTS, N_POINTS)  # layers 0-1 (13 tokens) and layer 2 (token 0)
# serving: requests at mc_batch_size 4 in an 80 ms window, then the same images
# at batch 1; the batched answers differ from the serial ones where bf16
# convolutions at batch 4 round otherwise and move refinement mask points
# (readings on an NVIDIA H100 80GB HBM3 at 700 W, n_points_evaluated and vertex
# counts: largest relative difference 3.1e-3 over the 8 images, the same in
# three calls; the tolerance is ~3x that)
SERVE_REQUESTS, SERVE_BATCH, SERVE_WINDOW_MS = 8, 4, 80.0
SERVE_POINT = dict(img_size=128, mc_res0=64, mc_up_steps=2, mc_chunk_size=32768)
SERVE_RTOL = 1e-2
# kernel vs plain spatial attention: the kernel rounds the unnormalised
# exp(s - m) to bf16 and divides at the end, the plain version (like the TPU
# kernel) normalises and then rounds, so they differ by bf16 rounding of the
# probabilities: a few bf16 ulps of outputs of order 1
ATTN_TOL = dict(atol=1e-2, rtol=2e-2)
ATTN_SHAPES = ((8, 8, 4096, 24), (8, 8, 1024, 48))  # ds 1 and ds 2 blocks, batch 8
# backward kernel vs its plain version (dq, dk, dv), element-wise: the kernel
# takes D = rowsum(do o) from the bf16 output where the plain version (like the
# TPU kernel) sums rowsum(dp p) in fp32, so dS differs by ~D's rounding and its
# bf16 rounding flips, and the kernel sums dq over key blocks in fp32 in
# another order (readings on an NVIDIA H100 80GB HBM3 at 700 W at both shapes,
# two-pass design and one-pass design alike: largest error 0.047 where |p| < 1,
# largest err/|p| 0.039 where |p| >= 1, against |p| up to 21: a few bf16 ulps;
# the tolerance is ~1.7x the absolute, ~1.03x the relative readings, and both
# terms add: at |p| = 1.6, where that relative reading fell, it allows 0.144)
ATTN_BWD_TOL = dict(atol=0.08, rtol=0.04)
# the sampler's atlas after 4 DDIM steps (eta 0, batch 1), element-wise: kernel
# path vs plain path in bf16, where the probabilities' rounding differs inside
# 4 UNet calls (readings on the H100: largest error 0.064 where |p| < 1 and
# 0.083 overall, at |p| 1.6, against |p| up to 36: an absolute error of a few
# hundredths, so atol carries it at ~3x); and the fp32 plain path on the card
# vs the CPU (readings: 2.0e-5)
ATLAS_TOL = dict(atol=0.2, rtol=0.01)
ATLAS_FP32_TOL = dict(atol=1e-3, rtol=1e-3)
GEN_BATCH, GEN_STEPS = 8, 200
# LDM training at configs/objaverse-ldm-kl-8.yaml's widths: batch 8 of 128 px,
# 2 warm-up steps, then the timed ones
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 10
# one step's gradients at batch 1, kernel path vs plain path (bf16), element-wise
# over all parameters: |k - p| <= atol G + rtol |p|, G the model's largest
# |gradient| (both paths round the attention's probabilities and dS to bf16 at
# other points, and a bf16 UNet's gradients carry that through every layer;
# readings on the H100: largest error 0.0083 G, and 0.022 of the tensor's own
# largest gradient among tensors above 0.01 G; losses 4.1e-4 apart, relative)
GRAD_TOL = dict(atol=0.02, rtol=0.05)
LOSS_RTOL = 2e-3
# the fp32 plain path on the card vs the CPU, one step's gradients of the tiny
# configuration, as above (fp32 summation order; readings: 4.5e-7 G, and 8.5e-6
# of the tensor's own largest gradient; the losses equal)
GRAD_FP32_TOL = dict(atol=2e-6, rtol=1e-4)
TRAIN_TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
                  unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1,),
                  unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=8)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def check_close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> None:
    """Element-wise |got - want| <= atol + rtol |want|, with the readings
    that set such a tolerance: the largest error where |want| < 1 and the
    largest error relative to |want| where |want| >= 1."""
    got, want = got.float().cpu(), want.float().cpu()
    err, mag = (got - want).abs(), want.abs()
    bad = err > tol["atol"] + tol["rtol"] * mag
    small, large = mag < 1, mag >= 1
    at = int(err.argmax())
    print(f"[check] {what}: max_abs_err {err.max().item():.6g} at |want| "
          f"{mag.flatten()[at].item():.4g}, max |want| {mag.max().item():.4g}; max err "
          f"where |want| < 1: {err[small].max().item() if small.any() else 0.0:.6g}, max "
          f"err/|want| where |want| >= 1: "
          f"{(err[large] / mag[large]).max().item() if large.any() else 0.0:.6g}; "
          f"tolerance |k-p| <= {tol['atol']} + {tol['rtol']}*|p|, violations "
          f"{int(bad.sum())}")
    check(got.shape == want.shape and not bad.any(), f"{what}: disagree")


def reset_counts() -> None:
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.ops import spatial_attention as sa

    fe.launches = 0
    ff.launches = 0
    sa.launches = 0
    sa.launches_bwd = 0


def read_counts() -> dict:
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.ops import spatial_attention as sa

    return {"fused_encoder_layer": fe.launches, "fused_ffn": ff.launches,
            "spatial_attention": sa.launches, "spatial_attention_bwd": sa.launches_bwd}


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


def host_ms(fn, iters: int) -> float:
    """Host time to issue one call: the mean over ``iters`` calls made with
    no synchronisation between them (fewer than fill the launch queue)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


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


def phase_build():
    """Every library of both paths, one compiler each, all started together."""
    from slice3d_tpu_torch import native
    from slice3d_tpu_torch.mesh import load_library
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.ops import spatial_attention as sa

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"fused_encoder": fe.kernel, "fused_ffn": ff.kernel,
              "spatial_attention": sa.kernel, "spatial_attention_bwd": sa.kernel_bwd,
              "host mesh library": load_library}
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        for name, fut in futs.items():
            print(f"[build] {name} built in {fut.result():.2f} s")
    print(f"[build] all built in {time.perf_counter() - t0:.2f} s")
    for line in native.BUILD_LOG:
        print(line)
    lib = ctypes.CDLL(os.path.join(native.BUILD_DIR, "libs3d_fused_ffn.so"))  # built above
    print(f"[build] fused_ffn: {lib.s3d_fused_ffn_smem_bytes()} bytes of dynamic shared "
          f"memory per block")


def phase_kernels(model):
    from slice3d_tpu_torch.ops import fused_encoder as fe

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


def ffn_work(n: int, d: int = 128, f: int = 2048):
    """(flops, bytes) of one FFN call: both products on the tensor cores, x
    read and the output written once (bf16), the weights (bf16) and biases
    (fp32) read once."""
    return 4 * n * d * f, 2 * n * d * 2 + 2 * d * f * 2 + (f + d) * 4


def phase_ffn(model):
    """fused_ffn against its plain version at the split route's row counts,
    on the model's FFN weights, with the cuBLAS sequence F.linear -> relu ->
    F.linear (bf16) as the library time."""
    from slice3d_tpu_torch.ops import fused_ffn as ff

    g = torch.Generator(device="cuda").manual_seed(4)
    layers = model.att_decoder.layers
    modes = []
    for n, layer in zip(FFN_ROWS, (layers[0], layers[2])):
        w1, b1 = layer.linear1.weight, layer.linear1.bias
        w2, b2 = layer.linear2.weight, layer.linear2.bias
        # the FFN's input is a LayerNorm output: ~N(0, 1) per row
        x = torch.randn((n, 128), generator=g, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            got = ff.fused_ffn(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            want = ff.fused_ffn_ref(x, w1, b1, w2, b2)
            check(bool(torch.isfinite(got).all()), f"fused_ffn N={n}: non-finite output")
            check_close(got, want, FFN_TOL, f"fused_ffn N={n}, kernel vs plain (bf16)")
            max_err = (got.float() - want.float()).abs().max().item()
            del want
            ms = cuda_ms(lambda: ff.fused_ffn(x, w1, b1, w2, b2), 20)
            plain_ms = cuda_ms(lambda: ff.fused_ffn_ref(x, w1, b1, w2, b2), 3)
            lw1, lw2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
            lb1, lb2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
            library_ms = cuda_ms(lambda: torch.nn.functional.linear(
                torch.relu(torch.nn.functional.linear(x, lw1, lb1)), lw2, lb2), 20)
        flops, nbytes = ffn_work(n)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        modes.append({"n_rows": n, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"[kernel] fused_ffn N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(F.linear -> relu -> F.linear, bf16) {library_ms:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return modes


def attention_work(shape, sm_clock_hz: float):
    """(flops, exps, bytes, bound_ms, bound_by) of one attention call: both
    products on the tensor cores, one exponential per logit on the special
    function units, q/k/v read and the output written once (bf16)."""
    b, h, t, dh = shape
    flops = 4 * b * h * t * t * dh
    exps = b * h * t * t
    nbytes = 4 * b * h * t * dh * 2
    times = {"operations (tensor cores)": flops / PEAK_BF16_FLOPS,
             "operations (exponentials)": exps / (SFU_PER_CLOCK * sm_clock_hz),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return flops, exps, nbytes, times[by] * 1e3, by


def phase_attention(sm_clock_hz: float):
    from slice3d_tpu_torch.ops import spatial_attention as sa

    g = torch.Generator(device="cuda").manual_seed(2)
    modes = []
    for shape in ATTN_SHAPES:
        # q, k ~ N(0, 4): logits of std ~4, a peaked softmax with outputs of
        # order 1 (a flat one would average v towards 0 and hide errors)
        q, k = (2.0 * torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        v = torch.randn(shape, generator=g, device="cuda")
        q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        scale = shape[-1] ** -0.5
        with torch.no_grad():
            got = sa.spatial_attention(q, k, v, scale)
            torch.cuda.synchronize()
            want = sa.spatial_attention_ref(q, k, v, scale)
            err = (got.float() - want.float()).abs()
            bad = err > ATTN_TOL["atol"] + ATTN_TOL["rtol"] * want.float().abs()
            max_err = err.max().item()
            print(f"[kernel] spatial_attention {shape}: max_abs_err {max_err:.6g} "
                  f"(max |plain| {want.float().abs().max().item():.4g}), tolerance "
                  f"|k-p| <= {ATTN_TOL['atol']} + {ATTN_TOL['rtol']}*|p|, violations "
                  f"{int(bad.sum())}")
            check(got.shape == want.shape and not bad.any()
                  and bool(torch.isfinite(got).all()),
                  f"spatial_attention {shape} disagrees with plain")
            del want, err, bad
            ms = cuda_ms(lambda: sa.spatial_attention(q, k, v, scale), 20)
            plain_ms = cuda_ms(lambda: sa.spatial_attention_ref(q, k, v, scale), 3)
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), 20)
        flops, exps, nbytes, bound_ms, bound_by = attention_work(shape, sm_clock_hz)
        modes.append({"shape": list(shape), "max_abs_err": max_err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
                      "gexp": exps / 1e9, "mbytes": nbytes / 1e6,
                      "ms_over_library": ms / library_ms, "bound_share": bound_ms / ms})
        print(f"[kernel] spatial_attention {shape}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (scaled_dot_product_attention) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops / 1e9:.2f} GFLOP, {exps / 1e9:.4f} G exp, {nbytes / 1e6:.2f} MB); "
              f"kernel / library {ms / library_ms:.4f}, bound / kernel {bound_ms / ms:.4f}")
    return modes


def attention_bwd_work(shape, sm_clock_hz: float):
    """(flops, exps, bytes, bound_ms, bound_by) of one attention backward:
    the five products (S, dP, dV, dK, dQ: 10 T^2 DH per head) on the tensor
    cores, one exponential per logit, q/k/v/o/do read and dq/dk/dv written
    once (bf16) with the forward's fp32 row log-sum-exp."""
    b, h, t, dh = shape
    flops = 10 * b * h * t * t * dh
    exps = b * h * t * t
    nbytes = 8 * b * h * t * dh * 2 + 4 * b * h * t
    times = {"operations (tensor cores)": flops / PEAK_BF16_FLOPS,
             "operations (exponentials)": exps / (SFU_PER_CLOCK * sm_clock_hz),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return flops, exps, nbytes, times[by] * 1e3, by


def phase_attention_bwd(sm_clock_hz: float):
    """The backward kernel through the autograd path (``spatial_attention``
    then ``torch.autograd.grad``) against ``spatial_attention_bwd_ref`` on the
    same bf16 inputs, at the training path's shapes."""
    from slice3d_tpu_torch.ops import spatial_attention as sa

    g = torch.Generator(device="cuda").manual_seed(3)
    modes = []
    for shape in ATTN_SHAPES:
        q, k = (2.0 * torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        v, do = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
        scale = shape[-1] ** -0.5
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        out = sa.spatial_attention(*qkv, scale)
        got = torch.autograd.grad(out, qkv, do, retain_graph=True)
        torch.cuda.synchronize()
        want = sa.spatial_attention_bwd_ref(q, k, v, do, scale)
        # readings only: both against the exact gradients of the same bf16
        # inputs (fp32 autograd of the plain forward, no rounding inside)
        q32 = [x.float().requires_grad_() for x in (q, k, v)]
        exact = torch.autograd.grad(sa.spatial_attention_ref(*q32, scale), q32, do.float())
        max_err = 0.0
        for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
            check(bool(torch.isfinite(a).all()), f"spatial_attention_bwd {shape}: {name} "
                  "not finite")
            check_close(a, b, ATTN_BWD_TOL, f"spatial_attention_bwd {shape} {name}, kernel "
                        "vs plain (bf16)")
            max_err = max(max_err, (a.float() - b.float()).abs().max().item())
            print(f"[check] spatial_attention_bwd {shape} {name} against the exact fp32 "
                  f"gradient: kernel {(a.float() - e).abs().max().item():.6g}, plain "
                  f"{(b.float() - e).abs().max().item():.6g}")
        del want, exact, q32
        # the kernel's launch wrapper alone; the library (SDPA's backward) runs
        # only through autograd, so the like-for-like ratio is ours through
        # autograd against it
        out_k, lse = out.detach(), out.grad_fn.saved_tensors[4]
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        ms = cuda_ms(lambda: sa._backward_kernel(qc, kc, vc, out_k, lse, do, scale), 20)
        autograd_ms = cuda_ms(lambda: torch.autograd.grad(out, qkv, do, retain_graph=True), 20)
        plain_ms = cuda_ms(lambda: sa.spatial_attention_bwd_ref(q, k, v, do, scale), 3)
        lib_out = torch.nn.functional.scaled_dot_product_attention(*qkv, scale=scale)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, qkv, do, retain_graph=True),
                             20)
        # host time to issue one call, for where the host sets the pace: the C
        # entry point alone (four tensor maps, three launches; its scratch is
        # not re-zeroed, so its dq is wrong: timing only), the wrapper (its
        # checks, five allocations and the zeroed dq scratch besides), ours
        # through autograd, and SDPA's backward through autograd
        b, h, t, dh = shape
        scratch = [torch.empty((b, h, t), device="cuda"), torch.zeros(shape, device="cuda")]
        grads = [torch.empty_like(q) for _ in range(3)]
        args = [x.data_ptr() for x in (qc, kc, vc, out_k, do, lse, *scratch, *grads)]
        entry, stream = sa.kernel_bwd(), torch.cuda.current_stream().cuda_stream
        host = {"entry": host_ms(lambda: entry(*args, b * h, t, dh, scale, stream), 20),
                "wrapper": host_ms(
                    lambda: sa._backward_kernel(qc, kc, vc, out_k, lse, do, scale), 20),
                "autograd": host_ms(
                    lambda: torch.autograd.grad(out, qkv, do, retain_graph=True), 20),
                "library": host_ms(
                    lambda: torch.autograd.grad(lib_out, qkv, do, retain_graph=True), 20)}
        del out, lib_out, qkv, lse, scratch, grads
        flops, exps, nbytes, bound_ms, bound_by = attention_bwd_work(shape, sm_clock_hz)
        modes.append({"shape": list(shape), "max_abs_err": max_err, "ms": ms,
                      "autograd_ms": autograd_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "gflop": flops / 1e9, "gexp": exps / 1e9, "mbytes": nbytes / 1e6,
                      "host_ms": host, "autograd_ms_over_library": autograd_ms / library_ms,
                      "bound_share": bound_ms / ms})
        print(f"[kernel] spatial_attention_bwd {shape}: kernel {ms:.4f} ms (through "
              f"autograd {autograd_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
              f"(scaled_dot_product_attention backward, through autograd) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops / 1e9:.2f} GFLOP, {exps / 1e9:.4f} G exp, {nbytes / 1e6:.2f} MB); "
              f"through autograd / library {autograd_ms / library_ms:.4f}, bound / kernel "
              f"{bound_ms / ms:.4f}; host ms to issue a call: C entry point "
              f"{host['entry']:.4f}, wrapper {host['wrapper']:.4f}, through autograd "
              f"{host['autograd']:.4f}, library through autograd {host['library']:.4f}")
    return modes


def make_feeds(n: int, seed: int = 0):
    from slice3d_tpu_torch.camera import camera_matrices

    _, proj = camera_matrices(0.0, 0.0, 1.2)
    rng = np.random.default_rng(seed)
    return [{"img_input": rng.uniform(-1, 1, (128, 128, 3)).astype(np.float32),
             "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(n)]


def phase_main_path(model):
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
    reset_counts()
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
    counts = read_counts()
    print(f"[main] launches over 3 requests: {counts}")
    check(counts["fused_encoder_layer"] > 0,
          "the main path launched no fused_encoder_layer kernel")
    for mesh, stats in results:
        check(stats["n_points_evaluated"] > 65 ** 3, "the refinement levels did not run")
        check(stats["final_resolution"] == 256, "wrong final resolution")
        check(not mesh.is_empty and bool(np.isfinite(mesh.vertices).all()),
              "empty mesh or non-finite vertices")
    return counts, rec, feeds


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
        set_route(model, "plain")
        plain, _ = Reconstructor(model, lattice_dense=lattice, **small).build_grid(feed)
        set_route(model, "fused")
        err_k = float(np.abs(kern - plain).max())
        print(f"[check] {route}: 17^3 logits, kernel path vs plain path (bf16): "
              f"max_abs_err {err_k:.6g} (tolerance 5e-2: bf16 rounding flips "
              f"through 3 layers and fc_out)")
        check(err_k <= 5e-2, f"{route}: kernel path disagrees with the plain path")

        # 2. fp32 plain path: card vs CPU (the CPU tests hold it against JAX)
        torch.backends.cudnn.allow_tf32 = False
        m32 = init_slicenet(0, route="plain")
        cpu, _ = Reconstructor(m32, device="cpu", lattice_dense=lattice,
                               **small).build_grid(feed)
        gpu, _ = Reconstructor(m32, lattice_dense=lattice, **small).build_grid(feed)
        torch.backends.cudnn.allow_tf32 = True
        err_f = float(np.abs(cpu - gpu).max())
        print(f"[check] {route}: 17^3 logits, fp32 card vs CPU: max_abs_err "
              f"{err_f:.6g} (tolerance 1e-3: fp32 summation order)")
        check(err_f <= 1e-3, f"{route}: card and CPU fp32 paths disagree")


def set_route(model, route: str) -> None:
    """Send the head's encoder layers to another route (same weights)."""
    for layer in model.att_decoder.layers:
        layer.route = route


def phase_split_checks(model, feed):
    """The split route on small inputs: kernel path (fused_ffn) vs its
    plain path (fused_ffn_ref in the same layers) in bf16, and the fp32
    split route on the card (the FFN's plain version: the kernel takes bf16
    only) vs the CPU."""
    from slice3d_tpu_torch.models import layers
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.pipeline import Reconstructor

    small = dict(resolution0=16, upsampling_steps=0, chunk_size=4096)
    set_route(model, "split")
    m32 = init_slicenet(0, route="split")
    try:
        for lattice in (True, False):
            route = "lattice" if lattice else "gather"
            before = ff.launches
            kern, _ = Reconstructor(model, lattice_dense=lattice, **small).build_grid(feed)
            check(ff.launches > before, "the split route launched no fused_ffn kernel")
            layers.fused_ffn = ff.fused_ffn_ref
            try:
                plain, _ = Reconstructor(model, lattice_dense=lattice, **small).build_grid(feed)
                torch.backends.cudnn.allow_tf32 = False
                # the Reconstructor refuses an fp32 kernel route on the card:
                # build it on the plain route, then split with the FFN plain
                set_route(m32, "plain")
                rec32 = Reconstructor(m32, lattice_dense=lattice, **small)
                set_route(m32, "split")
                gpu, _ = rec32.build_grid(feed)
            finally:
                layers.fused_ffn = ff.fused_ffn
                torch.backends.cudnn.allow_tf32 = True
            cpu, _ = Reconstructor(m32, device="cpu", lattice_dense=lattice,
                                   **small).build_grid(feed)
            err_k = float(np.abs(kern - plain).max())
            err_f = float(np.abs(cpu - gpu).max())
            print(f"[check] split route, {route}: 17^3 logits, kernel path vs plain path "
                  f"(bf16): max_abs_err {err_k:.6g} (tolerance 5e-2: bf16 rounding flips "
                  f"through 3 layers and fc_out); fp32 card vs CPU: max_abs_err {err_f:.6g} "
                  f"(tolerance 1e-3: fp32 summation order)")
            check(err_k <= 5e-2, f"split {route}: kernel path disagrees with the plain path")
            check(err_f <= 1e-3, f"split {route}: card and CPU fp32 paths disagree")
    finally:
        set_route(model, "fused")


def probe_threshold(model, feed) -> float:
    """Iso level at the median coarse logit of a res0 16 probe: random
    weights then give a real surface and the refinement levels run."""
    from slice3d_tpu_torch.pipeline import Reconstructor

    probe, _ = Reconstructor(model, resolution0=16, upsampling_steps=0).build_grid(feed)
    return float(1.0 / (1.0 + np.exp(-np.median(probe))))


def phase_generation():
    """The generation route at the 128 px operating point: DDIM-200 over a
    batch of 8 views, then GTSlice reconstruction of each object."""
    from slice3d_tpu_torch.camera import camera_matrices
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.diffusion.sampler import sample_slices
    from slice3d_tpu_torch.models.gtslice import init_gtslice
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.pipeline import Reconstructor

    ldm = init_latent_diffusion(seed=0, dtype=torch.bfloat16).to("cuda")
    gts = init_gtslice(seed=0, dtype=torch.bfloat16).to("cuda")
    rng = np.random.default_rng(5)
    views = torch.from_numpy(rng.uniform(-1, 1, (GEN_BATCH, 128, 128, 3)).astype(np.float32))
    g = torch.Generator(device="cuda")
    sample_slices(ldm, views, ddim_steps=2, eta=1.0, generator=g.manual_seed(1))  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    slices = sample_slices(ldm, views, ddim_steps=GEN_STEPS, eta=1.0,
                           generator=g.manual_seed(0))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sampled = read_counts()
    print(f"[gen] sample_slices: batch {GEN_BATCH}, DDIM-{GEN_STEPS}, eta 1.0: "
          f"{sample_s:.4f} s per batch; launches {sampled}")
    check(sampled["spatial_attention"] == 10 * GEN_STEPS,
          f"spatial_attention launched {sampled['spatial_attention']} times, "
          f"expected 10 x {GEN_STEPS}")
    slices_np = slices.cpu().numpy()
    check(slices_np.shape == (GEN_BATCH, 12, 128, 128, 3), f"slices {slices_np.shape}")
    check(bool(np.isfinite(slices_np).all()), "non-finite generated slices")
    stds = slices_np.reshape(GEN_BATCH * 12, -1).std(axis=1)
    print(f"[gen] slices: mean {slices_np.mean():.4f}, std {slices_np.std():.4f}, "
          f"min {slices_np.min():.4f}, max {slices_np.max():.4f}, least per-slice std "
          f"{stds.min():.4g}")
    check(bool((stds > 0).all()), "a generated slice is constant")

    _, proj = camera_matrices(0.0, 0.0, 1.2)
    feeds = [{"img_slices": slices_np[i], "trans_mat_wo_rot_tp": proj.astype(np.float32)}
             for i in range(GEN_BATCH)]
    threshold = probe_threshold(gts, feeds[0])
    print(f"[gen] GTSlice threshold {threshold:.6f}")
    rec = Reconstructor(gts, resolution0=64, upsampling_steps=2, chunk_size=32768,
                        threshold=threshold)
    reset_counts()  # the probe is not the path: count the reconstructions alone
    objects = []
    for i, feed in enumerate(feeds):
        before = fe.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh, stats = rec.reconstruct(feed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        objects.append({"latency_s": dt, "n_points_evaluated": stats["n_points_evaluated"],
                        "vertices": len(mesh.vertices), "faces": len(mesh.faces),
                        "fused_encoder_layer_launches": fe.launches - before})
        print(f"[gen] object {i}: latency {dt:.4f} s, n_points_evaluated "
              f"{stats['n_points_evaluated']}, vertices {len(mesh.vertices)}, faces "
              f"{len(mesh.faces)}, fused_encoder_layer launches {fe.launches - before}")
        check(stats["n_points_evaluated"] > 65 ** 3, "the refinement levels did not run")
        check(stats["final_resolution"] == 256, "wrong final resolution")
        check(not mesh.is_empty and bool(np.isfinite(mesh.vertices).all()),
              "empty mesh or non-finite vertices")
    recon = read_counts()
    counts = {name: sampled[name] + recon[name] for name in sampled}
    print(f"[gen] launches over the generation path (sampling + {GEN_BATCH} "
          f"reconstructions): {counts}")
    check(recon["fused_encoder_layer"]
          == sum(o["fused_encoder_layer_launches"] for o in objects)
          and all(o["fused_encoder_layer_launches"] > 0 for o in objects),
          "GTSlice did not launch fused_encoder_layer for every object")

    # one UNet call at the operating point, the conditioning of this batch
    with torch.no_grad():
        z = ldm.encode_images(views.cuda()[:, None], generator=g.manual_seed(3))
        cond = ldm.build_cond(z, views.cuda())
        x = torch.randn((GEN_BATCH, 64, 64, 4), generator=g, device="cuda")
        t = torch.full((GEN_BATCH,), 500, dtype=torch.int64, device="cuda")
        unet_ms = cuda_ms(lambda: ldm.apply_model(x, t, cond), 10)
    print(f"[gen] UNet call (batch {GEN_BATCH}, 64x64 atlas, bf16): {unet_ms:.4f} ms")
    return {"sample_s": sample_s, "unet_ms": unet_ms, "counts": counts,
            "objects": objects}, ldm, gts, views, feeds


def set_fused(model, fused: bool) -> None:
    """Send the UNet's long attention to the kernels (True) or to the plain
    version, autograd through plain ops (False)."""
    from slice3d_tpu_torch.models.ldm_unet import AttentionBlock

    for mod in model.modules():
        if isinstance(mod, AttentionBlock):
            mod.fused = fused


def phase_generation_checks(ldm, gts, views, feed):
    """Small inputs on the card: the sampler's atlas and GTSlice's logits,
    kernel path vs plain path (bf16), and the fp32 plain path card vs CPU."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.diffusion.sampler import sample_atlas
    from slice3d_tpu_torch.models.gtslice import init_gtslice
    from slice3d_tpu_torch.pipeline import Reconstructor

    rng = np.random.default_rng(6)
    fixed = dict(ddim_steps=4, eta=0.0,
                 posterior_noise=torch.from_numpy(rng.normal(size=(1, 16, 16, 4))
                                                  .astype(np.float32)),
                 x_T=torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32)))
    view = views[:1]

    # 1. bf16 kernel path vs bf16 plain path, same weights
    kern = sample_atlas(ldm, view, **fixed)
    set_fused(ldm, False)
    plain = sample_atlas(ldm, view, **fixed)
    set_fused(ldm, True)
    check(bool(torch.isfinite(kern).all()), "atlas: non-finite kernel-path atlas")
    check_close(kern, plain, ATLAS_TOL, "atlas, batch 1, DDIM-4 eta 0, kernel path vs "
                "plain path (bf16; bf16 rounding of the probabilities, through 4 UNet "
                "calls)")

    # 2. fp32 plain path: card vs CPU
    torch.backends.cudnn.allow_tf32 = False
    l32 = init_latent_diffusion(seed=0, fused=False)
    cpu = sample_atlas(l32, view, device="cpu", **fixed)
    gpu = sample_atlas(l32, view, **fixed).cpu()
    del l32
    check_close(gpu, cpu, ATLAS_FP32_TOL, "atlas, fp32 card vs CPU (fp32 summation order)")

    small = dict(resolution0=16, upsampling_steps=0, chunk_size=4096)
    g32 = init_gtslice(0, route="plain")
    for lattice in (True, False):
        route = "lattice" if lattice else "gather"
        kern, _ = Reconstructor(gts, lattice_dense=lattice, **small).build_grid(feed)
        set_route(gts, "plain")
        plain, _ = Reconstructor(gts, lattice_dense=lattice, **small).build_grid(feed)
        set_route(gts, "fused")
        err = float(np.abs(kern - plain).max())
        tol = 5e-2 * max(1.0, float(np.abs(plain).max()))
        print(f"[check] GTSlice {route}: 17^3 logits, kernel path vs plain path (bf16): "
              f"max_abs_err {err:.6g}, max |plain| {np.abs(plain).max():.4g} (tolerance "
              f"{tol:.4g}: bf16 rounding flips through 3 layers and fc_out)")
        check(err <= tol, f"GTSlice {route}: kernel path disagrees with the plain path")
        cpu, _ = Reconstructor(g32, device="cpu", lattice_dense=lattice,
                               **small).build_grid(feed)
        gpu, _ = Reconstructor(g32, lattice_dense=lattice, **small).build_grid(feed)
        err = float(np.abs(cpu - gpu).max())
        tol = 1e-3 * max(1.0, float(np.abs(cpu).max()))
        print(f"[check] GTSlice {route}: 17^3 logits, fp32 card vs CPU: max_abs_err "
              f"{err:.6g} (tolerance {tol:.4g}: fp32 summation order)")
        check(err <= tol, f"GTSlice {route}: card and CPU fp32 paths disagree")
    torch.backends.cudnn.allow_tf32 = True


def check_grads(got: dict, want: dict, tol: dict, what: str) -> None:
    """Element-wise over every parameter tensor: |got - want| <= atol G +
    rtol |want|, G the largest |gradient| of the model (a tensor whose
    gradient cancels by structure, as a conv bias right before a BatchNorm,
    carries only rounding noise, so its own largest value is no scale).
    Prints the readings: the largest error in units of G, and among tensors
    whose largest gradient is at least 1% of G the largest error relative
    to that."""
    check(set(got) == set(want), f"{what}: different parameters carry gradients")
    big = max(float(w.abs().max()) for w in want.values())
    worst, worst_name, max_err, bad = 0.0, "", 0.0, 0
    for name, w in want.items():
        g, w = got[name].float().cpu(), w.float().cpu()
        err, scale = (g - w).abs(), float(w.abs().max())
        bad += int((err > tol["atol"] * big + tol["rtol"] * w.abs()).sum())
        max_err = max(max_err, float(err.max()))
        if scale >= 0.01 * big and float(err.max()) / scale > worst:
            worst, worst_name = float(err.max()) / scale, name
    print(f"[check] {what}: {len(want)} tensors, largest |gradient| G {big:.6g}, max_abs_err "
          f"{max_err:.6g} ({max_err / big:.6g} G); among tensors whose largest gradient is "
          f">= 0.01 G, largest error / that {worst:.6g} ({worst_name}); tolerance |k-p| <= "
          f"{tol['atol']}*G + {tol['rtol']}*|p|, violations {bad}")
    check(bad == 0, f"{what}: disagree")


def train_batches(n: int, b: int, g: torch.Generator, size: int = 128):
    """``n`` seeded synthetic batches in [-1, 1], made on the card."""
    return [{"image": torch.rand((b, 13, size, size, 3), generator=g, device="cuda") * 2 - 1,
             "img_ipt_view": torch.rand((b, size, size, 3), generator=g, device="cuda") * 2 - 1}
            for _ in range(n)]


def phase_training():
    """LDM training at the config's widths: ``LDMTrainer`` on a bf16 model
    (fp32 master weights, AdamW, EMA, train-mode BatchNorm in the
    conditioner), ``maybe_set_scale``, warm-up steps, then timed steps with
    the launch counts read around them."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    trainer = LDMTrainer(module=init_latent_diffusion(seed=0, dtype=torch.bfloat16))
    state = trainer.init_state()
    print(f"[train] LDMTrainer: batch {trainer.batch_size}, lr {trainer.lr:g}, "
          f"accumulate {trainer.accumulate}, EMA {trainer.use_ema}, scale_by_std "
          f"{trainer.scale_by_std}, learn_logvar {trainer.learn_logvar}")
    g = torch.Generator(device="cuda").manual_seed(11)
    batches = train_batches(TRAIN_WARMUP + TRAIN_STEPS, TRAIN_BATCH, g)
    trainer.maybe_set_scale(state, batches[0], g)
    for batch in batches[:TRAIN_WARMUP]:
        trainer.train_step(state, batch, g)
    torch.cuda.synchronize()

    ldm = state.ldm

    def snap(named):
        return {n: t.detach().clone() for n, t in named}

    vae0 = snap(ldm.first_stage_model.named_parameters())
    net0 = snap((n, p) for n, p in ldm.named_parameters() if n in state.ema)
    ema0 = snap(state.ema.items())
    bn0 = snap((n, b) for n, b in ldm.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    logvar0 = state.logvar.clone()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logs = []
    t0 = time.perf_counter()
    for batch in batches[TRAIN_WARMUP:]:
        logs.append(trainer.train_step(state, batch, g)[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [{k: float(v) for k, v in step.items()} for step in logs]
    print(f"[train] {TRAIN_STEPS} steps of batch {TRAIN_BATCH}: {step_ms:.4f} ms per step; "
          f"peak memory {peak_gb:.4f} GB; launches {counts} "
          f"({counts['spatial_attention'] / TRAIN_STEPS:g} forward and "
          f"{counts['spatial_attention_bwd'] / TRAIN_STEPS:g} backward attention per step)")
    for i, step in enumerate(losses):
        print(f"[train] step {TRAIN_WARMUP + i}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(step.items())))
    check(counts["spatial_attention"] == 10 * TRAIN_STEPS,
          f"spatial_attention launched {counts['spatial_attention']} times, expected 10 x "
          f"{TRAIN_STEPS}")
    check(counts["spatial_attention_bwd"] == 10 * TRAIN_STEPS,
          f"spatial_attention_bwd launched {counts['spatial_attention_bwd']} times, expected "
          f"10 x {TRAIN_STEPS}")
    check(all(np.isfinite(v) for step in losses for v in step.values()), "a loss is not finite")
    check(all(torch.equal(p, vae0[n]) for n, p in ldm.first_stage_model.named_parameters()),
          "the frozen VAE's parameters changed")
    # every trained tensor moves but the conditioner's last BatchNorm, which
    # feeds no output (weight decay alone moves a weight by < 1 fp32 ulp)
    live = [n for n in net0 if ".conv_last." not in n]
    params = dict(ldm.named_parameters())
    moved = sum(not torch.equal(params[n], net0[n]) for n in live)
    ema_moved = sum(not torch.equal(state.ema[n], ema0[n]) for n in live)
    bn_moved = sum(not torch.equal(b, bn0[n]) for n, b in ldm.named_buffers()
                   if n in bn0 and ".conv_last." not in n)
    n_bn = sum(".conv_last." not in n for n in bn0)
    print(f"[train] moved over the timed steps: {moved} / {len(live)} UNet and conditioner "
          f"tensors, {ema_moved} / {len(live)} EMA tensors, {bn_moved} / {n_bn} BatchNorm "
          f"statistics; logvar max |.| {float(state.logvar.abs().max()):g}")
    check(moved == len(live), "a trained parameter did not move")
    check(ema_moved == len(live), "the EMA did not move")
    check(bn_moved == n_bn, "a BatchNorm's running statistics did not move")
    check(torch.equal(state.logvar, logvar0), "logvar moved without learn_logvar")
    return {"step_ms": step_ms, "peak_gb": peak_gb, "steps": TRAIN_STEPS,
            "batch": TRAIN_BATCH, "losses": losses, "counts": counts}, trainer, state


def phase_training_checks(trainer, state):
    """Small inputs on the card: one step's gradients at batch 1, kernel path
    vs plain path (bf16, full width), and the fp32 plain path card vs CPU on
    the tiny configuration."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer, trainable_parameters

    def grads(tr, st, batch, draws):
        st.optimizer.zero_grad(set_to_none=True)
        logs = tr.loss_and_grads(st, batch, draws=draws)
        return ({k: float(v) for k, v in logs.items()},
                {n: p.grad.clone() for n, p in trainable_parameters(st.ldm).items()
                 if p.grad is not None})

    # 1. bf16, batch 1, full width: kernel path vs plain path, same weights
    rng = np.random.default_rng(8)
    batch = {"image": rng.uniform(-1, 1, (1, 13, 128, 128, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)}
    draws = {"posterior_noise": rng.normal(size=(1, 13, 16, 16, 4)).astype(np.float32),
             "t": np.array([500]), "noise": rng.normal(size=(1, 64, 64, 4)).astype(np.float32)}
    reset_counts()
    k_logs, kern = grads(trainer, state, batch, draws)
    counts = read_counts()
    check(counts["spatial_attention"] == 10 and counts["spatial_attention_bwd"] == 10,
          f"the kernel path's step launched {counts}")
    set_fused(state.ldm, False)
    p_logs, plain = grads(trainer, state, batch, draws)
    set_fused(state.ldm, True)
    print(f"[check] training step, batch 1 (bf16): kernel path losses {k_logs}, plain path "
          f"{p_logs}")
    check(all(abs(k_logs[k] - p_logs[k]) <= LOSS_RTOL * abs(p_logs[k]) for k in p_logs),
          "training step losses: kernel path and plain path disagree")
    check_grads(kern, plain, GRAD_TOL, "training step gradients, batch 1, kernel path vs "
                "plain path (bf16)")
    del kern, plain
    state.optimizer.zero_grad(set_to_none=True)

    # 2. fp32 plain path: card vs CPU, tiny configuration (the CPU tests hold
    # the CPU's against the JAX package)
    torch.backends.cudnn.allow_tf32 = False
    tiny = init_latent_diffusion(seed=1, fused=False, **TRAIN_TINY)
    rng = np.random.default_rng(9)
    batch = {"image": rng.uniform(-1, 1, (2, 13, 16, 16, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)}
    draws = {"posterior_noise": rng.normal(size=(2, 13, 8, 8, 4)).astype(np.float32),
             "t": np.array([3, 17]), "noise": rng.normal(size=(2, 32, 32, 4)).astype(np.float32)}
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = LDMTrainer(img_size=16, batch_size=2, timesteps=20, module=tiny, device=dev)
        runs[dev] = grads(tr, tr.init_state(), batch, draws)
    torch.backends.cudnn.allow_tf32 = True
    (c_logs, cpu), (g_logs, gpu) = runs["cpu"], runs["cuda"]
    print(f"[check] training step, tiny fp32: card losses {g_logs}, CPU {c_logs}")
    check(all(abs(g_logs[k] - c_logs[k]) <= 1e-5 * abs(c_logs[k]) for k in c_logs),
          "training step losses: card and CPU fp32 paths disagree")
    check_grads(gpu, cpu, GRAD_FP32_TOL, "training step gradients, tiny, fp32 card vs CPU "
                "(fp32 summation order)")


def serving_pngs(n: int, seed: int = 12):
    """``n`` seeded 128x128 RGBA PNGs (the port's own encoder): noise colours,
    an opaque off-centre box of random size on a transparent background."""
    from slice3d_tpu_torch.data.image import encode_png

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arr = rng.integers(0, 256, (128, 128, 4), dtype=np.uint8)
        arr[..., 3] = 0
        y0, x0 = rng.integers(4, 40, 2)
        h, w = rng.integers(48, 84, 2)
        arr[y0:y0 + h, x0:x0 + w, 3] = 255
        out.append(encode_png(arr))
    return out


def percentile(values, p: float) -> float:
    """The service's own rule (``serving_stats``): the sorted value at
    index int(p n)."""
    v = sorted(values)
    return v[min(int(p * len(v)), len(v) - 1)]


def phase_serving(model):
    """The port's service over HTTP in-process: 8 concurrent requests at
    mc_batch_size 4, then the same images one at a time at batch 1."""
    from http.server import ThreadingHTTPServer

    from slice3d_tpu_torch import serve
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.data.dataset import preprocess_image
    from slice3d_tpu_torch.data.image import center_rgba, decode_png
    from slice3d_tpu_torch.mesh import obj_string

    bodies = serving_pngs(SERVE_REQUESTS)
    proj = make_feeds(1)[0]["trans_mat_wo_rot_tp"]  # the service's identity camera
    imgs = [preprocess_image(center_rgba(decode_png(b)), SERVE_POINT["img_size"], False)
            for b in bodies]
    # random weights: the iso level at the median coarse logit of the first
    # image (a res0 16 probe on the same seeded weights), so surfaces exist
    threshold = probe_threshold(model, {"img_input": imgs[0], "trans_mat_wo_rot_tp": proj})
    opts = Options(name_model="slicenet", dtype="bfloat16", random_init=True,
                   mc_batch_size=SERVE_BATCH, mc_threshold=threshold, **SERVE_POINT)
    service = serve.build_service(opts, batch_window_ms=SERVE_WINDOW_MS)
    check(all(torch.equal(a, b) for a, b in zip(service.recon.model.state_dict().values(),
                                                 model.state_dict().values())),
          "the service's seeded weights differ from the main path's")
    t0 = time.perf_counter()
    service.warmup()
    warm_s = time.perf_counter() - t0
    calls = []
    batch_fn = service.recon.reconstruct_batch

    def counted(feeds):
        calls.append(len(feeds))
        return batch_fn(feeds)

    service.recon.reconstruct_batch = counted
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * SERVE_REQUESTS

    def request(i):  # OBJ text, stats in the header; parsed after all have ended
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        t = time.perf_counter()
        conn.request("POST", "/reconstruct", body=bodies[i])
        resp = conn.getresponse()
        payload = resp.read()
        answers[i] = (resp.status, resp.getheader("X-Slice3D-Stats"), payload,
                      time.perf_counter() - t)
        conn.close()

    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=request, args=(i,)) for i in range(SERVE_REQUESTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(not any(c.is_alive() for c in clients), "a request did not finish")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    lat, batched = [], []
    for i, (status, header, payload, dt) in enumerate(answers):
        check(status == 200, f"request {i}: HTTP {status}: {payload[:200]!r}")
        stats = json.loads(header)
        verts = payload.count(b"\nv ") + payload.startswith(b"v ")
        lat.append(dt)
        batched.append((stats["n_points_evaluated"], verts))
        print(f"[serve] request {i}: latency {dt:.4f} s, n_points_evaluated "
              f"{stats['n_points_evaluated']}, vertices {verts}, OBJ {len(payload) / 1e6:.2f} "
              f"MB; its batch: eval {stats['time_eval_points']:.4f} s, its marching "
              f"{stats['time_marching']:.4f} s")
    p50, p90 = percentile(lat, 0.5), percentile(lat, 0.9)
    rps = SERVE_REQUESTS / wall
    print(f"[serve] {SERVE_REQUESTS} requests at concurrency {SERVE_REQUESTS}, mc_batch_size "
          f"{SERVE_BATCH}, window {SERVE_WINDOW_MS:g} ms: p50 {p50:.4f} s, p90 {p90:.4f} s, "
          f"{rps:.4f} requests/s ({wall:.4f} s wall); reconstruct_batch calls "
          f"{len(calls)} of sizes {calls}; warm-up {warm_s:.4f} s; launches {counts}")
    check(counts["fused_encoder_layer"] > 0, "the serving path launched no fused_encoder_layer")
    check(sum(calls) == SERVE_BATCH * len(calls) and len(calls) < SERVE_REQUESTS,
          f"requests were not batched: {calls}")

    # the first 4 images as one batch without HTTP, and the OBJ text of a mesh
    feeds = [{"img_input": img, "trans_mat_wo_rot_tp": proj} for img in imgs]
    torch.cuda.synchronize()
    t = time.perf_counter()
    direct = batch_fn(feeds[:SERVE_BATCH])
    direct_s = time.perf_counter() - t
    t = time.perf_counter()
    text = obj_string(direct[0][0])
    obj_s = time.perf_counter() - t
    print(f"[serve] reconstruct_batch of requests 0-{SERVE_BATCH - 1} without HTTP: "
          f"{direct_s:.4f} s (eval {direct[0][1]['time_eval_points']:.4f} s, marching "
          f"{sum(st['time_marching'] for _, st in direct):.4f} s for {SERVE_BATCH}); "
          f"obj_string of request 0's mesh: {obj_s:.4f} s for {len(text) / 1e6:.2f} MB")
    del direct, text

    # the same images one at a time (batch 1) through the same Reconstructor
    serial, serial_lat = [], []
    for feed in feeds:
        torch.cuda.synchronize()
        t = time.perf_counter()
        mesh, stats = service.recon.reconstruct(feed)
        serial_lat.append(time.perf_counter() - t)
        serial.append((stats["n_points_evaluated"], len(mesh.vertices)))
    worst = 0.0
    for i, ((bn, bv), (sn, sv)) in enumerate(zip(batched, serial)):
        rel = max(abs(bn - sn) / sn, abs(bv - sv) / max(sv, 1))
        worst = max(worst, rel)
        print(f"[serve] request {i}: batched n_points {bn} / vertices {bv}, batch 1 {sn} / "
              f"{sv} ({serial_lat[i]:.4f} s), relative difference {rel:.6g}")
    print(f"[check] serving: batched (B {SERVE_BATCH}) vs batch-1 answers, largest relative "
          f"difference of n_points_evaluated and vertex counts {worst:.6g} (tolerance "
          f"{SERVE_RTOL}: bf16 convolutions at batch 4 round otherwise)")
    check(worst <= SERVE_RTOL, "batched and batch-1 answers disagree")
    check(all(n > (opts.mc_res0 + 1) ** 3 for n, _ in batched),
          "the refinement levels did not run")
    result = {"p50_s": p50, "p90_s": p90, "requests_per_s": rps, "wall_s": wall,
              "latency_s": lat, "reconstruct_batch_calls": calls,
              "serial_latency_s": serial_lat, "batched_vs_serial_rel": worst,
              "warmup_s": warm_s, "threshold": threshold, "direct_batch_s": direct_s,
              "obj_string_s": obj_s}
    return result, counts, proj, imgs[:2]


def phase_split(proj, imgs, threshold):
    """The same seeded weights on the split-encoder route: 2 requests at
    the serving point, the launch counts read around them."""
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.pipeline import Reconstructor

    model = init_slicenet(seed=0, dtype=torch.bfloat16, route="split").to("cuda")
    rec = Reconstructor(model, resolution0=SERVE_POINT["mc_res0"],
                        upsampling_steps=SERVE_POINT["mc_up_steps"],
                        chunk_size=SERVE_POINT["mc_chunk_size"], threshold=threshold)
    heads = []
    hook = model.att_decoder.register_forward_hook(lambda *args: heads.append(1))
    rec.reconstruct({"img_input": imgs[0], "trans_mat_wo_rot_tp": proj})  # warm-up
    heads.clear()
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for i, img in enumerate(imgs):
        t = time.perf_counter()
        mesh, stats = rec.reconstruct({"img_input": img, "trans_mat_wo_rot_tp": proj})
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        print(f"[split] request {i}: latency {lat[-1]:.4f} s, n_points_evaluated "
              f"{stats['n_points_evaluated']}, vertices {len(mesh.vertices)}")
        check(not mesh.is_empty and bool(np.isfinite(mesh.vertices).all()),
              "split route: empty mesh or non-finite vertices")
    counts = read_counts()
    hook.remove()
    print(f"[split] launches over {len(imgs)} requests: {counts}; head calls {len(heads)} "
          f"({counts['fused_ffn'] / max(len(heads), 1):g} fused_ffn launches per head call)")
    check(counts["fused_encoder_layer"] == 0, "the split route launched the encoder kernel")
    check(counts["fused_ffn"] == 3 * len(heads) and heads,
          "the split route did not launch fused_ffn exactly 3 times per head call")
    return {"latency_s": lat, "head_calls": len(heads)}, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from slice3d_tpu_torch.models.slicenet import init_slicenet

    kind = torch.cuda.get_device_name(0)

    def smi(query: str) -> str:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]

    clock = float(smi("clocks.max.sm").split()[0])  # "1980 MHz"
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"max SM clock {clock:.0f} MHz")
    print(smi("name,power.limit"))

    t_start = time.perf_counter()
    phase_build()
    model = init_slicenet(seed=0, dtype=torch.bfloat16).to("cuda")
    modes = phase_kernels(model)
    ffn_modes = phase_ffn(model)
    attn_modes = phase_attention(clock * 1e6)
    main_counts, rec, feeds = phase_main_path(model)
    gen, ldm, gts, views, gen_feeds = phase_generation()
    phase_correctness(model, rec, feeds[0])
    phase_split_checks(model, feeds[0])
    phase_generation_checks(ldm, gts, views, gen_feeds[0])
    del ldm, gts, model, rec
    bwd_modes = phase_attention_bwd(clock * 1e6)
    train, trainer, state = phase_training()
    phase_training_checks(trainer, state)
    del trainer, state
    model = init_slicenet(seed=0, dtype=torch.bfloat16).to("cuda")
    serving, serve_counts, proj, imgs = phase_serving(model)
    split, split_counts = phase_split(proj, imgs, serving["threshold"])
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")

    by_path = {"regression": main_counts, "generation": gen["counts"],
               "training": train["counts"], "serving": serve_counts, "split": split_counts}
    full = modes[0]
    encoder = {"name": "fused_encoder_layer", "route": "cuda",
               "source": "slice3d_tpu_torch/csrc/fused_encoder.cu",
               "replaces": "slice3d_tpu/ops/pallas_encoder.py:463",
               "launches": sum(c["fused_encoder_layer"] for c in by_path.values()),
               "launches_by_path": {k: c["fused_encoder_layer"] for k, c in by_path.items()},
               "max_abs_err": max(m["max_abs_err"] for m in modes),
               "tol": f"|k-p| <= {TOL['atol']} + {TOL['rtol']}*|p|",
               "ms": full["ms"], "kernel_ms": full["ms"], "plain_ms": full["plain_ms"],
               "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
               "library_ms": full["library_ms"], "modes": modes}
    ds1 = attn_modes[0]
    attention = {"name": "spatial_attention", "route": "cuda",
                 "source": "slice3d_tpu_torch/csrc/spatial_attention.cu",
                 "replaces": "slice3d_tpu/ops/pallas_attention.py:59",
                 "launches": sum(c["spatial_attention"] for c in by_path.values()),
                 "launches_by_path": {k: c["spatial_attention"] for k, c in by_path.items()},
                 "max_abs_err": max(m["max_abs_err"] for m in attn_modes),
                 "tol": f"|k-p| <= {ATTN_TOL['atol']} + {ATTN_TOL['rtol']}*|p|",
                 "ms": ds1["ms"], "kernel_ms": ds1["ms"], "plain_ms": ds1["plain_ms"],
                 "bound_ms": ds1["bound_ms"],
                 "bound_by": "bytes" if ds1["bound_by"] == "bytes" else "operations",
                 "library_ms": ds1["library_ms"], "modes": attn_modes}
    bwd1 = bwd_modes[0]
    attention_bwd = {"name": "spatial_attention_bwd", "route": "cuda",
                     "source": "slice3d_tpu_torch/csrc/spatial_attention_bwd.cu",
                     "replaces": "slice3d_tpu/ops/pallas_attention.py:150",
                     "launches": sum(c["spatial_attention_bwd"] for c in by_path.values()),
                     "launches_by_path": {k: c["spatial_attention_bwd"]
                                          for k, c in by_path.items()},
                     "max_abs_err": max(m["max_abs_err"] for m in bwd_modes),
                     "tol": f"|k-p| <= {ATTN_BWD_TOL['atol']} + {ATTN_BWD_TOL['rtol']}*|p|",
                     "ms": bwd1["ms"], "kernel_ms": bwd1["ms"], "plain_ms": bwd1["plain_ms"],
                     "bound_ms": bwd1["bound_ms"],
                     "bound_by": "bytes" if bwd1["bound_by"] == "bytes" else "operations",
                     "library_ms": bwd1["library_ms"], "modes": bwd_modes}
    full_ffn = ffn_modes[0]
    ffn = {"name": "fused_ffn", "route": "cuda", "source": "slice3d_tpu_torch/csrc/fused_ffn.cu",
           "replaces": "slice3d_tpu/ops/pallas_ffn.py:49",
           "launches": sum(c["fused_ffn"] for c in by_path.values()),
           "launches_by_path": {k: c["fused_ffn"] for k, c in by_path.items()},
           "max_abs_err": max(m["max_abs_err"] for m in ffn_modes),
           "tol": f"|k-p| <= {FFN_TOL['atol']} + {FFN_TOL['rtol']}*|p|",
           "ms": full_ffn["ms"], "kernel_ms": full_ffn["ms"], "plain_ms": full_ffn["plain_ms"],
           "bound_ms": full_ffn["bound_ms"], "bound_by": full_ffn["bound_by"],
           "library_ms": full_ffn["library_ms"], "modes": ffn_modes}
    print(json.dumps({"generation": {k: v for k, v in gen.items() if k != "counts"},
                      "training": {k: v for k, v in train.items() if k != "counts"},
                      "serving": serving, "split": split}))
    print(json.dumps({"kernels": [encoder, attention, attention_bwd, ffn]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
