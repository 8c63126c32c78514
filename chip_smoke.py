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
     the two head kernels also print achieved TFLOP/s, the share of the
     bound, the weight bytes each call fetches from L2 (counted from the
     tiling, not read from the card) and the resident blocks per SM (the
     occupancy API's answer);
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
     the images, 0 encoder launches and 3 fused_ffn launches per head call;
 11. the regression route's options through the port's CLIs at the serving
     point, on a 3-object dataset this phase writes into ``_smoke/`` (and
     removes) with an analytic sphere as ground truth: ``reconstruct
     --est_campose`` on SliceNet (CameraNet, seeded weights; the fused
     route, launches counted), simplification to 10,000 faces at res0 32 /
     up 1, the polish of one object at the serving point (30 steps at one
     draw table; its loss must fall) with a patch of that mesh polished in
     fp32 on the card and on the CPU as its witness, DISN with
     ``--est_campose`` at batch 1 and at ``mc_batch_size`` 2 (answers within
     1e-2), one object by marching tetrahedra, the DISN service over HTTP,
     and ``python -m slice3d_tpu_torch.eval`` with ICP at 100,000 points on
     the card, then card against CPU at 5,000 points with and without ICP;
 12. the generation route's on-disk CLIs: spatial_attention against its plain
     version at the guided batch, (16, 8, 4096, 24) and (16, 8, 1024, 48);
     then on a dataset of 8 objects x 12 views written into ``_smoke/`` (and
     removed) with a full-width seeded LDM saved as a port checkpoint,
     ``python -m slice3d_tpu_torch.main`` with
     configs/objaverse-ldm-kl-8-infer.yaml: DDIM-200 eta 1, DPM-20, PLMS-50,
     DDIM-50 at guidance 3 (one UNet call of batch 16 a step), the 1,000-step
     ancestral chain and ``--mode rec`` (96 VAE round trips), each with its
     exact attention launches and s per batch of 8; ``re_org_slices`` on the
     DDIM montages, the GTSlice reconstruct CLI on the generated slices at
     the serving point (8 OBJ files), SliceNet's slice dump (96 PNGs of 256
     px); ms per UNet call at batch 8 and 16; and small-input checks of each
     new sampler (kernel vs plain path in bf16 at full width, fp32 card vs
     CPU on the tiny configuration);
 13. regression training at the configs' widths (n_bs 16, img 128, 256
     queries, 12 slices) on batches made on the card: SliceNet with the VGG19
     perceptual term (seeded weights in torchvision's layout) in fp32 and in
     bf16, GTSlice from GT slices and CameraNet, each 2 warm-up and 10 timed
     steps (ms per step p50 / min / max, peak memory, the card's name and
     power limit), with the checks: finite losses, every parameter with a
     nonzero gradient moved, VGG19 bitwise unchanged, the running statistics
     moved, the LR of every update the schedule's, no head kernel launched;
     one tiny fp32 step of each trainer on the card and on the CPU, which
     must agree with TF32 off and must not with TF32 on (the tolerance's
     control); then on a synthetic dataset of 16 objects x 12 views of 128 px
     written into ``_smoke/`` (and removed): ``python -m
     slice3d_tpu_torch.train`` for one epoch and again with ``--resume``, with
     ``--device_preprocess``, ``train_gt`` and ``train_cam``, and the
     reconstruct CLI on one object from the SliceNet checkpoint trained there,
     one fused_encoder_layer launch for each encoder layer its head runs.
The last three lines are the paths' JSON record, the kernels' JSON record
and the run's status JSON.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import glob
import http.client
import io
import json
import os
import pickle
import re
import shutil
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
# the same at guidance scale s = 3: eps = 3 e_c - 2 e_u carries each branch's
# bf16 error up to 2s - 1 = 5 times over, so 5 x ATLAS_TOL (readings on an
# NVIDIA H100 80GB HBM3 at 700 W, DDIM-4 eta 1, batch 1: largest error 0.457
# at |p| 24, 0.362 where |p| < 1, against |p| up to 47; unguided PLMS-4 and
# DPM-4 read 0.056 and 0.060, within ATLAS_TOL)
GUIDED_ATLAS_TOL = dict(atol=1.0, rtol=0.05)
GEN_BATCH, GEN_STEPS = 8, 200
# the regression route's options (phase 11): 3 objects at the serving point,
# the polish after simplification, the eval CLI at 100,000 points on the card
# and, against the CPU's plain computation (the JAX package's arithmetic),
# at 5,000: Chamfer-L1/L2 to relative 1e-5 and threshold counts within one
# point without ICP; with ICP, whose correspondences can break a near tie
# the other way between the two, Chamfer and Hausdorff to relative 1e-3 and
# counts and IoU within 1e-3
OPT_OBJECTS = 3
# simplification at res0 32 / up 1: at the serving point these random-weight
# meshes have ~970,000 faces, on which the JAX package's quadric simplifier
# (copied bit for bit) did not end in 13 minutes
OPT_SIMPLIFY, OPT_SIMPLIFY_POINT = 10000, (32, 1)
# the polish at the serving point, one object, at the reference's 30 steps,
# every step at one Dirichlet draw table so that the step losses compare:
# RMSprop's first step (second moment from 0) moves a coordinate by up to
# lr / sqrt(0.1) and raises this loss, the later steps bring it down
# (readings on an NVIDIA H100 80GB HBM3 at 700 W, the 966,844-face mesh:
# +3.4% after the first step, then -0.2% a step; at step 9 still 1.8% above
# the start, below it from step 19, -2.0% at step 29)
OPT_REFINE_STEPS, OPT_DRAW_SEED = 30, 5
# the witness: a patch of the nearest faces of that mesh, polished in fp32 on
# the card and on the CPU (the CPU tests hold the CPU's polish against the
# JAX package's); the tolerance as in tests/test_torch_cuda.py's polish case
# for the vertices, and the losses to relative 2e-3 (readings on the H100
# with cuDNN's TF32 convolutions in the encoder: vertices 6.4e-4, losses
# 1.7e-3 relative; with them off, as the witness runs: 5.9e-4 and 4.3e-4)
WITNESS_FACES, WITNESS_STEPS, WITNESS_ATOL, WITNESS_LOSS_RTOL = 4000, 10, 1e-3, 2e-3
EVAL_PTS, EVAL_CHECK_PTS = 100000, 5000
EVAL_RTOL, EVAL_ICP_RTOL, EVAL_ICP_ATOL = 1e-5, 1e-3, 1e-3
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke")
# the generation CLIs (phase 12): GENCLI_OBJECTS objects (one batch of the
# config's 8), each run's exact attention launches (10 a UNet call; PLMS-50
# calls the UNet 51 times, its step 0 twice; guidance runs one call of batch
# 2B a step) and the batch every launch must have; the ancestral chain walks
# all 1,000 steps
GENCLI_OBJECTS = 8
GENCLI_RUNS = (("ddim", [], 10 * 200, 8),
               ("dpm", ["--sampler", "dpm", "--ddim_steps", "20"], 10 * 20, 8),
               ("plms", ["--sampler", "plms", "--ddim_steps", "50", "--ddim_eta", "0"],
                10 * 51, 8),
               ("guided", ["--ddim_steps", "50", "--guidance_scale", "3.0"], 10 * 50, 16),
               ("ancestral", ["--sampler", "ancestral"], 10 * 1000, 8),
               ("rec", ["--mode", "rec"], 0, 8))
GENCLI_CHECK_T = 8  # the ancestral chain of the small-input checks: its lowest 8 steps
GENCLI_CHECK_NAMES = {"plms": "PLMS-4", "dpm": "DPM-4",
                      "ancestral": f"ancestral chain over its lowest {GENCLI_CHECK_T} steps",
                      "guided": "DDIM-4 eta 1 at guidance 3 (one 2B call a step)"}
GUIDED_ATTN_SHAPES = ((16, 8, 4096, 24), (16, 8, 1024, 48))  # the guided 2B batch
# regression training (phase 13) at the configs' widths: n_bs 16 of 128 px,
# 256 queries, 12 slices, 2 warm-up then 10 timed steps a trainer, 5 steps an
# epoch and freq_decay 1 so that the timed steps cross two LR decays; the VGG
# trunk's last BatchNorm feeds no output and does not run
REG_BATCH, REG_IMG, REG_QRY, REG_WARMUP, REG_STEPS = 16, 128, 256, 2, 10
REG_STEPS_PER_EPOCH = 5
REG_UNUSED_BN = ("slices_generator.down5_.", "img_encoder.conv_last.")
REG_CLI_SHAPES = 16  # one batch of 16 an epoch
# one tiny fp32 step (img 32, batch 2) card vs CPU: logs to relative 5e-6,
# gradients element-wise to 1e-3 G + 1e-3 |cpu|, G the model's largest
# |gradient| (fp32 summation order through the U-Net, VGG16-BN, VGG19 and the
# head), where at most 1e-4 of a tensor may exceed it (a max-pool near-tie
# routes a gradient to another pixel, as the CPU tests saw move five elements
# of a GTSlice conv by 7e-4 against the JAX package).  Readings on the H100
# with TF32 off: logs 1.4e-6 relative, gradients 2.4e-4 G (1.8e-4 G with the
# near-ties set aside) for SliceNet, 2.4e-7 and 4.4e-5 G for GTSlice, 8.7e-8
# and 1.0e-5 G for CameraNet; with TF32 on (cuDNN and matmul), which the
# phase runs as a control that must fail: logs 7.6e-5 to 3.9e-4, gradients
# 7.8e-3 to 0.10 G
REG_LOSS_RTOL = 5e-6
REG_GRAD_FP32_TOL = dict(atol=1e-3, rtol=1e-3)
REG_TIE_FRAC = 1e-4
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


def kernel_rates(ms: float, flops: int, bound_ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound of a kernel timed at ms."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


def resident_blocks(query, *args) -> int:
    """Blocks of a kernel an SM holds at once, from its library's query."""
    blocks = ctypes.c_int()
    check(query(*args, ctypes.byref(blocks)) == 0, "occupancy query failed")
    return blocks.value


def phase_kernels(model):
    """fused_encoder_layer against its plain version at N = 33,800 points of
    13 tokens, both head_tokens."""
    from slice3d_tpu_torch.ops import fused_encoder as fe

    g = torch.Generator(device="cuda").manual_seed(1)
    layers = model.att_decoder.layers
    lib = fe.library()
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
        bound = max(t_ops, t_bytes)
        rates = kernel_rates(ms, flops, bound)
        grid = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[kernel] fused_encoder_layer head_tokens={head_tokens}: "
              f"{rates['tflops']:.1f} TFLOP/s, {100 * rates['bound_share']:.1f}% of the bound, "
              f"L2 weight bytes per call (counted from the tiling) "
              f"{fe.weight_bytes_per_call(N_POINTS, 13, head_tokens, grid=grid) / 1e9:.4f} GB, "
              f"{resident_blocks(lib.s3d_fused_encoder_blocks_per_sm, head_tokens)} resident "
              f"block(s) per SM, {grid} blocks")
        modes.append({"head_tokens": head_tokens, "n_points": N_POINTS,
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **rates})
        print(f"[kernel] head_tokens={head_tokens}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms} ms, bound "
              f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
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
    lib = ff.library()
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
        bound = max(t_ops, t_bytes)
        rates = kernel_rates(ms, flops, bound)
        print(f"[kernel] fused_ffn N={n}: {rates['tflops']:.1f} TFLOP/s, "
              f"{100 * rates['bound_share']:.1f}% of the bound, L2 weight bytes per call "
              f"(counted from the tiling: {ff.TILE_ROWS}-row tiles) "
              f"{ff.weight_bytes_per_call(n) / 1e9:.4f} GB, "
              f"{resident_blocks(lib.s3d_fused_ffn_blocks_per_sm)} resident block(s) per SM")
        modes.append({"n_rows": n, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **rates})
        print(f"[kernel] fused_ffn N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(F.linear -> relu -> F.linear, bf16) {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
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


def phase_attention(sm_clock_hz: float, shapes=ATTN_SHAPES):
    from slice3d_tpu_torch.ops import spatial_attention as sa

    g = torch.Generator(device="cuda").manual_seed(2)
    modes = []
    for shape in shapes:
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


def write_options_dataset(root: str, bodies, sphere_r: float = 0.3, name: str = "opts",
                          views=(4,), slices: bool = False) -> str:
    """A dataset tree for the CLIs: each PNG as each of ``views`` (view 004
    by default) of an object with the service's identity camera in every
    view, all objects in the test and trainval splits and the first in the
    val split; with ``slices``, 12 seeded noise RGBA slices of 128 px for
    each of those views (01_img_slices, the LDM dataset's targets); and the
    analytic ground truth the eval CLI reads, a sphere of radius
    ``sphere_r``: its 02_sdfs samples (a surface band and volume points) and
    its mesh as <id>.obj in ``root``/gt.  Returns the directory of GT
    meshes."""
    from slice3d_tpu_torch.data.dataset import SLICE_ORDER
    from slice3d_tpu_torch.data.image import encode_png
    from slice3d_tpu_torch.mesh import Mesh, export_obj, isosurface

    ds = os.path.join(root, "data", name)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(os.path.join(ds, "03_splits"))
    os.makedirs(os.path.join(ds, "02_sdfs"))
    os.makedirs(gt_dir)
    lin = np.linspace(-0.5, 0.5, 129, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = isosurface(sphere_r - np.sqrt(x * x + y * y + z * z), 0.0)
    sphere = Mesh((sphere.vertices / 128 - 0.5).astype(np.float32), sphere.faces)
    rng = np.random.default_rng(31)
    ids = [f"{i:05d}" for i in range(len(bodies))]
    for sid, body in zip(ids, bodies):
        vdir = os.path.join(ds, "00_img_input", sid)
        os.makedirs(vdir)
        for view in views:
            with open(os.path.join(vdir, f"{view:03d}.png"), "wb") as f:
                f.write(body)
            if slices:
                sdir = os.path.join(ds, "01_img_slices", sid, f"{view:03d}")
                os.makedirs(sdir)
                for axis, part in SLICE_ORDER:
                    with open(os.path.join(sdir, f"{axis}_{part}.png"), "wb") as f:
                        f.write(encode_png(rng.integers(0, 256, (128, 128, 4), dtype=np.uint8)))
        with open(os.path.join(vdir, "meta.pkl"), "wb") as f:
            pickle.dump([np.zeros((3, 3)), np.zeros(12), np.zeros(12), np.full(12, 1.2),
                         np.zeros((12, 3, 4)), 1.0, np.zeros(3)], f)
        d = rng.normal(size=(20000, 3))
        surf = sphere_r * d / np.linalg.norm(d, axis=1, keepdims=True)
        pts = np.concatenate([surf + rng.normal(0, 0.003, surf.shape),
                              rng.uniform(-0.5, 0.5, (20000, 3))])
        sdf = np.linalg.norm(pts, axis=1) - sphere_r
        np.save(os.path.join(ds, "02_sdfs", f"{sid}.npy"),
                np.concatenate([pts, sdf[:, None]], 1).astype(np.float32))
        export_obj(sphere, os.path.join(gt_dir, f"{sid}.obj"))
    for split in ("test", "trainval"):
        with open(os.path.join(ds, "03_splits", f"{split}.lst"), "w") as f:
            f.write("\n".join(ids) + "\n")
    with open(os.path.join(ds, "03_splits", "val.lst"), "w") as f:
        f.write(ids[0] + "\n")
    return gt_dir


_OBJECT_LINE = re.compile(
    r"\] (\S+): (\d+) verts, (\d+) faces \(eval ([\d.]+)s over (\d+) pts, mc ([\d.]+)s"
    r"(?:, refine ([\d.]+)s, loss (\S+) -> (\S+))?\)")


class _Tee(io.StringIO):
    """Keeps what is written and echoes each finished line under a tag."""

    def __init__(self, tag: str, out):
        super().__init__()
        self.tag, self.out, self.part = tag, out, ""

    def write(self, text: str) -> int:
        super().write(text)
        *lines, self.part = (self.part + text).split("\n")
        for line in lines:
            self.out.write(f"[{self.tag}] {line}\n")
        self.out.flush()
        return len(text)


def run_cli(tag: str, main, argv):
    """Run a CLI's ``main(argv)`` with its standard output kept and echoed
    under ``tag`` as it goes; returns (its return value, the objects it
    reported, seconds)."""
    out = _Tee(tag, sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    text = out.getvalue()
    objects = []
    for m in _OBJECT_LINE.finditer(text):
        obj = {"id": m[1], "vertices": int(m[2]), "faces": int(m[3]),
               "time_eval_points": float(m[4]), "n_points_evaluated": int(m[5]),
               "time_marching": float(m[6])}
        if m[7] is not None:
            obj.update(time_refine=float(m[7]), refine_loss_first=float(m[8]),
                       refine_loss_last=float(m[9]))
        objects.append(obj)
    print(f"[{tag}] {dt:.4f} s in all")
    return ret, objects, dt


def check_objects(tag: str, objects, n: int) -> None:
    check(len(objects) == n, f"{tag}: {len(objects)} objects reported, expected {n}")
    for o in objects:
        check(o["faces"] > 0, f"{tag}: object {o['id']} has an empty mesh")
        check(o["n_points_evaluated"] > (SERVE_POINT["mc_res0"] + 1) ** 3,
              f"{tag}: the refinement levels did not run")


def phase_polish(argv, threshold: float):
    """``reconstruct --mc_refine_steps`` on the val split's one object at
    the serving point, every step at one draw table (seeded by
    ``OPT_DRAW_SEED``), so that the step losses are those of one function;
    the loss must fall.  Then the witness: a patch of the
    ``WITNESS_FACES`` faces nearest the mesh's middle face, polished in fp32
    through the head's plain route on the card and on the CPU, which must
    agree.  Returns (record, launch counts of the CLI run)."""
    from slice3d_tpu_torch import pipeline, reconstruct
    from slice3d_tpu_torch.data.dataset import Slice3DDataset
    from slice3d_tpu_torch.mesh.refine import refine_mesh
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.pipeline import Reconstructor

    seen = []

    def polish(verts, faces, logit_fn, **kw):
        table = np.random.default_rng(OPT_DRAW_SEED).dirichlet(np.full(3, 0.5), len(faces))
        out = refine_mesh(verts, faces, logit_fn, draws=lambda step, n: table[:n], **kw)
        seen.append((np.asarray(verts), np.asarray(faces), table, out[1]))
        return out

    pipeline.refine_mesh = polish
    try:
        reset_counts()
        _, objs, pol_s = run_cli("opts polish", reconstruct.main,
                                 argv("slicenet", "polish", "--mc_refine_steps",
                                      str(OPT_REFINE_STEPS)) + ["--mode", "val"])
        counts = read_counts()
    finally:
        pipeline.refine_mesh = refine_mesh
    check_objects("polish", objs, 1)
    check(len(seen) == 1, f"the polish ran {len(seen)} times for one object")
    (verts, faces, table, losses), o = seen[0], objs[0]
    chunk = SERVE_POINT["mc_chunk_size"]
    below = [k for k, x in enumerate(losses) if x < losses[0]]
    print(f"[opts] polish {o['id']} at the serving point: {len(faces)} faces, "
          f"{OPT_REFINE_STEPS} steps in {o['time_refine']:.4f} s "
          f"({o['time_refine'] / OPT_REFINE_STEPS:.4f} s a step, "
          f"{-(-len(faces) // chunk)} chunks of {chunk} faces); launches {counts}")
    print(f"[opts] polish loss at one draw table, step by step: "
          f"{[float(x) for x in losses]}; first below the start at step "
          f"{below[0] if below else None}")
    check(losses[-1] < losses[0], f"the polish's loss did not fall in {OPT_REFINE_STEPS} "
          f"steps: {losses[0]!r} -> {losses[-1]!r}")

    feed = Slice3DDataset(os.path.join(SMOKE_DIR, "data", "opts"), split="val",
                          img_size=SERVE_POINT["img_size"], load_slices=False,
                          load_sdf=False)[0]
    cen = verts[faces].mean(1)
    near = np.argsort(np.linalg.norm(cen - cen[len(faces) // 2], axis=1),
                      kind="stable")[:WITNESS_FACES]
    used, inv = np.unique(faces[near], return_inverse=True)
    patch_v, patch_f = verts[used], inv.reshape(-1, 3)
    witness = {}
    torch.backends.cudnn.allow_tf32 = False  # the encoder's convolutions in fp32
    for dev in ("cuda", "cpu"):
        model = init_slicenet(0, dtype=torch.float32, route="plain")
        rec = Reconstructor(model, resolution0=SERVE_POINT["mc_res0"],
                            upsampling_steps=SERVE_POINT["mc_up_steps"],
                            chunk_size=chunk, threshold=threshold, device=dev)
        imgs, extras = rec._stack_inputs([feed])
        with torch.no_grad():
            cond = (model.encode_folded(imgs)[0],
                    tuple(torch.from_numpy(e).to(dev) for e in extras))
        t = time.perf_counter()
        with torch.enable_grad():
            witness[dev] = refine_mesh(
                patch_v, patch_f, lambda p: rec._logits(cond, 0, p), steps=WITNESS_STEPS,
                threshold=threshold, face_chunk=chunk, draws=lambda step, n: table[:n],
                device=dev)
        print(f"[check] polish witness on {dev}: {len(patch_f)} faces, {WITNESS_STEPS} fp32 "
              f"steps in {time.perf_counter() - t:.4f} s; loss step by step "
              f"{[float(x) for x in witness[dev][1]]}")
    torch.backends.cudnn.allow_tf32 = True
    (v_card, l_card), (v_cpu, l_cpu) = witness["cuda"], witness["cpu"]
    v_err = float(np.abs(v_card - v_cpu).max())
    l_err = float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu)))
    print(f"[check] polish witness, card against CPU: vertices {v_err:.6g} (tolerance "
          f"{WITNESS_ATOL}), losses {l_err:.6g} relative (tolerance {WITNESS_LOSS_RTOL}); "
          f"moved up to {float(np.abs(v_cpu - patch_v).max()):.6g}")
    check(v_err <= WITNESS_ATOL and l_err <= WITNESS_LOSS_RTOL,
          "the polish on the card disagrees with the CPU")
    return {"object": o, "s": pol_s, "steps": OPT_REFINE_STEPS,
            "losses": [float(x) for x in losses],
            "first_below_start": below[0] if below else None,
            "witness": {"faces": len(patch_f), "steps": WITNESS_STEPS,
                        "card_losses": [float(x) for x in l_card],
                        "cpu_losses": [float(x) for x in l_cpu],
                        "verts_err": v_err, "loss_rel_err": l_err}}, counts


def phase_regression_options():
    """The rest of the regression route's inference at the serving point:
    ``reconstruct --est_campose`` on SliceNet (the fused route, launches
    counted), then simplified at res0 32 / up 1; the polish of one object
    (``phase_polish``); DISN with ``--est_campose`` at batch 1 and at
    ``mc_batch_size`` 2; one mesh by marching tetrahedra; the DISN service
    over HTTP; the eval CLI on the card over the meshes against an analytic
    sphere, and against the CPU's plain computation."""
    from http.server import ThreadingHTTPServer

    from slice3d_tpu_torch import reconstruct, serve
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.data.dataset import Slice3DDataset
    from slice3d_tpu_torch.eval import cli as eval_cli
    from slice3d_tpu_torch.models.disn import init_disn
    from slice3d_tpu_torch.models.slicenet import init_slicenet

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    gt_dir = write_options_dataset(SMOKE_DIR, serving_pngs(OPT_OBJECTS, seed=21))
    exp = os.path.join(SMOKE_DIR, "exp")
    point = [f"--{k}={v}" for k, v in SERVE_POINT.items()]
    point += ["--dtype", "bfloat16", "--random_init",
             "--dir_data", os.path.join(SMOKE_DIR, "data"), "--name_dataset", "opts",
             "--mode", "test", "--dir_experiments", exp]
    feed = Slice3DDataset(os.path.join(SMOKE_DIR, "data", "opts"), split="test",
                          img_size=SERVE_POINT["img_size"],
                          load_slices=False, load_sdf=False, load_full_projection=True)[0]
    disn = init_disn(0, img_size=SERVE_POINT["img_size"], dtype=torch.bfloat16)
    cam_feed = reconstruct.campose_predictor(
        Options(name_model="disn", random_init=True, img_size=SERVE_POINT["img_size"]))(dict(feed))
    thr = {"slicenet": probe_threshold(init_slicenet(0, dtype=torch.bfloat16), feed),
           "disn": probe_threshold(disn, feed), "disn_campose": probe_threshold(disn, cam_feed)}
    del disn
    print(f"[opts] thresholds (median coarse logit of a res0 16 probe): {thr}")
    result = {"threshold": thr}

    def argv(model, name, *extra):
        return (point + ["--name_model", model.split("_")[0], "--name_exp", name,
                         "--mc_threshold", repr(thr[model])] + list(extra))

    # 1. SliceNet with CameraNet's pose estimate: the fused route
    reset_counts()
    _, camp, camp_s = run_cli("opts campose", reconstruct.main,
                              argv("slicenet", "campose", "--est_campose"))
    counts = read_counts()
    print(f"[opts] est_campose on SliceNet: {camp_s:.4f} s for {OPT_OBJECTS} objects; "
          f"launches {counts}")
    check_objects("est_campose", camp, OPT_OBJECTS)
    check(counts["fused_encoder_layer"] > 0, "est_campose launched no fused_encoder_layer")

    # 2. the same images simplified, on a coarser lattice
    res0, up = OPT_SIMPLIFY_POINT
    reset_counts()
    _, simplified, simp_s = run_cli(
        "opts simplify", reconstruct.main,
        argv("slicenet", "simplify", "--simplify_nfaces", str(OPT_SIMPLIFY), "--mc_res0",
             str(res0), "--mc_up_steps", str(up), "--mc_batch_size", str(OPT_OBJECTS)))
    counts = {k: v + counts[k] for k, v in read_counts().items()}
    check(len(simplified) == OPT_OBJECTS, "simplify: not every object reported")
    for o in simplified:
        print(f"[opts] simplify {o['id']}: {o['faces']} faces, marching and simplification "
              f"{o['time_marching']:.4f} s")
        check(0 < o["faces"] <= 1.2 * OPT_SIMPLIFY, f"{o['id']}: simplified to {o['faces']} "
              f"faces, asked for {OPT_SIMPLIFY}")

    # 3. the polish of one object at the serving point, and its witness
    polish, pol_counts = phase_polish(argv, thr["slicenet"])
    counts = {k: v + counts[k] for k, v in pol_counts.items()}

    # 4. DISN with CameraNet's pose at batch 1 and at mc_batch_size 2 (bf16,
    #    gather path)
    _, disn1, disn1_s = run_cli("opts disn", reconstruct.main,
                                argv("disn_campose", "disn1", "--est_campose"))
    _, disn2, disn2_s = run_cli("opts disn b2", reconstruct.main,
                                argv("disn_campose", "disn2", "--est_campose",
                                     "--mc_batch_size", "2"))
    check_objects("disn", disn1, OPT_OBJECTS)
    check_objects("disn b2", disn2, OPT_OBJECTS)
    worst = max(max(abs(a["n_points_evaluated"] - b["n_points_evaluated"])
                    / b["n_points_evaluated"], abs(a["vertices"] - b["vertices"]) / b["vertices"])
                for a, b in zip(disn2, disn1))
    print(f"[opts] DISN --est_campose: batch 1 {disn1_s:.4f} s, batch 2 {disn2_s:.4f} s for "
          f"{OPT_OBJECTS}; largest relative difference of n_points_evaluated and vertex counts "
          f"{worst:.6g} (tolerance {SERVE_RTOL}: bf16 convolutions at batch 2 round otherwise)")
    check(worst <= SERVE_RTOL, "DISN's batch-2 and batch-1 answers disagree")

    # 5. one mesh by marching tetrahedra (the val split's one object)
    _, tet, tet_s = run_cli("opts tetra", reconstruct.main,
                            argv("slicenet", "tetra", "--mc_extract", "tetrahedra") + ["--mode",
                                                                                       "val"])
    check_objects("tetrahedra", tet, 1)
    print(f"[opts] tetrahedra: {tet_s:.4f} s; surface nets gave {camp[0]['faces']} faces for "
          f"the same object, tetrahedra {tet[0]['faces']}")

    # 6. the DISN service over HTTP (the default camera)
    opts = Options(name_model="disn", dtype="bfloat16", random_init=True,
                   mc_threshold=thr["disn"], **SERVE_POINT)
    service = serve.build_service(opts)
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    served = []
    try:
        for i, body in enumerate(serving_pngs(OPT_OBJECTS, seed=21)):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
            t = time.perf_counter()
            conn.request("POST", "/reconstruct", body=body)
            resp = conn.getresponse()
            payload = resp.read()
            dt = time.perf_counter() - t
            conn.close()
            check(resp.status == 200, f"DISN request {i}: HTTP {resp.status}: {payload[:200]!r}")
            stats = json.loads(resp.getheader("X-Slice3D-Stats"))
            served.append({"latency_s": dt, "n_points_evaluated": stats["n_points_evaluated"],
                           "vertices": payload.count(b"\nv ") + payload.startswith(b"v ")})
            print(f"[opts] DISN service request {i}: latency {dt:.4f} s, n_points_evaluated "
                  f"{stats['n_points_evaluated']}, vertices {served[-1]['vertices']}")
            check(stats["n_points_evaluated"] > (SERVE_POINT["mc_res0"] + 1) ** 3,
                  "DISN service: no refinement levels")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    del service

    # 7. the eval CLI on the card over the est_campose meshes, then the card
    #    against the CPU's plain computation
    ev = ["--name_exp", "campose", "--name_dataset", "opts",
          "--dir_data", os.path.join(SMOKE_DIR, "data"), "--dir_experiments", exp,
          "--dir_gt_meshes", gt_dir, "--icp_align"]
    summary, _, eval_s = run_cli("opts eval", eval_cli.main,
                                 ev + ["--n_pts", str(EVAL_PTS), "--out",
                                       os.path.join(SMOKE_DIR, "eval.json")])
    check(summary is not None and summary["n"] == OPT_OBJECTS, "eval: not every mesh scored")
    check(all(np.isfinite(v) for v in summary.values()), "eval: non-finite metrics")
    print(f"[opts] eval on the card: {eval_s:.4f} s for {OPT_OBJECTS} objects "
          f"({eval_s / OPT_OBJECTS:.4f} s an object) at --n_pts {EVAL_PTS} with ICP: {summary}")
    compared = {}
    for icp_on in (False, True):
        args = ev[:-1] + (["--icp_align"] if icp_on else []) + ["--n_pts", str(EVAL_CHECK_PTS)]
        card, _, card_s = run_cli("opts eval check", eval_cli.main, args)
        cpu, _, cpu_s = run_cli("opts eval check", eval_cli.main, args + ["--device", "cpu"])
        rtol = EVAL_ICP_RTOL if icp_on else EVAL_RTOL
        atol = EVAL_ICP_ATOL if icp_on else 1.0 / EVAL_CHECK_PTS
        errs = {}
        for k, want in cpu.items():
            err = abs(card[k] - want)
            if k in ("chamfer_l1", "chamfer_l2", "hausdorff"):
                errs[k] = err / max(abs(want), 1e-30)
                bad = errs[k] > rtol
            elif icp_on or k != "iou":
                errs[k] = err
                bad = err > atol + 1e-12
            else:  # IoU without ICP: the same meshes and points, exactly
                errs[k] = err
                bad = err != 0
            check(not bad, f"eval ({'ICP' if icp_on else 'no ICP'}): {k} on the card "
                  f"{card[k]!r}, on the CPU {want!r}")
        print(f"[check] eval {'with' if icp_on else 'without'} ICP at --n_pts "
              f"{EVAL_CHECK_PTS}: card {card_s:.4f} s, CPU {cpu_s:.4f} s; differences {errs} "
              f"(tolerance: relative {rtol} for Chamfer and Hausdorff, {atol:g} for counts)")
        compared["icp" if icp_on else "no_icp"] = {"card": card, "cpu": cpu, "diff": errs}
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    result.update(campose={"objects": camp, "s": camp_s},
                  simplify={"objects": simplified, "s": simp_s, "point": OPT_SIMPLIFY_POINT},
                  polish=polish,
                  disn={"batch1": disn1, "batch2": disn2, "batch1_s": disn1_s,
                        "batch2_s": disn2_s, "rel": worst},
                  tetrahedra={"objects": tet, "s": tet_s}, disn_service=served,
                  eval={"summary": summary, "s": eval_s, "per_object_s": eval_s / OPT_OBJECTS,
                        "compared": compared})
    return result, counts


_BATCH_LINE = re.compile(r"batch (\d+) done \((\d+) cases in ([\d.]+) s\)")


def run_main(tag: str, argv):
    """``python -m slice3d_tpu_torch.main`` in this process with its output
    kept and echoed under ``tag``; returns (logdir, [(batch, cases, s)],
    seconds in all, attention launches, the batch of each launch)."""
    from slice3d_tpu_torch import main as gen_main
    from slice3d_tpu_torch.ops import spatial_attention as sa

    batches = []
    launch = sa._forward_kernel

    def recorded(q, *args, **kwargs):
        batches.append(q.shape[0])
        return launch(q, *args, **kwargs)

    out = _Tee(tag, sys.stdout)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    sa._forward_kernel = recorded
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            logdir = gen_main.main(argv)
        torch.cuda.synchronize()
    finally:
        sa._forward_kernel = launch
    dt = time.perf_counter() - t0
    counts = read_counts()
    per_batch = [(int(m[1]), int(m[2]), float(m[3]))
                 for m in _BATCH_LINE.finditer(out.getvalue())]
    print(f"[{tag}] {dt:.4f} s in all; launches {counts}")
    return logdir, per_batch, dt, counts, batches


def small_atlas(ldm, view, sampler: str, fixed: dict, device):
    """One view's atlas under ``sampler`` on ``device`` with handed-in draws
    (posterior noise, x_T and the step noises of ``fixed``): PLMS-4, DPM-4,
    the ancestral chain over its lowest 8 steps, and DDIM-4 (eta 1) at
    guidance 3 (one 2B call a step)."""
    from slice3d_tpu_torch.diffusion.ancestral import ddpm_sample
    from slice3d_tpu_torch.diffusion.ddim import ddim_sample
    from slice3d_tpu_torch.diffusion.dpm import dpm_solver_sample
    from slice3d_tpu_torch.diffusion.plms import plms_sample
    from slice3d_tpu_torch.diffusion.sampler import atlas_shape, encode_condition, make_eps_fn
    from slice3d_tpu_torch.diffusion.schedule import DDIMParams

    ldm.to(device)
    with torch.no_grad():
        img = view.to(device)
        cond = encode_condition(ldm, img, None, fixed["posterior_noise"])
        shape = atlas_shape(ldm, img)
        x_T = fixed["x_T"][:, :shape[1], :shape[2]].to(device)
        noises = [n[:, :shape[1], :shape[2]].to(device) for n in fixed["noises"]]
        if sampler == "plms":
            return plms_sample(make_eps_fn(ldm, cond), DDIMParams.create(ldm.schedule, 4, 0.0),
                               shape, x_T=x_T)
        if sampler == "dpm":
            return dpm_solver_sample(make_eps_fn(ldm, cond),
                                     DDIMParams.create(ldm.schedule, 4, 0.0), shape, x_T=x_T)
        if sampler == "ancestral":
            return ddpm_sample(make_eps_fn(ldm, cond), ldm.schedule, shape, x_T=x_T,
                               noises=noises[:GENCLI_CHECK_T], timesteps=GENCLI_CHECK_T)[0]
        return ddim_sample(make_eps_fn(ldm, cond, guidance_scale=3.0),
                           DDIMParams.create(ldm.schedule, 4, 1.0), shape, x_T=x_T,
                           noises=noises[:4])


def phase_generation_cli_checks(ldm):
    """Small inputs on the card for every new sampler (PLMS-4, DPM-4,
    ancestral over 8 steps, DDIM-4 at guidance 3), batch 1, handed-in
    draws: the full-width bf16 model's kernel path vs its plain path, and
    the tiny configuration's fp32 plain path card vs CPU."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion

    rng = np.random.default_rng(13)
    fixed = dict(posterior_noise=torch.from_numpy(rng.normal(size=(1, 16, 16, 4))
                                                  .astype(np.float32)),
                 x_T=torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32)),
                 noises=[torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32))
                         for _ in range(GENCLI_CHECK_T)])
    view = torch.from_numpy(rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32))
    tiny = init_latent_diffusion(seed=1, fused=False, **TRAIN_TINY)
    tiny_view = view[:, :16, :16]
    tiny_fixed = dict(fixed, posterior_noise=fixed["posterior_noise"][:, :8, :8])
    errs = {}
    for sampler in ("plms", "dpm", "ancestral", "guided"):
        kern = small_atlas(ldm, view, sampler, fixed, "cuda")
        set_fused(ldm, False)
        plain = small_atlas(ldm, view, sampler, fixed, "cuda")
        set_fused(ldm, True)
        check(bool(torch.isfinite(kern).all()), f"{sampler}: non-finite kernel-path atlas")
        check_close(kern, plain, GUIDED_ATLAS_TOL if sampler == "guided" else ATLAS_TOL,
                    f"atlas, batch 1, {GENCLI_CHECK_NAMES[sampler]}, kernel path vs plain "
                    "path (bf16)")
        torch.backends.cudnn.allow_tf32 = False
        gpu = small_atlas(tiny, tiny_view, sampler, tiny_fixed, "cuda").cpu()
        torch.backends.cudnn.allow_tf32 = True
        cpu = small_atlas(tiny, tiny_view, sampler, tiny_fixed, "cpu")
        check_close(gpu, cpu, ATLAS_FP32_TOL, f"atlas, tiny configuration, "
                    f"{GENCLI_CHECK_NAMES[sampler]}, fp32 card vs CPU (fp32 summation order)")
        errs[sampler] = {"kernel_vs_plain": float((kern - plain).abs().max()),
                         "card_vs_cpu": float((gpu - cpu).abs().max())}
    return errs


def phase_generation_cli(sm_clock_hz: float):
    """The attention kernel against its plain version at the guided batch
    (16, ``GUIDED_ATTN_SHAPES``), then the generation route's on-disk CLIs
    on the card, at the configs' widths: ``python -m slice3d_tpu_torch.main`` with
    configs/objaverse-ldm-kl-8-infer.yaml on a dataset of GENCLI_OBJECTS
    objects and a full-width seeded LDM checkpoint, for every sampler, at
    guidance 3 (batch 2B) and in ``--mode rec``, each with its attention
    launches counted; ``re_org_slices`` on the DDIM montages, the GTSlice
    reconstruct CLI on the generated slices and the SliceNet slice dump;
    then the small-input checks of ``phase_generation_cli_checks``."""
    from slice3d_tpu_torch import re_org_slices, reconstruct, reconstruct_slices
    from slice3d_tpu_torch.data.dataset import Slice3DDataset
    from slice3d_tpu_torch.data.image import load_image
    from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
    from slice3d_tpu_torch.diffusion.sampler import encode_condition, make_eps_fn
    from slice3d_tpu_torch.models.gtslice import init_gtslice
    from slice3d_tpu_torch.models.random_init import random_init_
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    t_phase = time.perf_counter()
    guided_modes = phase_attention(sm_clock_hz, GUIDED_ATTN_SHAPES)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = os.path.join(SMOKE_DIR, "data")
    write_options_dataset(SMOKE_DIR, serving_pngs(GENCLI_OBJECTS, seed=41), name="gen",
                          views=range(12), slices=True)
    with torch.device("cuda"):
        ldm = LatentDiffusion(dtype=torch.bfloat16)
    random_init_(ldm, torch.Generator("cuda").manual_seed(0))
    logdir = os.path.join(SMOKE_DIR, "ldm")
    trainer = LDMTrainer(module=ldm)
    t0 = time.perf_counter()
    trainer.save(trainer.init_state(), os.path.join(logdir, "checkpoints", "last.ckpt"))
    trainer.module = None
    gc.collect()
    setup_s = time.perf_counter() - t_phase
    print(f"[gencli] dataset of {GENCLI_OBJECTS} objects x 12 views and the full-width "
          f"checkpoint ({os.path.getsize(os.path.join(logdir, 'checkpoints', 'last.ckpt')) / 1e9:.3f} "
          f"GB, saved in {time.perf_counter() - t0:.4f} s): {setup_s:.4f} s")

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "objaverse-ldm-kl-8-infer.yaml")
    common = ["-b", config, "-r", logdir, "--data_root", os.path.join(data, "gen")]
    runs, counts_all = {}, {}
    sampled = os.path.join(logdir, "images_testing_sampled")
    for name, extra, launches, batch in GENCLI_RUNS:
        ret, per_batch, dt, counts, batches = run_main(f"gencli {name}", common + extra)
        check(ret == logdir, f"{name}: wrote to {ret}, not {logdir}")
        n_batches = 12 * GENCLI_OBJECTS // 8 if name == "rec" else 1
        check(len(per_batch) == n_batches and all(c == 8 for _, c, _ in per_batch),
              f"{name}: batches {per_batch}")
        check(counts["spatial_attention"] == launches,
              f"{name}: spatial_attention launched {counts['spatial_attention']} times, "
              f"expected {launches}")
        check(set(batches) <= {batch}, f"{name}: attention launched at batches {set(batches)}")
        s_batch = [s for _, _, s in per_batch]
        print(f"[gencli] {name}: {s_batch[0] if len(s_batch) == 1 else s_batch} s per batch "
              f"of 8 (the card's work to the montages on the host), {launches} attention "
              f"launches at batch {batch}, {dt:.4f} s for the CLI")
        runs[name] = {"s_per_batch": s_batch, "cli_s": dt,
                      "spatial_attention_launches": counts["spatial_attention"],
                      "attention_batch": batch}
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        if name == "rec":
            rec = sorted(os.listdir(os.path.join(logdir, "images_reconstructed")))
            check(len(rec) == 12 * GENCLI_OBJECTS, f"rec: {len(rec)} montages")
            continue
        mont = [load_image(os.path.join(sampled, f"0_{c}.png")) for c in range(8)]
        check(all(m.shape == (512, 512, 3) for m in mont), "a montage of the wrong shape")
        check(all(m[:384].std() > 0 for m in mont), "a constant montage")
        if name == "ddim":  # the DDIM-200 montages go on to re_org and GTSlice
            tiles = re_org_slices.main(["--dir_slices", sampled, "--type_slices", "gen",
                                        "--name_dataset", "gen", "--dir_data", data,
                                        "--img_size", "128", "--n_bs", "8"])
            gen_dirs = glob.glob(os.path.join(data, "gen", "04_img_slices_gen", "*", "004"))
            check(tiles == 12 * GENCLI_OBJECTS and len(gen_dirs) == GENCLI_OBJECTS
                  and all(len(os.listdir(d)) == 12 for d in gen_dirs),
                  f"re_org_slices wrote {tiles} tiles in {len(gen_dirs)} objects")
            print(f"[gencli] re_org_slices: {tiles} tiles of 128 px in {len(gen_dirs)} objects")

    # GTSlice on the generated slices, through the reconstruct CLI
    feed = Slice3DDataset(os.path.join(data, "gen"), split="test", img_size=128,
                          from_which_slices="gen", load_sdf=False)[0]
    thr = probe_threshold(init_gtslice(0, dtype=torch.bfloat16), feed)
    exp = os.path.join(SMOKE_DIR, "exp")
    point = [f"--{k}={v}" for k, v in SERVE_POINT.items()]
    argv = point + ["--dtype", "bfloat16", "--random_init", "--dir_data", data,
                    "--name_dataset", "gen", "--mode", "test", "--dir_experiments", exp,
                    "--name_model", "gtslice", "--from_which_slices", "gen",
                    "--name_exp", "gen", "--mc_threshold", repr(thr)]
    reset_counts()
    _, objs, rec_s = run_cli("gencli reconstruct", reconstruct.main, argv)
    rec_counts = read_counts()
    check_objects("gencli reconstruct", objs, GENCLI_OBJECTS)
    meshes = glob.glob(os.path.join(exp, "gen", "results", "gen", "*.obj"))
    check(len(meshes) == GENCLI_OBJECTS and all(os.path.getsize(m) > 0 for m in meshes),
          f"{len(meshes)} OBJ files from the generated slices")
    check(rec_counts["fused_encoder_layer"] > 0, "GTSlice launched no fused_encoder_layer")
    print(f"[gencli] reconstruct --name_model gtslice --from_which_slices gen: {rec_s:.4f} s "
          f"for {GENCLI_OBJECTS} ({rec_s / GENCLI_OBJECTS:.4f} s an object, threshold "
          f"{thr:.6f}); launches {rec_counts}")
    for k, v in rec_counts.items():
        counts_all[k] += v

    # SliceNet's slice dump
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee("gencli slices", sys.stdout)):
        out = reconstruct_slices.main(["--name_dataset", "gen", "--dir_data", data,
                                       "--random_init", "--img_size", "128",
                                       "--dir_experiments", exp, "--name_exp", "slices"])
    dump_s = time.perf_counter() - t0
    dumped = glob.glob(os.path.join(out, "*", "*.png"))
    check(len(dumped) == 12 * GENCLI_OBJECTS
          and all(load_image(p).shape == (256, 256, 3) for p in dumped),
          f"reconstruct_slices wrote {len(dumped)} PNGs")
    print(f"[gencli] reconstruct_slices: {len(dumped)} PNGs of 256 x 256 in {dump_s:.4f} s")
    for k, v in read_counts().items():
        counts_all[k] += v

    # one UNet call at B 8 and the guided 2B call (B 16)
    g = torch.Generator(device="cuda").manual_seed(14)
    views = torch.rand((8, 128, 128, 3), generator=g, device="cuda") * 2 - 1
    with torch.no_grad():
        cond = encode_condition(ldm, views, g, None)
        x = torch.randn((8, 64, 64, 4), generator=g, device="cuda")
        t = torch.full((8,), 500, dtype=torch.int64, device="cuda")
        unet_ms = {"8": cuda_ms(lambda: make_eps_fn(ldm, cond)(x, t), 10),
                   "16": cuda_ms(lambda: make_eps_fn(ldm, cond, guidance_scale=3.0)(x, t), 10)}
    print(f"[gencli] UNet call (64 x 64 atlas, bf16): {unet_ms['8']:.4f} ms at batch 8, "
          f"{unet_ms['16']:.4f} ms for the guided 2B call (batch 16)")

    checks = phase_generation_cli_checks(ldm)
    del ldm
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[gencli] phase 12 in {phase_s:.4f} s")
    return {"setup_s": setup_s, "runs": runs, "unet_ms": unet_ms,
            "reconstruct_s": rec_s, "reconstruct_s_per_object": rec_s / GENCLI_OBJECTS,
            "reconstruct_objects": objs, "slice_dump_s": dump_s, "checks": checks,
            "phase_s": phase_s}, counts_all, guided_modes


def _timed_steps(tag: str, step, state, batches, power: str, lr_of=None):
    """Warm-up steps, then the timed ones (each closed by a synchronise) with
    the launch counts read around them; the checks every trainer shares:
    finite losses, every parameter with a nonzero last gradient moved, every
    running statistic but the unused BatchNorm's moved, the LR of each update
    ``lr_of(update)``, no head kernel launched."""
    for batch in batches[:REG_WARMUP]:
        step(state, batch)
    torch.cuda.synchronize()
    model = state.model
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith(("running_mean", "running_var")) and not n.startswith(REG_UNUSED_BN)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for batch in batches[REG_WARMUP:]:
        t0 = time.perf_counter()
        _, logs = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logs = logs if isinstance(logs, dict) else {"loss": logs}
        losses.append({k: float(v) for k, v in logs.items()})
        if lr_of is not None:
            lr = state.optimizer.param_groups[0]["lr"]
            check(lr == lr_of(state.step - 1), f"{tag}: update {state.step - 1} ran at lr {lr}, "
                  f"the schedule says {lr_of(state.step - 1)}")
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = dict(model.named_parameters())
    live = [n for n, p in params.items() if p.grad is not None and bool(p.grad.any())]
    moved = sum(not torch.equal(params[n], params0[n]) for n in live)
    buffers = dict(model.named_buffers())
    bn_moved = sum(not torch.equal(buffers[n], b) for n, b in stats0.items())
    ms = {"p50": percentile(times, 0.5), "min": min(times), "max": max(times)}
    print(f"[regtrain] {tag}: {len(times)} steps of batch {REG_BATCH}: ms per step p50 "
          f"{ms['p50']:.4f}, min {ms['min']:.4f}, max {ms['max']:.4f}; peak memory "
          f"{peak_gb:.4f} GB; {power}; TF32 convolutions "
          f"{torch.backends.cudnn.allow_tf32}; launches {counts}")
    print(f"[regtrain] {tag}: losses first {losses[0]}, last {losses[-1]}; moved {moved} / "
          f"{len(live)} parameters with a nonzero gradient ({len(params)} in all), "
          f"{bn_moved} / {len(stats0)} running statistics")
    check(all(np.isfinite(v) for s in losses for v in s.values()), f"{tag}: a loss is not finite")
    check(moved == len(live) > 0, f"{tag}: a parameter with a nonzero gradient did not move")
    check(bn_moved == len(stats0) > 0, f"{tag}: a BatchNorm's running statistics did not move")
    check(counts["fused_encoder_layer"] == 0 and counts["fused_ffn"] == 0,
          f"{tag}: training launched a head kernel: {counts}")
    return {"ms_per_step": ms, "step_ms": times, "peak_gb": peak_gb, "steps": len(times),
            "batch": REG_BATCH, "losses": losses, "counts": counts}


def phase_regression_training(power: str):
    """Regression training at the configs' widths on batches made on the card:
    SliceNet with the VGG19 term in fp32 and in bf16, GTSlice from GT slices,
    CameraNet; then one tiny fp32 step per trainer on the card and on the CPU."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.train.train_cam import CamTrainer
    from slice3d_tpu_torch.profile_training import regression_batches, seeded_vgg19
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer, make_lr_schedule

    g = torch.Generator(device="cuda").manual_seed(13)
    batches = regression_batches(REG_WARMUP + REG_STEPS, g, b=REG_BATCH, size=REG_IMG,
                                 n_qry=REG_QRY)
    vgg = seeded_vgg19()
    out = {}
    for tag, name, dtype in (("slicenet fp32", "slicenet", "float32"),
                             ("slicenet bf16", "slicenet", "bfloat16"),
                             ("gtslice", "gtslice", "float32")):
        opts = Options(name_model=name, n_bs=REG_BATCH, img_size=REG_IMG, n_qry=REG_QRY,
                       train_dtype=dtype, freq_decay=1)
        trainer = RegressionTrainer(opts, vgg19=vgg if name == "slicenet" else None,
                                    steps_per_epoch=REG_STEPS_PER_EPOCH)
        state = trainer.init_state()
        frozen = trainer.vgg19
        vgg0 = {n: t.clone() for n, t in frozen.state_dict().items()} if frozen else {}
        schedule = make_lr_schedule(opts.lr, REG_STEPS_PER_EPOCH, opts.freq_decay,
                                    opts.lr_decay_factor)
        out[tag] = _timed_steps(tag, trainer.train_step, state, batches, power, schedule)
        check(not frozen or all(torch.equal(t, vgg0[n])
                                for n, t in frozen.state_dict().items()), f"{tag}: VGG19 changed")
        if name == "slicenet":
            check(out[tag]["losses"][-1]["loss_vgg"] > 0, f"{tag}: no perceptual term")
        del trainer, state
    cam = CamTrainer(img_size=REG_IMG)
    out["cameranet"] = _timed_steps("cameranet", cam.train_step, cam.init_state(), batches,
                                    power)
    del batches
    out["card_vs_cpu"] = _regression_card_vs_cpu(vgg)
    return out


def _regression_step_tiny(name, vgg, batch, dev):
    """One tiny fp32 step of ``name``'s trainer on ``dev`` from seed 2:
    (logs, gradients on the CPU)."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.train.train_cam import CamTrainer
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    if name == "cameranet":
        tr = CamTrainer(img_size=32, device=dev)
        st, loss = tr.train_step(tr.init_state(seed=2), batch)
        logs = {"loss": float(loss)}
    else:
        tr = RegressionTrainer(Options(name_model=name, img_size=32, n_qry=16, n_bs=2),
                               vgg19=vgg if name == "slicenet" else None, device=dev)
        st, logs = tr.train_step(tr.init_state(seed=2), batch)
        logs = {k: float(v) for k, v in logs.items()}
    return logs, {n: p.grad.detach().cpu().clone() for n, p in st.model.named_parameters()}


def regression_grad_readings(got: dict, want: dict, tol: dict) -> dict:
    """Element-wise over every parameter tensor: |got - want| <= atol G +
    rtol |want|, G the model's largest |gradient|, where at most
    REG_TIE_FRAC of a tensor's elements may exceed it (a max-pool near-tie
    routes a gradient to another pixel).  Readings: the largest error in
    units of G, the largest once each tensor's allowed near-ties are set
    aside, the largest L2 error of a tensor relative to its norm (tensors
    above 1e-6 G), and the elements beyond the allowance."""
    big = max(float(w.abs().max()) for w in want.values())
    out = {"max_err_G": 0.0, "err_G_without_ties": 0.0, "max_rel_l2": 0.0, "violations": 0}
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        err = (g - w).abs().flatten()
        allowed = int(REG_TIE_FRAC * err.numel())
        n_over = int((err > tol["atol"] * big + tol["rtol"] * w.abs().flatten()).sum())
        out["violations"] += max(0, n_over - allowed)
        top = torch.sort(err, descending=True).values
        out["max_err_G"] = max(out["max_err_G"], float(top[0]) / big)
        if allowed < err.numel():
            out["err_G_without_ties"] = max(out["err_G_without_ties"], float(top[allowed]) / big)
        if float(w.abs().max()) >= 1e-6 * big:
            out["max_rel_l2"] = max(out["max_rel_l2"], float(err.norm() / w.norm()))
    return out


def _regression_card_vs_cpu(vgg):
    """One tiny fp32 step (img 32, batch 2, 16 queries) of each trainer on the
    CPU (which the CPU tests hold against the JAX package) and on the card,
    from the same weights and batch, logs and gradients compared: with TF32
    off, which must agree, and with TF32 on (cuDNN and matmul), which must
    not, so that the tolerance is shown to tell fp32 from TF32."""
    from slice3d_tpu_torch.profile_training import regression_batches

    g = torch.Generator(device="cuda").manual_seed(23)
    batch = {k: v.cpu() for k, v in regression_batches(1, g, b=2, size=32, n_qry=16,
                                                        n_pcd=64)[0].items()}
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    readings = {}
    try:
        for name in ("slicenet", "gtslice", "cameranet"):
            c_logs, cpu = _regression_step_tiny(name, vgg, batch, "cpu")
            readings[name] = {"cpu": c_logs}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                g_logs, gpu = _regression_step_tiny(name, vgg, batch, "cuda")
                r = regression_grad_readings(gpu, cpu, REG_GRAD_FP32_TOL)
                r["log_rel_err"] = max(abs(g_logs[k] - c_logs[k]) / abs(c_logs[k])
                                       for k in c_logs)
                r["card"] = g_logs
                ok = r["violations"] == 0 and r["log_rel_err"] <= REG_LOSS_RTOL
                mode = "TF32 on" if tf32 else "fp32"
                print(f"[check] regression step {name}, tiny, card ({mode}) vs CPU fp32: logs "
                      f"{r['log_rel_err']:.6g} apart, relative (tolerance {REG_LOSS_RTOL}); "
                      f"gradients max_abs_err {r['max_err_G']:.6g} G, "
                      f"{r['err_G_without_ties']:.6g} G with at most {REG_TIE_FRAC} of a "
                      f"tensor set aside, largest tensor L2 error / its norm "
                      f"{r['max_rel_l2']:.6g}; tolerance |card-cpu| <= "
                      f"{REG_GRAD_FP32_TOL['atol']}*G + {REG_GRAD_FP32_TOL['rtol']}*|cpu|, "
                      f"violations {r['violations']}: {'agree' if ok else 'disagree'}")
                check(ok != tf32, f"{name} step, card ({mode}) vs CPU: "
                      + ("the check did not see TF32" if tf32 else "disagree"))
                readings[name]["tf32" if tf32 else "fp32"] = r
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
    return readings


def _run_train_cli(tag: str, main, argv):
    """A training CLI's ``main(argv)`` with its output echoed under ``tag``;
    returns (that output, seconds)."""
    out = _Tee(tag, sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{tag}] {dt:.4f} s in all")
    return out.getvalue(), dt


def phase_regression_clis():
    """The three training CLIs on a synthetic dataset of REG_CLI_SHAPES
    objects x 12 views of 128 px written into ``_smoke/`` (and removed):
    ``train`` for one epoch with the VGG19 term and again with ``--resume``
    (the step count and the halved LR carry on), ``train --device_preprocess``,
    ``train_gt`` and ``train_cam`` for one epoch each, then the reconstruct CLI
    on one object from the SliceNet checkpoint trained here, through
    fused_encoder_layer."""
    from slice3d_tpu_torch import reconstruct
    from slice3d_tpu_torch import train_cam, train_gt
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.data.builders import create_synthetic_dataset
    from slice3d_tpu_torch.data.dataset import Slice3DDataset
    from slice3d_tpu_torch.models.build import load_model
    from slice3d_tpu_torch.models.layers import TransformerEncoder
    from slice3d_tpu_torch.profile_training import seeded_vgg19
    from slice3d_tpu_torch.train import __main__ as train_cli

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = os.path.join(SMOKE_DIR, "data")
    t0 = time.perf_counter()
    create_synthetic_dataset(os.path.join(data, "objaverse"), n_shapes=REG_CLI_SHAPES,
                             n_views=12, img_size=REG_IMG, n_sdf=2048, seed=3)
    vgg_path = os.path.join(SMOKE_DIR, "vgg19.pth")
    torch.save(seeded_vgg19().state_dict(), vgg_path)
    print(f"[regcli] dataset of {REG_CLI_SHAPES} objects x 12 views ({REG_IMG} px) written in "
          f"{time.perf_counter() - t0:.4f} s")
    exp = os.path.join(SMOKE_DIR, "exp")
    common = ["--dir_data", data, "--name_dataset", "objaverse", "--img_size", str(REG_IMG),
              "--n_bs", str(REG_BATCH), "--n_qry", str(REG_QRY), "--n_views", "12",
              "--freq_log", "1", "--freq_ckpt", "1", "--freq_decay", "1", "--n_wk", "8",
              "--dir_experiments", exp]
    times = {}
    text, times["train"] = _run_train_cli("regcli train", train_cli.main, common + [
        "--name_exp", "reg", "--n_epochs", "1", "--vgg19_ckpt", vgg_path])
    check("[train] epoch 0 iter 1 lr 0.0003 " in text and "loss_vgg" in text,
          "train: no step at lr 3e-4 with the perceptual term")
    text, times["train_resume"] = _run_train_cli("regcli resume", train_cli.main, common + [
        "--name_exp", "reg", "--n_epochs", "2", "--vgg19_ckpt", vgg_path, "--resume"])
    check("at epoch 1" in text and "[train] epoch 1 iter 2 lr 0.00015 " in text,
          "train --resume: the step count or the schedule did not carry on")
    ckpts = sorted(os.listdir(os.path.join(exp, "reg", "ckpt")))
    check(len(ckpts) == 2 and ckpts[-1].startswith("1_2_"), f"train checkpoints {ckpts}")
    text, times["train_device_preprocess"] = _run_train_cli(
        "regcli devpre", train_cli.main, common + ["--name_exp", "devpre", "--n_epochs", "1",
                                                   "--device_preprocess"])
    check("[train] epoch 0 iter 1 " in text, "train --device_preprocess took no step")
    text, times["train_gt"] = _run_train_cli("regcli train_gt", train_gt.main, common + [
        "--name_exp", "gt", "--n_epochs", "1"])
    check("[train] epoch 0 iter 1 " in text and os.listdir(os.path.join(exp, "gt", "ckpt")),
          "train_gt took no step or saved no checkpoint")
    text, times["train_cam"] = _run_train_cli("regcli train_cam", train_cam.main, common + [
        "--name_exp_cam", "cam", "--n_epochs", "1"])
    check("[cam] epoch 0 step 1 " in text and os.listdir(os.path.join(exp, "cam", "ckpt")),
          "train_cam took no step or saved no checkpoint")

    # the trained SliceNet through the reconstruct CLI, one object at the
    # serving point (fused route)
    with open(os.path.join(data, "objaverse", "03_splits", "test.lst"), "w") as f:
        f.write("00000")
    opts = Options(name_model="slicenet", img_size=REG_IMG, dtype="bfloat16")
    feed = Slice3DDataset(os.path.join(data, "objaverse"), split="test", img_size=REG_IMG,
                          load_slices=False, load_sdf=False)[0]
    thr = probe_threshold(load_model(opts, os.path.join(exp, "reg", "ckpt", ckpts[-1]))
                          .to("cuda"), feed)
    point = [f"--{k}={v}" for k, v in SERVE_POINT.items()]
    # the head's encoder layers run in this reconstruction, counted by a
    # forward hook on every TransformerEncoder (the SDF head's only), each
    # layer one fused_encoder_layer launch
    layers = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, args, out: layers.append(len(mod.layers))
        if isinstance(mod, TransformerEncoder) else None)
    reset_counts()
    try:
        _, objs, rec_s = run_cli("regcli reconstruct", reconstruct.main, point + [
            "--dir_data", data, "--name_dataset", "objaverse", "--mode", "test",
            "--n_views", "12", "--dir_experiments", exp, "--name_exp", "reg",
            "--name_ckpt", ckpts[-1], "--dtype", "bfloat16", "--mc_threshold", repr(thr)])
    finally:
        hook.remove()
    counts = read_counts()
    check_objects("regcli reconstruct", objs, 1)
    check(counts["fused_encoder_layer"] == sum(layers) > 0 and counts["fused_ffn"] == 0,
          f"the trained checkpoint's reconstruction launched {counts}, its head ran "
          f"{sum(layers)} encoder layers in {len(layers)} calls")
    print(f"[regcli] reconstruct --name_ckpt {ckpts[-1]}: {rec_s:.4f} s for 1 object "
          f"(threshold {thr:.6f}); launches {counts}, {len(layers)} head calls of "
          f"{sum(layers)} encoder layers")
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return {"cli_s": times, "reconstruct_s": rec_s, "reconstruct_objects": objs,
            "checkpoints": ckpts}, counts


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
    power = smi("name,power.limit")
    print(power)

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
    del model
    options, options_counts = phase_regression_options()
    gencli, gencli_counts, guided_modes = phase_generation_cli(clock * 1e6)
    attn_modes += guided_modes
    t_phase = time.perf_counter()
    regtrain = phase_regression_training(power)
    regcli, regcli_counts = phase_regression_clis()
    regtrain["cli"] = regcli
    regtrain["phase_s"] = time.perf_counter() - t_phase
    print(f"[regtrain] phase 13 in {regtrain['phase_s']:.4f} s")
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")

    by_path = {"regression": main_counts, "generation": gen["counts"],
               "training": train["counts"], "serving": serve_counts, "split": split_counts,
               "options": options_counts, "generation_cli": gencli_counts,
               "regression_training": {k: sum(r["counts"][k] for r in regtrain.values()
                                              if isinstance(r, dict) and "counts" in r)
                                       for k in regcli_counts},
               "regression_cli": regcli_counts}
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
               "library_ms": full["library_ms"], "tflops": full["tflops"],
               "bound_share": full["bound_share"], "modes": modes}
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
           "library_ms": full_ffn["library_ms"], "tflops": full_ffn["tflops"],
           "bound_share": full_ffn["bound_share"], "modes": ffn_modes}
    print(json.dumps({"generation": {k: v for k, v in gen.items() if k != "counts"},
                      "training": {k: v for k, v in train.items() if k != "counts"},
                      "serving": serving, "split": split, "options": options,
                      "generation_cli": gencli, "regression_training": regtrain}))
    print(json.dumps({"kernels": [encoder, attention, attention_bwd, ffn]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
