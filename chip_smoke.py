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
     up 1, the polish of one object at res0 32 / up 1 (30 steps at one
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
     one fused_encoder_layer launch for each encoder layer its head runs;
 14. the generation route's training CLIs on a synthetic dataset of 16
     objects x 12 views of 128 px written into ``_smoke/`` (and removed):
     ``python -m slice3d_tpu_torch.main -t`` with configs/objaverse-ldm-kl-8.yaml
     for 6 steps (checkpoints and validation every 3, images with DDIM-20 at
     6) and resumed to step 8, with the attention launches the flags imply
     (exactly), ms per step, peak memory and the checkpoints, images and
     steps each run must leave; with configs/autoencoder_kl_f8_finetune.yaml
     and drawn LPIPS weights for 6 steps, the GAN from step 3 on (finite
     logs, the adaptive weight in [0, 1e4], D unmoved before and moved after,
     its statistics moving from step 1, LPIPS frozen, the top-k file on
     val/rec_loss); one tiny fp32 finetune step card vs CPU with TF32 off
     (must agree) and on (must not); ``--mode rec`` of
     configs/autoencoder_kl_f8_infer.yaml from the finetuned run;
 15. the multi-card machinery on the one card: SliceNet bf16 at the serving
     point over a mesh of two replicas on it, each its own copy of the
     weights, the object batch (4 objects) and each head call's points (one
     object, fused and split routes) split over the mesh, against the same
     reconstruction unsharded (the same points and faces, the grids within
     1e-2, s per object, no weight set prepared anew once both replicas'
     are); ``RegressionTrainer`` (SliceNet bf16 with VGG19, n_bs 16) and
     ``LDMTrainer`` (batch 8): 2 warm-up steps, then one step from that
     state without and within an NCCL group of one, where every collective
     runs (logs and gradients at phase 13's card tolerances), and 5 timed
     steps each way (ms per step, exact attention launches); ``reconstruct
     --multi_gpu --mc_shard_axis points`` against the same run without
     them, and ``train --multi_gpu``;
 16. parameters sharded over the model axis (``parallel.shard_params_fsdp``)
     on the one card, in an NCCL group of one (NCCL refuses two ranks of one
     group on one card: the one-off ``probe_two_ranks_one_card``, outside
     the phases, prints NCCL's words): JAX's rule shards nothing at a model
     axis of 1, nor at a min_size above every parameter; under a test-only
     override of the rule (``forced_rule``: the placements of a model axis
     of 2, at the dry run's min_size 2^12) ``RegressionTrainer`` (SliceNet
     bf16 with VGG19, n_bs 16) and ``LDMTrainer`` (batch 8) load the payload
     of an unsharded state after a warm-up step into their sharded states
     (gathered again it must be the same tensors) and take one step from it
     against the unsharded step (logs and gradients at phase 13's card
     tolerances), then 3 timed steps each way (ms per step, peak memory, the
     LDM's attention launches exact); the per-card bytes of parameters, Adam
     and EMA at model axes 1, 2, 4 and 8, computed from the rule's
     placements; and ``python -m slice3d_tpu_torch.dryrun`` in a group of
     its own (its five ``ok`` lines);
 17. checkpoint directories (``--ckpt_backend orbax`` / ``orbax_async``:
     ``torch.distributed.checkpoint``) against the msgpack file: (a) ``python
     -m slice3d_tpu_torch.main -t`` with configs/objaverse-ldm-kl-8.yaml at
     full width (batch 8, 128 px) on phase 14's synthetic dataset (8 objects,
     in ``_smoke/``, removed after) once per backend: 2 steps checkpointed
     every step, resumed to step 3 (whose closing save is not written: two
     ~5.3 GB writes a backend); per backend the loop's blocked ms per save
     (p50), GB written, card and host memory above a save's start, every
     restored tensor bit-equal to the saved state, exactly 10 + 10 attention
     launches a step; (b) phase 16's forced-sharded (1, 1) SliceNet and LDM
     states after a step saved as directories with no gather, restored into a
     sharded and into an unsharded state, both bit-equal; (c) one SliceNet
     object reconstructed through ``load_model`` from a ``RegressionTrainer``
     directory and from a file of the same weights: the same grid and faces;
 18. the JAX package's orbax checkpoint directories: the port's zstd decoder
     (its own C++, built with the card machine's g++ in phase 2) and OCDBT /
     zarr reader read the fixture committed at
     ``slice3d_tpu_torch/train/testdata/jax_orbax/`` (written by the JAX
     package: an fp32 leaf in 8 shard chunks, a bf16 leaf, int scalars, a
     ~1 MB chunk of several compressed blocks) and its level-19 frame; every
     leaf's shape, dtype and SHA-256 as ``expected.json`` gives them, the
     tensors moved to the card and read back, and on the card the level-19
     frame's bytes equal to the start of the leaf it was cut from; the
     decoder's build time and the read times;
 19. the fp32 attention kernels (``--dtype float32``, the JAX root CLI's
     precision): the forward and the backward at (8, 8, 4096, 24) and
     (8, 8, 1024, 48) in fp32 against their plain versions with TF32 off,
     the plain version with TF32 matmuls as the control that must fail the
     tolerance, with kernel, plain and fp32 scaled_dot_product_attention ms
     beside the fp32 FMA bound; ``python -m slice3d_tpu_torch.main -t
     --dtype float32`` with configs/objaverse-ldm-kl-8.yaml (batch 8, 4
     steps, exactly 10 + 10 fp32 launches a step and no bf16 one; ms per
     step beside phase 14's bf16 ones, peak memory) on 8 synthetic objects
     in ``_smoke/`` (removed after), then ``--mode sample --dtype float32``
     with DDIM-20 from its checkpoint (exactly 200 fp32 forward launches for
     the batch of 8, s per batch); one tiny fp32 ``LDMTrainer`` step (heads
     of 24, T 1024 at ds 1) on the card (the fp32 kernels) and on the CPU
     (the plain attention): logs and gradients at the regression trainers'
     tolerance, which TF32 on must fail.
The last three lines are the paths' JSON record, the kernels' JSON record
and the run's status JSON.
"""

from __future__ import annotations

import contextlib
import copy
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
# the polish of one object, at the reference's 30 steps,
# every step at one Dirichlet draw table so that the step losses compare:
# RMSprop's first step (second moment from 0) moves a coordinate by up to
# lr / sqrt(0.1) and raises this loss, the later steps bring it down
# (readings on an NVIDIA H100 80GB HBM3 at 700 W, the 966,844-face mesh:
# +3.4% after the first step, then -0.2% a step; at step 9 still 1.8% above
# the start, below it from step 19, -2.0% at step 29)
OPT_REFINE_STEPS, OPT_DRAW_SEED = 30, 5
# the polish runs on the mesh of res0 32 / up 1 (~1/20 of the serving
# point's faces), which keeps the script within its time; the readings above
# are of the serving point's 966,844-face mesh (on the res0 32 / up 1 mesh of
# 43,176 faces: +1.8% after the first step, below the start from step 4,
# -3.8% at step 29)
OPT_POLISH_POINT = (32, 1)
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
# the generation route's training CLIs (phase 14) on a synthetic dataset of
# GENTRAIN_SHAPES objects x 12 views of 128 px: the LDM at
# configs/objaverse-ldm-kl-8.yaml as it is (batch 8; validation one batch of 8),
# 6 steps with every 3rd checkpointed and validated (with and without the EMA)
# and images at step 6 (DDIM-20), then resumed to step 8; the VAE finetune at
# configs/autoencoder_kl_f8_finetune.yaml as it is (2 stacks of 13 images a
# step; validation one batch) with the GAN from step GENTRAIN_DISC_START on;
# --mode rec of configs/autoencoder_kl_f8_infer.yaml over 2 trainval objects
GENTRAIN_SHAPES, GENTRAIN_VAL, GENTRAIN_REC = 16, 8, 2
GENTRAIN_LDM = dict(max_steps=6, ckpt_every=3, val_every=3, log_images_every=6, ddim_steps=20)
GENTRAIN_RESUME_STEPS = 8
GENTRAIN_VAE_STEPS, GENTRAIN_DISC_START = 6, 3
# one tiny fp32 VAE finetune step (img 32, 4 images, GAN on, LPIPS) card vs
# CPU: logs and gradients as the regression trainers' step above (REG_*)
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
# phase 15: sharded reconstruction at the serving point over a mesh of two
# replicas on the one card, each its own weights; (tag, shard_axis, route,
# objects)
PAR_POINT = dict(resolution0=64, upsampling_steps=2, chunk_size=32768)
PAR_RUNS = (("batch", "batch", "fused", 4), ("points", "points", "fused", 1),
            ("points split", "points", "split", 1))
PAR_GRID_TOL = 1e-2  # PERF.md section 2's limit for a reorganised evaluation
PAR_WARMUP, PAR_STEPS = 2, 5  # training steps with and without the NCCL group
PAR_REG_BATCH, PAR_LDM_BATCH = 16, 8
PAR_CLI_SHAPES = 4  # the train CLI: one epoch of 2 steps at n_bs 2
# phase 16: parameters sharded over the model axis in an NCCL group of one (two
# ranks on one card are refused: probe_two_ranks_one_card), the trainers of
# phase 15 with every parameter of at least FSDP_MIN elements (the dry run's
# floor) placed as a model axis of FSDP_FORCED_AXIS would place it, on the
# (1, 1) mesh; FSDP_WARMUP steps, then one step from one state sharded and
# unsharded and FSDP_STEPS timed steps each way; the per-card bytes at the
# model axes FSDP_AXES, computed from the rule's placements
FSDP_MIN, FSDP_FORCED_AXIS, FSDP_WARMUP, FSDP_STEPS = 2 ** 12, 2, 1, 3
FSDP_AXES = (1, 2, 4, 8)
TRAIN_TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
                  unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1,),
                  unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=8)
ATTN_F32_SRC = {"spatial_attention_f32": ("slice3d_tpu_torch/csrc/spatial_attention_f32.cu",
                                          "slice3d_tpu/ops/pallas_attention.py:59"),
                "spatial_attention_bwd_f32": (
                    "slice3d_tpu_torch/csrc/spatial_attention_bwd_f32.cu",
                    "slice3d_tpu/ops/pallas_attention.py:150")}
# phase 19: the fp32 attention kernels against their plain versions at
# ATTN_SHAPES, element-wise: both compute in true fp32 and differ by summation
# order and the exponential, so the tolerances sit far below what TF32
# matmuls in the plain version give (the control that must fail them)
ATTN_F32_TOL = dict(atol=5e-5, rtol=5e-5)
ATTN_BWD_F32_TOL = dict(atol=2e-4, rtol=1e-4)
# ``main -t --dtype float32`` at configs/objaverse-ldm-kl-8.yaml's widths (batch
# 8) on F32_SHAPES synthetic objects, F32_STEPS steps (the first a warm-up),
# then ``--mode sample --dtype float32`` with DDIM-20 over the test split (one
# batch of 8) from the checkpoint it wrote
F32_SHAPES, F32_STEPS = 8, 4
F32_SAMPLE = ["--sampler", "ddim", "--ddim_steps", "20"]
# the tiny fp32 step card vs CPU at heads of 24 (UNet 192 ch over 8 heads), so
# that its ds 1 blocks (T = 1024) take the fp32 kernels on the card
TRAIN_TINY_F32 = dict(TRAIN_TINY, unet_channels=192, cond_widths=(192, 384))




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


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuDNN's convolutions and cuBLAS's matmuls on or off within."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def reset_counts() -> None:
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.ops import spatial_attention as sa

    fe.launches = 0
    ff.launches = 0
    sa.launches = sa.launches_bwd = sa.launches_f32 = sa.launches_bwd_f32 = 0


def read_counts() -> dict:
    from slice3d_tpu_torch.ops import fused_encoder as fe
    from slice3d_tpu_torch.ops import fused_ffn as ff
    from slice3d_tpu_torch.ops import spatial_attention as sa

    return {"fused_encoder_layer": fe.launches, "fused_ffn": ff.launches,
            "spatial_attention": sa.launches, "spatial_attention_bwd": sa.launches_bwd,
            "spatial_attention_f32": sa.launches_f32,
            "spatial_attention_bwd_f32": sa.launches_bwd_f32}


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


BUILD_S: dict = {}  # seconds each library of phase_build took to build


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

    from slice3d_tpu_torch.train import zstd

    t0 = time.perf_counter()
    builds = {"fused_encoder": fe.kernel, "fused_ffn": ff.kernel,
              "spatial_attention": sa.kernel, "spatial_attention_bwd": sa.kernel_bwd,
              "spatial_attention_f32": lambda: sa.kernel(torch.float32),
              "spatial_attention_bwd_f32": lambda: sa.kernel_bwd(torch.float32),
              "host mesh library": load_library, "zstd decoder": zstd.load_library}
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        for name, fut in futs.items():
            BUILD_S[name] = fut.result()
            print(f"[build] {name} built in {BUILD_S[name]:.2f} s")
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


def _ldm_grads(tr, st, batch, draws):
    """One micro-step of ``tr`` from ``st``: (logs, gradients by name)."""
    from slice3d_tpu_torch.train.train_ldm import trainable_parameters

    st.optimizer.zero_grad(set_to_none=True)
    logs = tr.loss_and_grads(st, batch, draws=draws)
    return ({k: float(v) for k, v in logs.items()},
            {n: p.grad.clone() for n, p in trainable_parameters(st.ldm).items()
             if p.grad is not None})


def phase_training_checks(trainer, state):
    """Small inputs on the card: one step's gradients at batch 1, kernel path
    vs plain path (bf16, full width), and the fp32 plain path card vs CPU on
    the tiny configuration."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    # 1. bf16, batch 1, full width: kernel path vs plain path, same weights
    rng = np.random.default_rng(8)
    batch = {"image": rng.uniform(-1, 1, (1, 13, 128, 128, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)}
    draws = {"posterior_noise": rng.normal(size=(1, 13, 16, 16, 4)).astype(np.float32),
             "t": np.array([500]), "noise": rng.normal(size=(1, 64, 64, 4)).astype(np.float32)}
    reset_counts()
    k_logs, kern = _ldm_grads(trainer, state, batch, draws)
    counts = read_counts()
    check(counts["spatial_attention"] == 10 and counts["spatial_attention_bwd"] == 10,
          f"the kernel path's step launched {counts}")
    set_fused(state.ldm, False)
    p_logs, plain = _ldm_grads(trainer, state, batch, draws)
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
        runs[dev] = _ldm_grads(tr, tr.init_state(), batch, draws)
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


def check_objects(tag: str, objects, n: int, res0: int = SERVE_POINT["mc_res0"]) -> None:
    """``n`` objects with meshes, each evaluated at more points than its
    coarse lattice of ``res0``: the refinement levels ran."""
    check(len(objects) == n, f"{tag}: {len(objects)} objects reported, expected {n}")
    for o in objects:
        check(o["faces"] > 0, f"{tag}: object {o['id']} has an empty mesh")
        check(o["n_points_evaluated"] > (res0 + 1) ** 3,
              f"{tag}: the refinement levels did not run")


def phase_polish(argv, threshold: float):
    """``reconstruct --mc_refine_steps`` on the val split's one object at
    res0 32 / up 1 (``OPT_POLISH_POINT``), every step at one draw table (seeded by
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
                                      str(OPT_REFINE_STEPS), "--mc_res0",
                                      str(OPT_POLISH_POINT[0]), "--mc_up_steps",
                                      str(OPT_POLISH_POINT[1])) + ["--mode", "val"])
        counts = read_counts()
    finally:
        pipeline.refine_mesh = refine_mesh
    check_objects("polish", objs, 1, OPT_POLISH_POINT[0])
    check(len(seen) == 1, f"the polish ran {len(seen)} times for one object")
    (verts, faces, table, losses), o = seen[0], objs[0]
    chunk = SERVE_POINT["mc_chunk_size"]
    below = [k for k, x in enumerate(losses) if x < losses[0]]
    print(f"[opts] polish {o['id']} at res0 {OPT_POLISH_POINT[0]} / up {OPT_POLISH_POINT[1]}: "
          f"{len(faces)} faces, "
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
        rec = Reconstructor(model, resolution0=OPT_POLISH_POINT[0],
                            upsampling_steps=OPT_POLISH_POINT[1],
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

    # 3. the polish of one object at OPT_POLISH_POINT, and its witness
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
    readings = {}
    for name in ("slicenet", "gtslice", "cameranet"):
        c_logs, cpu = _regression_step_tiny(name, vgg, batch, "cpu")
        readings[name] = {"cpu": c_logs}
        for on in (False, True):
            with tf32(on):
                g_logs, gpu = _regression_step_tiny(name, vgg, batch, "cuda")
            r = regression_grad_readings(gpu, cpu, REG_GRAD_FP32_TOL)
            r["log_rel_err"] = max(abs(g_logs[k] - c_logs[k]) / abs(c_logs[k])
                                   for k in c_logs)
            r["card"] = g_logs
            ok = r["violations"] == 0 and r["log_rel_err"] <= REG_LOSS_RTOL
            mode = "TF32 on" if on else "fp32"
            print(f"[check] regression step {name}, tiny, card ({mode}) vs CPU fp32: logs "
                  f"{r['log_rel_err']:.6g} apart, relative (tolerance {REG_LOSS_RTOL}); "
                  f"gradients max_abs_err {r['max_err_G']:.6g} G, "
                  f"{r['err_G_without_ties']:.6g} G with at most {REG_TIE_FRAC} of a "
                  f"tensor set aside, largest tensor L2 error / its norm "
                  f"{r['max_rel_l2']:.6g}; tolerance |card-cpu| <= "
                  f"{REG_GRAD_FP32_TOL['atol']}*G + {REG_GRAD_FP32_TOL['rtol']}*|cpu|, "
                  f"violations {r['violations']}: {'agree' if ok else 'disagree'}")
            check(ok != on, f"{name} step, card ({mode}) vs CPU: "
                  + ("the check did not see TF32" if on else "disagree"))
            readings[name]["tf32" if on else "fp32"] = r
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


def ldm_cli_launches(first: int, last: int, val_batches: int, ckpt_every: int = 0,
                     val_every: int = 0, log_images_every: int = 0, ddim_steps: int = 0,
                     max_steps: int = 0):
    """(forward, backward) attention launches of ``main -t`` from step
    ``first`` to ``last`` as its flags imply, 10 a UNet call: one call a
    step (and its backward), two a validation batch (with and without the
    EMA), ``ddim_steps`` at each image log."""
    steps = range(first + 1, last + 1)
    vals = sum(1 for s in steps if val_every > 0 and s % val_every == 0)
    logs = sum(1 for s in steps if log_images_every > 0 and s % log_images_every == 0)
    return 10 * (len(steps) + 2 * val_batches * vals + ddim_steps * logs), 10 * len(steps)


def run_train_main(tag: str, argv, trainer_cls, on_step=None):
    """``python -m slice3d_tpu_torch.main -t`` in this process with its output
    echoed under ``tag``, ``trainer_cls.train_step`` timed (closed by a
    synchronise) and ``on_step(trainer, state)`` called before the first and
    after every step; returns (logdir, [{step, ms, logs}], seconds, launch
    counts, peak GB)."""
    from slice3d_tpu_torch import main as gen_main

    steps = []
    real = trainer_cls.train_step

    def timed(self, state, *args, **kwargs):
        if on_step is not None and not steps:
            on_step(self, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = real(self, state, *args, **kwargs)
        torch.cuda.synchronize()
        steps.append({"step": state.step, "ms": (time.perf_counter() - t0) * 1e3,
                      "logs": {k: float(v) for k, v in logs.items()}})
        if on_step is not None:
            on_step(self, state)
        return state, logs

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer_cls.train_step = timed
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(tag, sys.stdout)):
            logdir = gen_main.main(argv)
        torch.cuda.synchronize()
    finally:
        trainer_cls.train_step = real
    dt = time.perf_counter() - t0
    counts, peak = read_counts(), torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] {dt:.4f} s in all, {len(steps)} steps, peak memory {peak:.4f} GB; "
          f"launches {counts}")
    return logdir, steps, dt, counts, peak


def _ms_stats(steps) -> dict:
    times = [s["ms"] for s in steps]
    return {"p50": percentile(times, 0.5), "min": min(times), "max": max(times),
            "steps": [s["step"] for s in steps]}


def _ckpt_names(logdir: str):
    return sorted(os.listdir(os.path.join(logdir, "checkpoints")))


def _phase_ldm_train_cli(data: str, power: str):
    """(a): ``main -t`` on configs/objaverse-ldm-kl-8.yaml, then resumed."""
    from slice3d_tpu_torch.train.checkpoint import restore_checkpoint
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    here = os.path.dirname(os.path.abspath(__file__))
    common = ["-b", os.path.join(here, "configs", "objaverse-ldm-kl-8.yaml"), "-t",
              "--data_root", data, "-s", "3"]
    flags = [f"--{k}={v}" for k, v in GENTRAIN_LDM.items()]
    runs, counts_all = {}, {}
    logdir = None
    for name, argv, first, last in (
            ("train", common + ["-l", os.path.join(SMOKE_DIR, "logs")] + flags, 0,
             GENTRAIN_LDM["max_steps"]),
            ("resume", None, GENTRAIN_LDM["max_steps"], GENTRAIN_RESUME_STEPS)):
        if argv is None:
            argv = common + ["-r", logdir, f"--max_steps={last}"] + flags[1:]
        ret, steps, dt, counts, peak = run_train_main(f"gentrain ldm {name}", argv, LDMTrainer)
        logdir = logdir or ret
        check(ret == logdir, f"ldm {name}: wrote to {ret}, not {logdir}")
        fwd, bwd = ldm_cli_launches(first, last, 1, **GENTRAIN_LDM)
        check(counts["spatial_attention"] == fwd and counts["spatial_attention_bwd"] == bwd,
              f"ldm {name}: attention launched {counts['spatial_attention']} / "
              f"{counts['spatial_attention_bwd']} times (forward / backward), the flags imply "
              f"{fwd} / {bwd}")
        check([s["step"] for s in steps] == list(range(first + 1, last + 1)),
              f"ldm {name}: steps {[s['step'] for s in steps]}")
        check(all(np.isfinite(v) for s in steps for v in s["logs"].values()),
              f"ldm {name}: a loss is not finite")
        payload = restore_checkpoint(os.path.join(logdir, "checkpoints", "last.ckpt"))
        check(payload["step"] == last, f"ldm {name}: last.ckpt at step {payload['step']}")
        del payload
        warm = steps[1:] if name == "train" else steps
        ms = _ms_stats(warm)
        print(f"[gentrain] ldm {name}: steps {first + 1}-{last}, ms per step over steps "
              f"{ms['steps']}: p50 {ms['p50']:.4f}, min {ms['min']:.4f}, max {ms['max']:.4f}; "
              f"peak memory {peak:.4f} GB; the CLI {dt:.4f} s; attention launches {fwd} "
              f"forward, {bwd} backward (exact); {power}")
        runs[name] = {"ms_per_step": ms, "step_ms": [s["ms"] for s in steps], "peak_gb": peak,
                      "cli_s": dt, "launches": counts,
                      "losses": [s["logs"] for s in steps]}
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
    names = _ckpt_names(logdir)
    topk = [n for n in names if n.startswith("step=")]
    check(sorted(n.split("-")[0] for n in topk) == ["step=000003", "step=000006"]
          and all("-val_loss_simple_ema=" in n for n in topk), f"ldm checkpoints {names}")
    images = sorted(os.listdir(os.path.join(logdir, "images", "train")))
    check(images == [f"{n}_gs-000006.png" for n in ("inputs", "reconstruction", "samples")],
          f"ldm images {images}")
    print(f"[gentrain] ldm checkpoints {names}; images {images}")
    return {"runs": runs, "checkpoints": names, "images": images, "logdir": logdir}, counts_all


def _phase_vae_train_cli(data: str, power: str):
    """(b): ``main -t`` on configs/autoencoder_kl_f8_finetune.yaml with drawn
    LPIPS weights and the GAN from GENTRAIN_DISC_START on."""
    from slice3d_tpu_torch.models.lpips import LPIPS
    from slice3d_tpu_torch.models.random_init import random_init_
    from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer

    lpips_path = os.path.join(SMOKE_DIR, "lpips.pth")
    lp = random_init_(LPIPS(), torch.Generator().manual_seed(4))
    sd = lp.state_dict()
    for k in range(5):
        sd[f"lin{k}.model.1.weight"].abs_()
    torch.save(sd, lpips_path)
    seen = {"disc": [], "stats": [], "lpips": []}

    def on_step(trainer, state):
        seen["disc"].append({n: p.detach().clone() for n, p in state.disc.named_parameters()})
        seen["stats"].append({n: b.clone() for n, b in state.disc.named_buffers()
                              if "running" in n})
        seen["lpips"].append({n: t.clone() for n, t in trainer.lpips.state_dict().items()})

    here = os.path.dirname(os.path.abspath(__file__))
    n = GENTRAIN_VAE_STEPS
    argv = ["-b", os.path.join(here, "configs", "autoencoder_kl_f8_finetune.yaml"), "-t",
            "--data_root", data, "-s", "3", "-l", os.path.join(SMOKE_DIR, "logs"),
            f"--max_steps={n}", f"--val_every={n}", f"--log_images_every={n}",
            f"--ckpt_every={n}", f"model.params.lossconfig.params.disc_start={GENTRAIN_DISC_START}",
            f"model.params.lossconfig.params.lpips_ckpt={lpips_path}"]
    logdir, steps, dt, counts, peak = run_train_main("gentrain vae", argv, VAEFinetuneTrainer,
                                                     on_step)
    check([s["step"] for s in steps] == list(range(1, n + 1)), f"vae steps {steps}")
    check(all(np.isfinite(v) for s in steps for v in s["logs"].values()),
          "vae: a log is not finite")
    check(all(0 <= s["logs"]["d_weight"] <= 1e4 for s in steps), "vae: d_weight off [0, 1e4]")
    d0 = seen["disc"][0]
    off, on = range(1, GENTRAIN_DISC_START + 1), range(GENTRAIN_DISC_START + 1, n + 1)
    check(all(torch.equal(seen["disc"][k][m], v) for k in off for m, v in d0.items()),
          "vae: D's parameters moved before disc_start")
    check(all(any(not torch.equal(seen["disc"][k][m], v) for m, v in d0.items()) for k in on),
          "vae: D's parameters did not move after disc_start")
    check(all(not torch.equal(seen["stats"][1][m], v) for m, v in seen["stats"][0].items()),
          "vae: D's running statistics did not move at step 1")
    check(all(torch.equal(seen["lpips"][-1][m], v) for m, v in seen["lpips"][0].items()),
          "vae: the LPIPS weights changed")
    check(all(s["logs"]["disc_loss"] == 0 for s in steps[:GENTRAIN_DISC_START])
          and all(s["logs"]["disc_loss"] > 0 for s in steps[GENTRAIN_DISC_START:]),
          f"vae: disc_loss {[s['logs']['disc_loss'] for s in steps]}")
    names = _ckpt_names(logdir)
    check("last.ckpt" in names and any(m.startswith(f"step={n:06d}-val_rec_loss=")
                                       for m in names), f"vae checkpoints {names}")
    check(counts["spatial_attention"] == 0 and counts["spatial_attention_bwd"] == 0
          and counts["fused_encoder_layer"] == 0, f"vae launched a kernel: {counts}")
    ms_off = _ms_stats(steps[1:GENTRAIN_DISC_START])
    ms_on = _ms_stats(steps[GENTRAIN_DISC_START:])
    print(f"[gentrain] vae finetune: 2 stacks of 13 images of 128 px a step; ms per step GAN "
          f"off (steps {ms_off['steps']}) p50 {ms_off['p50']:.4f}, min {ms_off['min']:.4f}, "
          f"max {ms_off['max']:.4f}; GAN on (steps {ms_on['steps']}) p50 {ms_on['p50']:.4f}, "
          f"min {ms_on['min']:.4f}, max {ms_on['max']:.4f}; peak memory {peak:.4f} GB; the "
          f"CLI {dt:.4f} s; d_weight {[round(s['logs']['d_weight'], 4) for s in steps]}; "
          f"checkpoints {names}; {power}")
    return {"ms_gan_off": ms_off, "ms_gan_on": ms_on, "step_ms": [s["ms"] for s in steps],
            "peak_gb": peak, "cli_s": dt, "logs": [s["logs"] for s in steps],
            "checkpoints": names, "logdir": logdir}, counts


def _vae_step_tiny(dev: str, lpips_sd, batch, noise):
    """One tiny fp32 VAE finetune step (GAN on) on ``dev`` from seed 2:
    (logs, VAE gradients, D gradients), on the CPU."""
    from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer

    tr = VAEFinetuneTrainer(img_size=32, vae_ch=32, vae_mult=(1, 2), vae_nres=1, lr=1e-4,
                            disc_start=0, lpips_params=lpips_sd, device=dev)
    st, logs = tr.train_step(tr.init_state(2), batch, draws={"posterior_noise": noise})
    grads = [{n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}
             for net in (st.vae, st.disc)]
    return {k: float(v) for k, v in logs.items()}, grads


def _vae_card_vs_cpu():
    """(c): the tiny fp32 step on the CPU and on the card with TF32 off (must
    agree) and on (printed beside it; must not agree)."""
    from slice3d_tpu_torch.models.lpips import LPIPS
    from slice3d_tpu_torch.models.random_init import random_init_

    rng = np.random.default_rng(31)
    batch = {"image": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)}
    noise = torch.from_numpy(rng.normal(size=(4, 16, 16, 4)).astype(np.float32))
    lpips_sd = random_init_(LPIPS(), torch.Generator().manual_seed(5)).state_dict()
    c_logs, cpu = _vae_step_tiny("cpu", lpips_sd, batch, noise)
    readings = {"cpu": c_logs}
    for on in (False, True):
        with tf32(on):
            g_logs, gpu = _vae_step_tiny("cuda", lpips_sd, batch, noise)
        r = {net: regression_grad_readings(g, c, REG_GRAD_FP32_TOL)
             for net, g, c in zip(("vae", "disc"), gpu, cpu)}
        r["log_rel_err"] = max(abs(g_logs[k] - c_logs[k]) / max(abs(c_logs[k]), 1e-30)
                               for k in c_logs)
        r["card"] = g_logs
        ok = (r["vae"]["violations"] + r["disc"]["violations"] == 0
              and r["log_rel_err"] <= REG_LOSS_RTOL)
        mode = "TF32 on" if on else "fp32"
        print(f"[check] vae finetune step, tiny, card ({mode}) vs CPU fp32: logs "
              f"{r['log_rel_err']:.6g} apart, relative (tolerance {REG_LOSS_RTOL}); "
              + "; ".join(f"{net} gradients max_abs_err {r[net]['max_err_G']:.6g} G, "
                          f"{r[net]['err_G_without_ties']:.6g} G without near-ties, "
                          f"largest tensor L2 error / its norm {r[net]['max_rel_l2']:.6g}, "
                          f"violations {r[net]['violations']}" for net in ("vae", "disc"))
              + f"; tolerance |card-cpu| <= {REG_GRAD_FP32_TOL['atol']}*G + "
              f"{REG_GRAD_FP32_TOL['rtol']}*|cpu|: {'agree' if ok else 'disagree'}")
        check(ok != on, f"vae finetune step, card ({mode}) vs CPU: "
              + ("the check did not see TF32" if on else "disagree"))
        readings["tf32" if on else "fp32"] = r
    return readings


def phase_generation_training_cli(power: str):
    """Phase 14: the generation route's training CLIs on the card on a
    synthetic dataset written into ``_smoke/`` (and removed): (a) LDM ``-t``
    and its resume, (b) the VAE finetune, (c) a tiny fp32 VAE step card vs
    CPU, (d) ``--mode rec`` on the autoencoder infer config from (b)'s run."""
    from slice3d_tpu_torch import main as gen_main
    from slice3d_tpu_torch.data.builders import create_synthetic_dataset
    from slice3d_tpu_torch.data.image import load_image

    t_phase = time.perf_counter()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = os.path.join(SMOKE_DIR, "data", "objaverse")
    create_synthetic_dataset(data, n_shapes=GENTRAIN_SHAPES, n_views=12, img_size=128,
                             n_sdf=64, seed=4)
    ids = ["%05d" % i for i in range(GENTRAIN_SHAPES)]

    def split(name, n):
        with open(os.path.join(data, "03_splits", f"{name}.lst"), "w") as f:
            f.write("\n".join(ids[:n]))

    split("train", GENTRAIN_SHAPES)
    split("val", GENTRAIN_VAL)
    split("trainval", GENTRAIN_REC)
    print(f"[gentrain] dataset of {GENTRAIN_SHAPES} objects x 12 views of 128 px in "
          f"{time.perf_counter() - t_phase:.4f} s")
    ldm, counts = _phase_ldm_train_cli(data, power)
    shutil.rmtree(ldm["logdir"], ignore_errors=True)  # ~5 GB a checkpoint
    split("val", 2)  # one batch of the finetune config's 2
    vae, vae_counts = _phase_vae_train_cli(data, power)
    for k, v in vae_counts.items():
        counts[k] += v
    card_vs_cpu = _vae_card_vs_cpu()

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(_Tee("gentrain rec", sys.stdout)):
        out = gen_main.main(["-b", os.path.join(here, "configs", "autoencoder_kl_f8_infer.yaml"),
                             "-r", vae["logdir"], "--mode", "rec", "--data_root", data])
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    for k, v in read_counts().items():
        counts[k] += v
    rec = sorted(os.listdir(os.path.join(out, "images_reconstructed")))
    check(out == vae["logdir"] and len(rec) == 12 * GENTRAIN_REC,
          f"vae --mode rec wrote {len(rec)} montages to {out}")
    mont = [load_image(os.path.join(out, "images_reconstructed", r)) for r in rec]
    check(all(m.shape == (512, 512, 3) and m[:384].std() > 0 for m in mont),
          "vae --mode rec: a montage of the wrong shape or constant")
    print(f"[gentrain] vae --mode rec: {len(rec)} montages in {rec_s:.4f} s")
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[gentrain] phase 14 in {phase_s:.4f} s")
    for r in (ldm, vae):
        r.pop("logdir")
    return {"ldm": ldm, "vae": vae, "vae_card_vs_cpu": card_vs_cpu, "rec_s": rec_s,
            "rec_montages": len(rec), "phase_s": phase_s}, counts


def mid_threshold(model, feed) -> float:
    """Iso level between the two middle coarse logits of a res0 16 probe: a
    real surface, and no lattice value on it (at the median itself, the
    iso level of ``probe_threshold``, rounding noise picks that value's
    side)."""
    from slice3d_tpu_torch.pipeline import Reconstructor

    probe, _ = Reconstructor(model, resolution0=16, upsampling_steps=0).build_grid(feed)
    mid = np.sort(probe.ravel())[probe.size // 2 - 1:probe.size // 2 + 1].mean()
    return float(1.0 / (1.0 + np.exp(-mid)))


def _own_replica(rec):
    """Give the second data device of a sharded Reconstructor a weight set of
    its own, a copy of the model on the same card: a mesh that names a
    device twice shares one replica there, and this phase's mesh names the
    one card twice."""
    model, flip = rec._replicas[0]
    rec._replicas[1] = (copy.deepcopy(model), flip.clone())
    return rec


def phase_parallel_reconstruction():
    """Phase 15, reconstruction: SliceNet bf16 at the serving point over a mesh
    of two replicas on the one card (``create_mesh((2, 1), devices=[cuda:0,
    cuda:0])``, each replica its own copy of the weights, ``_own_replica``),
    the object batch or each head call's points split over it, against the
    same reconstruction unsharded: the same points and faces, the grids
    within PAR_GRID_TOL, no weight set prepared anew once both replicas'
    sets are (the prepared-weights cache holds both).  The batch
    split's unsharded reference evaluates the same parts (2 objects each)
    on one device: a bf16 encode of 4 images rounds otherwise than two of 2
    (other convolution algorithms), which the batch of 4 on one device
    shows beside it, held as phase 9 holds micro-batching (n_points within
    SERVE_RTOL relative)."""
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.ops import prepared
    from slice3d_tpu_torch.parallel import create_mesh
    from slice3d_tpu_torch.pipeline import Reconstructor

    model = init_slicenet(seed=0, dtype=torch.bfloat16).to("cuda")
    feeds = make_feeds(4, seed=15)
    thr = mid_threshold(model, feeds[0])
    mesh = create_mesh((2, 1), devices=["cuda:0", "cuda:0"])
    print(f"[parallel] mesh {mesh}; threshold {thr:.6f}")
    out, counts = {}, {k: 0 for k in read_counts()}
    for tag, axis, route, n in PAR_RUNS:
        set_route(model, route)
        kw = dict(PAR_POINT, threshold=thr, batch_size=n)
        part = n // 2 if axis == "batch" else n  # what one device encodes at once
        runs = {}
        for name, rec, groups in (
                ("unsharded", Reconstructor(model, **dict(kw, batch_size=part)),
                 [feeds[i:i + part] for i in range(0, n, part)]),
                ("sharded", _own_replica(Reconstructor(model, mesh=mesh, shard_axis=axis, **kw)),
                 [feeds[:n]]),
                ("one device", Reconstructor(model, **kw), [feeds[:n]])):
            if name == "one device" and part == n:
                continue
            p0 = prepared.prepares
            for group in groups:
                rec.build_grids(group)  # warm
            torch.cuda.synchronize()
            warm_prepares = prepared.prepares - p0
            reset_counts()
            p0 = prepared.prepares
            t0 = time.perf_counter()
            built = [rec.build_grids(group) for group in groups]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            grids = [g for gs, _ in built for g in gs]
            stats = [st for _, sts in built for st in sts]
            runs[name] = dict(grids=grids, stats=stats, s=dt, counts=read_counts(),
                              prepares=prepared.prepares - p0, warm_prepares=warm_prepares,
                              meshes=[rec._march(g, st) for g, st in zip(grids, stats)])
        a, b = runs["unsharded"], runs["sharded"]
        if "one device" in runs:
            whole = [st["n_points_evaluated"] for st in runs["one device"]["stats"]]
            rel = max(abs(x["n_points_evaluated"] - y) / y for x, y in zip(b["stats"], whole))
            print(f"[parallel] {tag}: the batch of {n} on one device: s per object "
                  f"{runs['one device']['s'] / n:.4f}, n_points_evaluated {whole}, the "
                  f"sharded run's within {rel:.3g} relative (limit {SERVE_RTOL})")
            check(rel <= SERVE_RTOL, f"parallel {tag}: n_points off the batch of {n}'s")
        err = max(float(np.abs(x - y).max()) for x, y in zip(a["grids"], b["grids"]))
        pts = [[st["n_points_evaluated"] for st in r["stats"]] for r in (a, b)]
        faces = [[len(m.faces) for m in r["meshes"]] for r in (a, b)]
        same_faces = all(np.array_equal(x.faces, y.faces)
                         for x, y in zip(a["meshes"], b["meshes"]))
        c = b["counts"]
        print(f"[parallel] {tag} ({route} route, {n} object(s), unsharded in parts of "
              f"{part}): s per object sharded {b['s'] / n:.4f}, unsharded "
              f"{a['s'] / n:.4f}; n_points_evaluated {pts[1]} "
              f"(unsharded {pts[0]}); faces {faces[1]} (unsharded {faces[0]}), equal "
              f"{same_faces}; grid max |sharded - unsharded| {err:.6g} (limit "
              f"{PAR_GRID_TOL}); weight sets prepared in the warm-up {b['warm_prepares']} "
              f"(unsharded {a['warm_prepares']}), then {b['prepares']}; launches {c}")
        check(pts[0] == pts[1], f"parallel {tag}: n_points_evaluated {pts[1]} != {pts[0]}")
        check(same_faces, f"parallel {tag}: the faces differ from the unsharded run's")
        check(err <= PAR_GRID_TOL, f"parallel {tag}: grid differs by {err}")
        check(b["prepares"] == 0, f"parallel {tag}: {b['prepares']} weight sets prepared anew")
        check(b["warm_prepares"] > 0, f"parallel {tag}: the second replica shares the weights")
        if route == "fused":
            check(c["fused_encoder_layer"] > 0 and c["fused_ffn"] == 0,
                  f"parallel {tag}: launches {c}")
        else:
            check(c["fused_ffn"] > 0 and c["fused_encoder_layer"] == 0,
                  f"parallel {tag}: launches {c}")
        counts = {k: counts[k] + v for k, v in c.items()}
        out[tag] = {"s_per_object": b["s"] / n, "unsharded_s_per_object": a["s"] / n,
                    "n_points_evaluated": pts[1], "faces": faces[1], "grid_max_err": err}
    set_route(model, "fused")
    return out, counts


def _steps_with_and_without_group(tag, make, power):
    """``make()`` -> (state, step(state, k) -> logs): PAR_WARMUP steps, then
    from that state one step without a process group and the same step
    within an NCCL group of one (the logs at REG_LOSS_RTOL, the gradients at
    REG_GRAD_FP32_TOL, phase 13's card tolerances), then PAR_STEPS timed
    steps each way.  Within the group every collective of the step runs, as
    it does whenever a group is joined: the NCCL all-reduce of the
    gradients and of the logs, and the BatchNorm statistics' all-reduce
    under autograd, which sums and divides where the ungrouped step takes a
    mean; so the difference is theirs and the card's run-to-run rounding,
    and the time per step with the group holds their cost.  Returns the
    readings, ms per step and the launch counts within the group."""
    import torch.distributed as dist

    state, step = make()
    for k in range(PAR_WARMUP):
        step(state, k)
    runs = {}
    for grouped in (False, True):
        check(dist.is_initialized() == grouped, f"{tag}: group state")
        st = copy.deepcopy(state)
        reset_counts()
        logs = {key: float(v) for key, v in step(st, PAR_WARMUP).items()}
        grads = {n: p.grad.detach().clone() for n, p in _model_of(st).named_parameters()
                 if p.grad is not None}
        times = []
        for k in range(PAR_WARMUP + 1, PAR_WARMUP + 1 + PAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, k)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        runs[grouped] = {"logs": logs, "grads": grads, "ms": percentile(times, 0.5),
                         "ms_range": (min(times), max(times)), "counts": read_counts()}
        if grouped:
            allreduce = _allreduce_ms(st)
        del st
        if not grouped:
            _init_group_of_one()
    dist.destroy_process_group()
    a, b = runs[True], runs[False]
    worst = max(abs(a["logs"][k] - v) / max(abs(v), 1e-12) for k, v in b["logs"].items())
    readings = regression_grad_readings(a["grads"], b["grads"], REG_GRAD_FP32_TOL)
    grad_bytes = sum(g.numel() * g.element_size() for g in a["grads"].values())
    print(f"[parallel] {tag}: ms per step p50 over {PAR_STEPS} steps with the NCCL group "
          f"{a['ms']:.4f} (min {a['ms_range'][0]:.4f}, max {a['ms_range'][1]:.4f}), without "
          f"{b['ms']:.4f} (min {b['ms_range'][0]:.4f}, max {b['ms_range'][1]:.4f}); the group "
          f"all-reduces {grad_bytes} bytes of gradients a step, alone: {allreduce}; "
          f"step {PAR_WARMUP} from one state with vs "
          f"without the group: logs max relative difference {worst:.3g} (tolerance "
          f"{REG_LOSS_RTOL}), gradients {readings} (tolerance {REG_GRAD_FP32_TOL} G, "
          f"{REG_TIE_FRAC} of a tensor); launches within the group over "
          f"{1 + PAR_STEPS} steps {a['counts']}; {power}")
    check(worst <= REG_LOSS_RTOL, f"{tag}: the grouped step's logs differ")
    check(readings["violations"] == 0, f"{tag}: the grouped step's gradients differ")
    return {"ms_grouped": a["ms"], "ms_ungrouped": b["ms"], "log_rel_diff": worst,
            "grads": readings, "grad_bytes": grad_bytes, "allreduce_ms": allreduce,
            "logs": a["logs"]}, a["counts"]


def _allreduce_ms(state, reps: int = 5) -> dict:
    """Within the group, ms (p50 of ``reps``) of ``all_reduce_gradients``
    alone on the state's gradients (its concatenation, the NCCL all-reduce,
    the division and the copy back), and of one NCCL all-reduce of a flat
    buffer of as many bytes."""
    import torch.distributed as dist

    from slice3d_tpu_torch.parallel import all_reduce_gradients

    params = [p for p in _model_of(state).parameters() if p.grad is not None]
    flat = torch.empty(sum(p.grad.numel() * p.grad.element_size() for p in params),
                       dtype=torch.uint8, device="cuda")
    out = {}
    for name, fn in (("all_reduce_gradients", lambda: all_reduce_gradients(params)),
                     ("one flat all-reduce", lambda: dist.all_reduce(flat))):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = percentile(times, 0.5)
    return out


def _model_of(state):
    return state.model if hasattr(state, "model") else state.ldm


def _init_group_of_one():
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{port}")


def phase_parallel_training(power: str):
    """Phase 15, training: ``RegressionTrainer`` (SliceNet bf16 with the VGG19
    term, n_bs 16) and ``LDMTrainer`` (batch 8) without and within an NCCL
    group of one this phase makes (``init_distributed`` is a no-op for one
    process, as JAX's), from the same state and batches
    (``_steps_with_and_without_group``); the LDM's attention launches
    exact."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.profile_training import regression_batches, seeded_vgg19
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    steps = PAR_WARMUP + 1 + PAR_STEPS
    reg_batches = regression_batches(steps, torch.Generator(device="cuda").manual_seed(15),
                                     b=PAR_REG_BATCH, size=REG_IMG, n_qry=REG_QRY)
    vgg = seeded_vgg19()

    def make_reg():
        opts = Options(name_model="slicenet", n_bs=PAR_REG_BATCH, img_size=REG_IMG,
                       n_qry=REG_QRY, train_dtype="bfloat16")
        trainer = RegressionTrainer(opts, vgg19=vgg)
        return trainer.init_state(), lambda st, k: trainer.train_step(st, reg_batches[k])[1]

    out, counts = {}, {}
    out["regression"], counts["regression"] = _steps_with_and_without_group(
        "regression training, SliceNet bf16 + VGG19", make_reg, power)
    del reg_batches
    ldm_batches = train_batches(steps, PAR_LDM_BATCH,
                                torch.Generator(device="cuda").manual_seed(16))

    def make_ldm():
        trainer = LDMTrainer(module=init_latent_diffusion(seed=0, dtype=torch.bfloat16),
                             batch_size=PAR_LDM_BATCH)
        state = trainer.init_state()
        trainer.maybe_set_scale(state, ldm_batches[0],
                                torch.Generator(device="cuda").manual_seed(17))

        def step(st, k):  # step k's draws from its own seed
            g = torch.Generator(device="cuda").manual_seed(100 + k)
            return trainer.train_step(st, ldm_batches[k], g)[1]

        return state, step

    out["ldm"], counts["ldm"] = _steps_with_and_without_group(
        "LDM training, batch 8", make_ldm, power)
    c, n = counts["ldm"], 1 + PAR_STEPS
    check(c["spatial_attention"] == 10 * n and c["spatial_attention_bwd"] == 10 * n,
          f"LDM training in the group launched {c}, expected 10 and 10 a step")
    total = {k: counts["regression"][k] + c[k] for k in c}
    check(counts["regression"]["fused_encoder_layer"] == 0, "regression training ran the head")
    return out, total


def phase_parallel_clis():
    """Phase 15, the CLIs with the options: ``reconstruct --multi_gpu
    --mc_shard_axis points`` on phase 11's option dataset against the same
    run without them (on one card ``reconstruction_mesh`` returns None: the
    same unsharded run), and ``train --multi_gpu`` for one epoch of 2 steps."""
    from slice3d_tpu_torch import reconstruct
    from slice3d_tpu_torch.data.builders import create_synthetic_dataset
    from slice3d_tpu_torch.data.dataset import Slice3DDataset
    from slice3d_tpu_torch.models.slicenet import init_slicenet
    from slice3d_tpu_torch.parallel import device_count, reconstruction_mesh
    from slice3d_tpu_torch.train import __main__ as train_cli

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    write_options_dataset(SMOKE_DIR, serving_pngs(OPT_OBJECTS, seed=21))
    data, exp = os.path.join(SMOKE_DIR, "data"), os.path.join(SMOKE_DIR, "exp")
    feed = Slice3DDataset(os.path.join(data, "opts"), split="test",
                          img_size=SERVE_POINT["img_size"], load_slices=False,
                          load_sdf=False)[0]
    thr = mid_threshold(init_slicenet(0, dtype=torch.bfloat16).to("cuda"), feed)
    argv = [f"--{k}={v}" for k, v in SERVE_POINT.items()] + [
        "--dtype", "bfloat16", "--random_init", "--dir_data", data, "--name_dataset", "opts",
        "--mode", "test", "--dir_experiments", exp, "--mc_threshold", repr(thr)]
    mesh = reconstruction_mesh("points", 1, SERVE_POINT["mc_chunk_size"], device_count("cuda"))
    print(f"[parallel] reconstruction_mesh('points', 1, {SERVE_POINT['mc_chunk_size']}, "
          f"{device_count('cuda')} card(s)) = {mesh}: on one card the options leave the run "
          f"unsharded")
    reset_counts()
    _, plain, plain_s = run_cli("parallel reconstruct", reconstruct.main,
                                argv + ["--name_exp", "plain"])
    _, sharded, sharded_s = run_cli("parallel reconstruct points", reconstruct.main,
                                    argv + ["--name_exp", "points", "--multi_gpu",
                                            "--mc_shard_axis", "points"])
    check_objects("parallel reconstruct", sharded, OPT_OBJECTS)
    key = ("id", "vertices", "faces", "n_points_evaluated")
    check([[o[k] for k in key] for o in plain] == [[o[k] for k in key] for o in sharded],
          "reconstruct --multi_gpu --mc_shard_axis points gave other objects")
    for o in plain:
        paths = [os.path.join(exp, name, "results", "opts", f"{o['id']}.obj")
                 for name in ("plain", "points")]
        with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
            check(f0.read() == f1.read(), f"{o['id']}: the OBJ files differ")
    print(f"[parallel] reconstruct: {OPT_OBJECTS} objects in {plain_s:.4f} s, with "
          f"--multi_gpu --mc_shard_axis points {sharded_s:.4f} s, the same OBJ files")
    create_synthetic_dataset(os.path.join(data, "objaverse"), n_shapes=PAR_CLI_SHAPES,
                             n_views=12, img_size=REG_IMG, n_sdf=2048, seed=5)
    text, train_s = _run_train_cli("parallel train", train_cli.main, [
        "--dir_data", data, "--name_dataset", "objaverse", "--img_size", str(REG_IMG),
        "--n_bs", "2", "--n_qry", str(REG_QRY), "--n_views", "12", "--freq_log", "1",
        "--n_epochs", "1", "--n_wk", "4", "--dir_experiments", exp, "--name_exp", "mgpu",
        "--multi_gpu"])
    check("[train] epoch 0 iter 2 " in text and os.listdir(os.path.join(exp, "mgpu", "ckpt")),
          "train --multi_gpu did not take its 2 steps or saved no checkpoint")
    counts = read_counts()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return {"reconstruct_s": plain_s, "reconstruct_points_s": sharded_s,
            "train_s": train_s}, counts


# phase 16: two ranks of one NCCL group on the one card, a (data, model) =
# (1, 2) device mesh and one all-gather over its model axis
TWO_RANKS_PROBE = """
import datetime, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
r, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=r,
                        timeout=datetime.timedelta(seconds=40))
mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
out = torch.empty(8, device="cuda")
dist.all_gather_into_tensor(out, torch.full((4,), float(r), device="cuda"),
                            group=mesh["model"].get_group())
torch.cuda.synchronize()
print("gathered", out.tolist(), flush=True)
dist.destroy_process_group()
"""


def probe_two_ranks_one_card(timeout: float = 75.0) -> dict:
    """A one-off check, outside the phases (``python3 -c "import chip_smoke
    as c; c.probe_two_ranks_one_card()"``): start two processes that put
    NCCL ranks 0 and 1 of one group on card 0, build a (1, 2)
    ``init_device_mesh`` and all-gather over ``model``.
    Returns whether both ended with the gathered values, with NCCL's own
    words (``NCCL_DEBUG=WARN``) when they did not; both processes are
    stopped either way."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS_PROBE, str(r), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outputs = []
    try:
        for p in procs:
            try:
                outputs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outputs.append(p.communicate()[0] + "\n(killed at the probe's time limit)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    accepted = all(p.returncode == 0 and "gathered [0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]"
                   in text for p, text in zip(procs, outputs))
    words = [ln.strip() for text in outputs for ln in text.splitlines()
             if re.search(r"NCCL (WARN|version)|ncclInvalidUsage|gathered", ln)]
    print(f"[fsdp] two NCCL ranks on card 0, init_device_mesh('cuda', (1, 2)): "
          f"{'accepted' if accepted else 'refused'} (exit codes "
          f"{[p.returncode for p in procs]}); NCCL {torch.cuda.nccl.version()}")
    for ln in dict.fromkeys(words):
        print(f"[fsdp]   {ln[:400]}")
    return {"accepted": accepted, "returncodes": [p.returncode for p in procs],
            "words": list(dict.fromkeys(words))[:20]}


@contextlib.contextmanager
def forced_rule():
    """Within the block the placement rule (``parallel.sharding.fsdp_spec``)
    places every parameter as a model axis of FSDP_FORCED_AXIS would, on any
    mesh: the test-only override that puts the sharded path (``fully_shard``'s
    gathers and reduce-scatters) on the (1, 1) mesh of one card."""
    from slice3d_tpu_torch.parallel import sharding

    rule = sharding.fsdp_spec
    sharding.fsdp_spec = lambda x, mesh, min_size, axes=None: rule(x, FSDP_FORCED_AXIS,
                                                                   min_size, axes)
    try:
        yield
    finally:
        sharding.fsdp_spec = rule


def _fsdp_step_pair(tag, make, power):
    """``make(sharded)`` -> (trainer, state, step(state, k) -> logs, payload(state)):
    FSDP_WARMUP steps without a group, a host copy of the state's payload,
    then one step and FSDP_STEPS timed ones; then in an NCCL group of one on the
    (1, 1) process mesh the trainer made under the forced rule loads that
    payload into its sharded state (gathered again, it must be the same
    tensors), takes the same step (logs at REG_LOSS_RTOL, gradients gathered
    at REG_GRAD_FP32_TOL: phase 13's card tolerances) and the timed ones,
    its launches counted.  Returns the readings and the sharded run's
    launches."""
    import torch.distributed as dist

    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from slice3d_tpu_torch.parallel import full_tensor, init_process_mesh

    def run(state, step):
        model = _model_of(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logs = {key: float(v) for key, v in step(state, FSDP_WARMUP).items()}
        grads = {n: full_tensor(p.grad).detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        times = []
        for k in range(FSDP_WARMUP + 1, FSDP_WARMUP + 1 + FSDP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, k)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return {"logs": logs, "grads": grads, "ms": percentile(times, 0.5),
                "ms_range": (min(times), max(times)), "counts": read_counts(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    trainer, state, step, payload_of = make(False)
    for k in range(FSDP_WARMUP):
        step(state, k)
    payload = _cloned(payload_of(state))
    b = run(state, step)
    del trainer, state, step, payload_of
    gc.collect()
    torch.cuda.empty_cache()

    _init_group_of_one()
    init_process_mesh((1, 1))
    with forced_rule():
        trainer, state, step, payload_of = make(True)
    n_sharded = sum(isinstance(p, DTensor) for p in _model_of(state).parameters())
    n_units = sum(isinstance(m, FSDPModule) for m in _model_of(state).modules())
    check(n_sharded > 0, f"{tag}: the forced rule sharded nothing")
    trainer.load_payload(state, payload)
    check(_same_tensors(payload_of(state), payload),
          f"{tag}: the gathered payload differs from the one loaded")
    del payload
    a = run(state, step)
    del trainer, state, step, payload_of
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(abs(a["logs"][k] - v) / max(abs(v), 1e-12) for k, v in b["logs"].items())
    readings = regression_grad_readings(a["grads"], b["grads"], REG_GRAD_FP32_TOL)
    print(f"[fsdp] {tag}: {n_sharded} parameters sharded in {n_units} fully_shard units (the "
          f"rule at a model axis of {FSDP_FORCED_AXIS}, min_size {FSDP_MIN}) on the (1, 1) "
          f"mesh of an NCCL group of "
          f"one; ms per step p50 over {FSDP_STEPS} steps sharded {a['ms']:.4f} (min "
          f"{a['ms_range'][0]:.4f}, max {a['ms_range'][1]:.4f}), unsharded without a group "
          f"{b['ms']:.4f} (min {b['ms_range'][0]:.4f}, max {b['ms_range'][1]:.4f}); peak "
          f"{a['peak_gb']:.4f} / {b['peak_gb']:.4f} GB; step {FSDP_WARMUP} from one state: "
          f"logs max relative difference {worst:.3g} (tolerance {REG_LOSS_RTOL}), gradients "
          f"{readings} (tolerance {REG_GRAD_FP32_TOL} G, {REG_TIE_FRAC} of a tensor); "
          f"launches sharded over {1 + FSDP_STEPS} steps {a['counts']}; {power}")
    check(worst <= REG_LOSS_RTOL, f"{tag}: the sharded step's logs differ")
    check(readings["violations"] == 0, f"{tag}: the sharded step's gradients differ")
    return {"n_sharded": n_sharded, "n_units": n_units, "ms_sharded": a["ms"],
            "ms_unsharded": b["ms"], "ms_sharded_range": a["ms_range"],
            "ms_unsharded_range": b["ms_range"],
            "peak_gb_sharded": a["peak_gb"], "peak_gb_unsharded": b["peak_gb"],
            "log_rel_diff": worst, "grads": readings, "logs": a["logs"]}, a["counts"]


def _cloned(payload):
    """A copy of a nested payload in host memory (a payload holds the live
    state's tensors; the copy must not hold card memory while the steps'
    peaks are read)."""
    if isinstance(payload, dict):
        return {k: _cloned(v) for k, v in payload.items()}
    if isinstance(payload, list):
        return [_cloned(v) for v in payload]
    return payload.detach().to("cpu", copy=True) if isinstance(payload, torch.Tensor) else payload


def _same_tensors(a, b) -> bool:
    """Nested payloads equal: the same keys, and tensors of one dtype and
    shape with equal values."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
    return a == b


def fsdp_bytes(model, optimized, ema: bool) -> dict:
    """Per-card bytes of the parameters, Adam's two moments (``optimized``
    names) and an EMA (of the same names, when ``ema``) at each model axis
    of FSDP_AXES, from the placements of the rule (JAX's) at FSDP_MIN:
    computed, not measured (fp32 master weights, moments and EMA)."""
    from torch.distributed.tensor import Shard

    from slice3d_tpu_torch.parallel import fsdp_placements

    params = dict(model.named_parameters())
    out = {}
    for n_model in FSDP_AXES:
        placements = fsdp_placements(model, n_model, FSDP_MIN)
        local = {k: p.numel() * p.element_size()
                 // (n_model if isinstance(placements[k], Shard) else 1)
                 for k, p in params.items()}
        opt = sum(v for k, v in local.items() if optimized(k))
        out[n_model] = {"params": sum(local.values()), "adam": 2 * opt,
                        "ema": opt if ema else 0,
                        "sharded": sum(isinstance(pl, Shard) for pl in placements.values())}
        out[n_model]["total"] = sum(out[n_model][k] for k in ("params", "adam", "ema"))
    return out


def phase_fsdp(power: str):
    """Phase 16: parameters sharded over the model axis on the one card.  JAX's
    rule shards nothing at a model axis of 1 (and nothing at a min_size above
    every parameter); ``RegressionTrainer`` (SliceNet bf16 with VGG19, n_bs
    16) and ``LDMTrainer`` (batch 8) under the forced rule against their
    ungrouped steps (``_fsdp_step_pair``), the LDM's attention launches
    exact; the per-card bytes at model axes 1-8; then ``python -m
    slice3d_tpu_torch.dryrun`` in a group of its own."""
    import torch.distributed as dist

    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from torch.distributed.tensor import DTensor

    from slice3d_tpu_torch.parallel import (init_process_mesh, process_mesh,
                                            shard_params_fsdp)
    from slice3d_tpu_torch.profile_training import regression_batches, seeded_vgg19
    from slice3d_tpu_torch.train.train_ldm import TRAINABLE_PREFIXES, LDMTrainer
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "phase 16: a process group is still joined")
    steps = FSDP_WARMUP + 1 + FSDP_STEPS
    reg_batches = regression_batches(steps, torch.Generator(device="cuda").manual_seed(18),
                                     b=PAR_REG_BATCH, size=REG_IMG, n_qry=REG_QRY)
    vgg = seeded_vgg19()
    opts = Options(name_model="slicenet", n_bs=PAR_REG_BATCH, img_size=REG_IMG, n_qry=REG_QRY,
                   train_dtype="bfloat16")

    # JAX's rule at a model axis of 1, and above every parameter's size
    _init_group_of_one()
    mesh = init_process_mesh((1, 1))
    check(process_mesh() is mesh and mesh.device_mesh is not None, "phase 16: no (1, 1) mesh")
    state = RegressionTrainer(opts, vgg19=vgg, fsdp_min_size=FSDP_MIN).init_state()
    biggest = max(p.numel() for p in state.model.parameters())
    placed = shard_params_fsdp(state.model, mesh, min_size=biggest + 1)
    check(not any(isinstance(p, DTensor) for p in state.model.parameters())
          and all(type(pl).__name__ == "Replicate" for pl in placed.values()),
          "JAX's rule sharded a parameter at a model axis of 1")
    print(f"[fsdp] JAX's rule on the (1, 1) mesh: 0 of {len(placed)} SliceNet parameters "
          f"sharded at min_size {FSDP_MIN} and at {biggest + 1}")
    del state
    dist.destroy_process_group()

    def make_reg(sharded):
        trainer = RegressionTrainer(opts, vgg19=vgg, fsdp_min_size=FSDP_MIN)
        return (trainer, trainer.init_state(),
                lambda st, k: trainer.train_step(st, reg_batches[k])[1],
                lambda st: trainer.state_payload(st, 0))

    out, counts = {}, {}
    marks = {"rule": time.perf_counter() - t_phase}
    out["regression"], counts["regression"] = _fsdp_step_pair(
        "regression training, SliceNet bf16 + VGG19", make_reg, power)
    del reg_batches
    ldm_batches = train_batches(steps, PAR_LDM_BATCH,
                                torch.Generator(device="cuda").manual_seed(19))
    ldm_module = init_latent_diffusion(seed=0, dtype=torch.bfloat16)

    def make_ldm(sharded):
        trainer = LDMTrainer(module=ldm_module, batch_size=PAR_LDM_BATCH, fsdp_min_size=FSDP_MIN)
        state = trainer.init_state()
        if not sharded:
            trainer.maybe_set_scale(state, ldm_batches[0],
                                    torch.Generator(device="cuda").manual_seed(20))

        def step(st, k):  # step k's draws from its own seed
            g = torch.Generator(device="cuda").manual_seed(200 + k)
            return trainer.train_step(st, ldm_batches[k], g)[1]

        return trainer, state, step, trainer.state_payload

    marks["regression"] = time.perf_counter() - t_phase
    out["ldm"], counts["ldm"] = _fsdp_step_pair("LDM training, batch 8", make_ldm, power)
    marks["ldm"] = time.perf_counter() - t_phase
    c = counts["ldm"]
    check(c["spatial_attention"] == 10 * (1 + FSDP_STEPS)
          and c["spatial_attention_bwd"] == 10 * (1 + FSDP_STEPS),
          f"sharded LDM training launched {c}, expected 10 and 10 a step")
    check(counts["regression"]["fused_encoder_layer"] == 0, "regression training ran the head")
    del ldm_batches

    slicenet = RegressionTrainer(opts, vgg19=vgg, device="cpu").init_state().model
    table = {"slicenet": fsdp_bytes(slicenet, lambda k: True, ema=False),
             "ldm": fsdp_bytes(ldm_module, lambda k: k.startswith(TRAINABLE_PREFIXES),
                               ema=True)}
    for name, rows in table.items():
        cells = "; ".join(f"model {n}: {r['total']} bytes ({r['params']} parameters, "
                          f"{r['adam']} Adam, {r['ema']} EMA; {r['sharded']} sharded)"
                          for n, r in rows.items())
        print(f"[fsdp] per-card bytes, {name} (computed from the rule's placements at "
              f"min_size {FSDP_MIN}, fp32): {cells}")
    del slicenet, ldm_module

    t0 = time.perf_counter()
    dry = subprocess.run([sys.executable, "-m", "slice3d_tpu_torch.dryrun"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300)
    text = dry.stdout
    legs = [ln for ln in text.splitlines() if ln.startswith("dryrun_multichip ")]
    for ln in legs:
        print(f"[fsdp] {ln}")
    check(dry.returncode == 0 and len(legs) == 5, f"the dry run failed ({dry.returncode}):\n"
          f"{text[-3000:]}")
    out["dryrun"] = {"legs": legs, "s": time.perf_counter() - t0}
    out["bytes"] = table
    out["phase_s"] = time.perf_counter() - t_phase
    out["marks_s"] = dict(marks, bytes=t0 - t_phase, dryrun=out["phase_s"])
    total = {k: counts["regression"][k] + c[k] for k in c}
    print(f"[fsdp] phase 16 in {out['phase_s']:.4f} s (s from its start at the end of each "
          f"part: {out['marks_s']}); launches {total}; {power}")
    return out, total


CKPT_BACKENDS = ("msgpack", "orbax", "orbax_async")
CKPT_SHAPES = 8  # phase 14's synthetic dataset at one batch of 8
# each backend writes two ~5.3 GB checkpoints: ``last.ckpt`` at steps 1 and 2
# of the first run (the second save of ``orbax_async`` waits for the first
# write); the resume restores step 2 and takes step 3, whose closing save is
# recorded and not written
CKPT_LDM = dict(max_steps=2, ckpt_every=1, val_every=0, log_images_every=0)
CKPT_RESUME_STEPS = 3
CKPT_DIR = os.path.join(SMOKE_DIR, "ckpt")


class _HostPeak:
    """The peak resident set size of this process within the block, above
    its start (``/proc/self/statm`` read every 2 ms on a thread)."""

    def __enter__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _watch(self):
        while not self.stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def gb(self) -> float:
        return (self.peak - self.start) / 1e9


class _Gathers:
    """Counts the gathers of sharded tensors (``DTensor.full_tensor``, which
    ``parallel.full_tensor`` and ``full_state_dict`` run) within the block."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor

        self.cls, self.real, self.n = DTensor, DTensor.full_tensor, 0

        def counted(t, *a, **k):
            self.n += 1
            return self.real(t, *a, **k)

        DTensor.full_tensor = counted
        return self

    def __exit__(self, *exc):
        self.cls.full_tensor = self.real


def _flat(payload, prefix: str = "") -> dict:
    """A nested payload as {path: value}."""
    out = {}
    for k, v in payload.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


def _whole(payload) -> dict:
    """A payload's tensors gathered whole and copied (on their device), its
    other values as they are, flat."""
    from slice3d_tpu_torch.parallel import full_tensor

    return {k: full_tensor(v).detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in _flat(payload).items()}


def _bit_equal(got: dict, want: dict) -> list:
    """The paths where two flat payloads differ (keys, dtype, shape, value)."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        if isinstance(b, torch.Tensor):
            same = (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.to(b.device), b))
        else:
            same = a == b
        if not same:
            bad.append(k)
    return bad


def _disk_gb(path: str) -> float:
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9
    return os.path.getsize(path) / 1e9


def _ckpt_cli(data: str, backend: str, power: str):
    """(a) for one backend: ``main -t`` on configs/objaverse-ldm-kl-8.yaml for
    CKPT_LDM's 2 steps (``last.ckpt`` at 1 and 2), then ``-r`` to step
    CKPT_RESUME_STEPS (its closing save recorded, not written); each save
    timed (the loop blocked, and within it the wait for the write before
    it), its card and host memory above the save's start (the host's peak
    resident set, which a process's later saves may find already grown), the
    state at the last save of the first run kept on the card and held bit for
    bit to what the resume restores."""
    from slice3d_tpu_torch import main as gen_main
    from slice3d_tpu_torch.train import checkpoint as ckpt_mod
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    here = os.path.dirname(os.path.abspath(__file__))
    common = ["-b", os.path.join(here, "configs", "objaverse-ldm-kl-8.yaml"), "-t",
              "--data_root", data, "-s", "3", "--ckpt_backend", backend]
    flags = [f"--{k}={v}" for k, v in CKPT_LDM.items()]
    saves, kept, flushes, restored, waited, skipped = [], {}, [], [], [0.0], []
    real_save, real_restore, real_wait = LDMTrainer.save, LDMTrainer.restore, gen_main.wait_pending
    real_inner = ckpt_mod.wait_pending

    def inner_wait():  # a save's wait for the write before it (orbax_async)
        t0 = time.perf_counter()
        real_inner()
        waited[0] += (time.perf_counter() - t0) * 1e3

    def timed_save(self, state, path):
        if state.step > CKPT_LDM["max_steps"]:  # the resume's closing save
            skipped.append(state.step)
            return path
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        waited[0] = 0.0
        with _HostPeak() as host:
            t0 = time.perf_counter()
            out = real_save(self, state, path)
            ms = (time.perf_counter() - t0) * 1e3
        saves.append({"step": state.step, "ms": ms, "waited_ms": waited[0], "host_gb": host.gb,
                      "card_gb": (torch.cuda.max_memory_allocated() - before) / 1e9})
        if state.step == CKPT_LDM["max_steps"] and not kept:
            kept.update(_whole(self.shard_payload(state)))
        return out

    def checked_restore(self, state, path):
        t0 = time.perf_counter()
        state = real_restore(self, state, path)
        torch.cuda.synchronize()
        restored.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "bad": _bit_equal(_whole(self.shard_payload(state)), kept)})
        return state

    def timed_wait():
        t0 = time.perf_counter()
        real_wait()
        flushes.append((time.perf_counter() - t0) * 1e3)

    LDMTrainer.save, LDMTrainer.restore, gen_main.wait_pending = (timed_save, checked_restore,
                                                                    timed_wait)
    ckpt_mod.wait_pending = inner_wait
    try:
        logdir, steps, dt, counts, _ = run_train_main(
            f"ckpt {backend} train", common + ["-l", CKPT_DIR] + flags, LDMTrainer)
        last = os.path.join(logdir, "checkpoints", "last.ckpt")
        gb = _disk_gb(last)
        check(os.path.isdir(last) == (backend != "msgpack"), f"{backend}: last.ckpt {last}")
        ret, steps2, dt2, counts2, _ = run_train_main(
            f"ckpt {backend} resume", common + ["-r", logdir] + flags[1:]
            + [f"--max_steps={CKPT_RESUME_STEPS}"], LDMTrainer)
    finally:
        LDMTrainer.save, LDMTrainer.restore, gen_main.wait_pending = (real_save, real_restore,
                                                                        real_wait)
        ckpt_mod.wait_pending = real_inner
    shutil.rmtree(logdir, ignore_errors=True)
    n1, n2 = CKPT_LDM["max_steps"], CKPT_RESUME_STEPS - CKPT_LDM["max_steps"]
    check(ret == logdir and [s["step"] for s in steps + steps2]
          == list(range(1, CKPT_RESUME_STEPS + 1)),
          f"{backend}: steps {[s['step'] for s in steps + steps2]} in {ret}")
    check([s["step"] for s in saves] == [1, 2] and skipped == [CKPT_RESUME_STEPS],
          f"{backend}: saves at {saves}, not written at {skipped}")
    check(len(restored) == 1 and not restored[0]["bad"],
          f"{backend}: restored tensors differ from the saved state: {restored}")
    for c, n in ((counts, n1), (counts2, n2)):
        check(c["spatial_attention"] == 10 * n and c["spatial_attention_bwd"] == 10 * n,
              f"{backend}: attention launched {c} over {n} steps, expected 10 and 10 a step")
    ms = [s["ms"] for s in saves]
    own = [s["ms"] - s["waited_ms"] for s in saves]
    out = {"save_ms": ms, "save_ms_p50": percentile(ms, 0.5),
           "waited_ms": [s["waited_ms"] for s in saves], "own_ms_p50": percentile(own, 0.5),
           "gb": gb,
           "card_gb": [s["card_gb"] for s in saves], "host_gb": [s["host_gb"] for s in saves],
           "flush_ms": flushes, "restore_ms": restored[0]["ms"], "n_tensors": len(kept),
           "step_ms_p50": percentile([s["ms"] for s in steps[1:] + steps2], 0.5),
           "cli_s": [dt, dt2]}
    print(f"[ckpt] {backend}: the loop blocked per save {', '.join(f'{m:.4f}' for m in ms)} ms "
          f"(p50 {out['save_ms_p50']:.4f}), of which waiting for the write before "
          f"{', '.join(f'{m:.4f}' for m in out['waited_ms'])} ms (the rest's p50 "
          f"{out['own_ms_p50']:.4f}); {gb:.4f} GB written a checkpoint; card memory "
          f"above a save's start {max(out['card_gb']):.4f} GB, host {max(out['host_gb']):.4f} "
          f"GB; flushes {', '.join(f'{m:.4f}' for m in flushes)} ms; restore "
          f"{out['restore_ms']:.4f} ms, {len(kept)} tensors bit-equal to the saved state; "
          f"10 + 10 attention launches a step over {n1} + {n2} steps; step p50 "
          f"{out['step_ms_p50']:.4f} ms; the CLIs {dt:.4f} + {dt2:.4f} s; {power}")
    kept.clear()
    add = {k: counts[k] + counts2[k] for k in counts}
    return out, add


def _ckpt_sharded(power: str):
    """(b) phase 16's forced-sharded (1, 1) SliceNet and LDM states, one step
    each, saved as directories by the one process with no gather, restored
    into a fresh sharded and an unsharded state, both bit-equal."""
    import torch.distributed as dist

    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.parallel import init_process_mesh, is_sharded
    from slice3d_tpu_torch.profile_training import regression_batches, seeded_vgg19
    from slice3d_tpu_torch.train.checkpoint import save_checkpoint, wait_pending
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    _init_group_of_one()
    init_process_mesh((1, 1))
    vgg = seeded_vgg19()
    opts = Options(name_model="slicenet", n_bs=PAR_REG_BATCH, img_size=REG_IMG, n_qry=REG_QRY,
                   train_dtype="bfloat16")
    reg_batch = regression_batches(1, torch.Generator(device="cuda").manual_seed(21),
                                   b=PAR_REG_BATCH, size=REG_IMG, n_qry=REG_QRY)[0]
    ldm_batch = train_batches(1, PAR_LDM_BATCH, torch.Generator(device="cuda").manual_seed(22))[0]
    ldm_module = init_latent_diffusion(seed=0, dtype=torch.bfloat16)
    cases = {
        "slicenet": (lambda: RegressionTrainer(opts, vgg19=vgg, fsdp_min_size=FSDP_MIN),
                     lambda tr, st: tr.train_step(st, reg_batch),
                     lambda tr, st: tr.shard_payload(st, 0),
                     lambda tr, p: tr.restore(tr.init_state(), p)[0],
                     lambda st: st.model, ("orbax", "orbax_async")),
        "ldm": (lambda: LDMTrainer(module=ldm_module, batch_size=PAR_LDM_BATCH,
                                   fsdp_min_size=FSDP_MIN),
                lambda tr, st: tr.train_step(st, ldm_batch,
                                             torch.Generator(device="cuda").manual_seed(23)),
                lambda tr, st: tr.shard_payload(st),
                lambda tr, p: tr.restore(tr.init_state(), p),
                lambda st: st.ldm, ("orbax_async",))}
    out = {}
    os.makedirs(CKPT_DIR, exist_ok=True)
    for name, (make, step, payload_of, restored, model_of, backends) in cases.items():
        with forced_rule():
            trainer = make()
            state = trainer.init_state()
        check(is_sharded(model_of(state)), f"(b) {name}: the forced rule sharded nothing")
        step(trainer, state)
        want = _whole(payload_of(trainer, state))
        for backend in backends:
            path = os.path.join(CKPT_DIR, f"{name}_{backend}.ckpt")
            torch.cuda.synchronize()
            with _Gathers() as g:
                t0 = time.perf_counter()
                save_checkpoint(path, payload_of(trainer, state), backend)
                blocked = (time.perf_counter() - t0) * 1e3
                wait_pending()
                total = (time.perf_counter() - t0) * 1e3
            check(g.n == 0, f"(b) {name} {backend}: {g.n} gathers during the save")
            files = sorted(os.listdir(path))
            for sharded in (True, False):
                with forced_rule() if sharded else contextlib.nullcontext():
                    fresh = make()
                    got = restored(fresh, path)
                check(is_sharded(model_of(got)) == sharded, f"(b) {name}: restored layout")
                bad = _bit_equal(_whole(payload_of(fresh, got)), want)
                check(not bad, f"(b) {name} {backend} into a {'sharded' if sharded else 'plain'} "
                      f"state: {bad[:5]} differ")
                del fresh, got
            out[f"{name}_{backend}"] = {"blocked_ms": blocked, "total_ms": total,
                                        "gb": _disk_gb(path), "files": files, "gathers": g.n}
            print(f"[ckpt] (b) {name} {backend}: {len(want)} entries, {_disk_gb(path):.4f} GB in "
                  f"{files}; save blocked {blocked:.4f} ms, written {total:.4f} ms; 0 gathers; "
                  f"restored bit-equal into a sharded and into an unsharded state; {power}")
            shutil.rmtree(path)
        del trainer, state, want
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def _ckpt_load_model(power: str, device: str = "cuda"):
    """(c) one SliceNet object reconstructed through ``load_model`` from a
    ``RegressionTrainer`` directory and from a file of the same weights: the
    same grid and faces."""
    from slice3d_tpu_torch.config import Options
    from slice3d_tpu_torch.models.build import load_model
    from slice3d_tpu_torch.pipeline import Reconstructor
    from slice3d_tpu_torch.train.train_reg import RegressionTrainer

    paths = {}
    for backend in ("orbax", "msgpack"):
        opts = Options(name_model="slicenet", img_size=128, ckpt_backend=backend)
        trainer = RegressionTrainer(opts, device=device)
        state = trainer.init_state(seed=5)
        paths[backend] = trainer.save(state, os.path.join(CKPT_DIR, backend), 0, {})
        del trainer, state
    feed = make_feeds(1, seed=3)[0]
    inference = Options(name_model="slicenet", img_size=128, dtype="bfloat16")
    grids, faces = {}, {}
    reset_counts()
    threshold = None
    for backend, path in paths.items():
        model = load_model(inference, path).to(device)
        if threshold is None:
            probe, _ = Reconstructor(model, resolution0=16, upsampling_steps=0).build_grid(feed)
            threshold = float(1.0 / (1.0 + np.exp(-np.median(probe))))
        rec = Reconstructor(model, resolution0=SERVE_POINT["mc_res0"],
                            upsampling_steps=SERVE_POINT["mc_up_steps"],
                            chunk_size=SERVE_POINT["mc_chunk_size"], threshold=threshold)
        grids[backend] = rec.build_grid(feed)[0]
        mesh, _ = rec.reconstruct(feed)
        faces[backend] = len(mesh.faces)
        del model, rec
    counts = read_counts()
    same = bool(np.array_equal(grids["orbax"], grids["msgpack"]))
    check(same and faces["orbax"] == faces["msgpack"] and faces["orbax"] > 0,
          f"(c) load_model from a directory: grids equal {same}, faces {faces}")
    print(f"[ckpt] (c) load_model from a RegressionTrainer directory and from a file: grids "
          f"equal, {faces['orbax']} faces each; launches {counts}; {power}")
    return {"faces": faces["orbax"], "grid_equal": same}, counts


def phase_checkpoints(power: str):
    """Phase 17: checkpoint directories (``--ckpt_backend orbax`` /
    ``orbax_async``, ``torch.distributed.checkpoint``) against the msgpack
    file: (a) ``main -t`` at full width per backend, (b) sharded states, (c)
    ``load_model`` from a directory; ``_smoke/`` removed after."""
    from slice3d_tpu_torch.data.builders import create_synthetic_dataset

    t_phase = time.perf_counter()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = os.path.join(SMOKE_DIR, "data", "objaverse")
    create_synthetic_dataset(data, n_shapes=CKPT_SHAPES, n_views=12, img_size=128, n_sdf=64,
                             seed=4)
    marks = {"dataset": time.perf_counter() - t_phase}
    out, counts = {"cli": {}}, None
    try:
        for backend in CKPT_BACKENDS:
            out["cli"][backend], c = _ckpt_cli(data, backend, power)
            counts = c if counts is None else {k: counts[k] + c[k] for k in c}
            marks[backend] = time.perf_counter() - t_phase
        out["sharded"] = _ckpt_sharded(power)
        marks["sharded"] = time.perf_counter() - t_phase
        out["load_model"], c = _ckpt_load_model(power)
        counts = {k: counts[k] + c[k] for k in c}
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["marks_s"] = marks
    print(f"[ckpt] phase 17 in {out['phase_s']:.4f} s (s from its start at the end of each part: "
          f"{marks}); launches {counts}; {power}")
    return out, counts


JAX_ORBAX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slice3d_tpu_torch",
                         "train", "testdata", "jax_orbax")


def phase_jax_orbax(power: str):
    """Phase 18: the committed JAX orbax fixture read by the port's own zstd
    decoder and OCDBT / zarr reader, checked leaf by leaf against
    ``expected.json``, moved to the card and read back; its level-19 frame
    decoded and compared on the card with the start of the leaf it was cut
    from."""
    import hashlib

    from slice3d_tpu_torch.train import zstd
    from slice3d_tpu_torch.train.flax_msgpack import read_flax_checkpoint

    with open(os.path.join(JAX_ORBAX, "expected.json")) as f:
        expected = json.load(f)
    zstd.load_library()  # built in phase 2
    t0 = time.perf_counter()
    tree = read_flax_checkpoint(os.path.join(JAX_ORBAX, "state"))
    read_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(JAX_ORBAX, "level19.zst"), "rb") as f:
        frame = f.read()
    t0 = time.perf_counter()
    head = zstd.decompress(frame)
    level19_ms = (time.perf_counter() - t0) * 1e3

    def leaf(name):
        node = tree
        for k in name.split("/"):
            node = node[k]
        return node

    nbytes = 0
    for name, want in expected["leaves"].items():
        arr = leaf(name)
        got = [list(arr.shape), str(arr.dtype), hashlib.sha256(arr.tobytes()).hexdigest()]
        check(got == [want["shape"], want["dtype"], want["sha256"]],
              f"jax_orbax: leaf {name} read as {got[:2]}, expected {want}")
        dev = torch.from_numpy(np.ascontiguousarray(arr)).to("cuda")
        back = dev.cpu().numpy()
        check(back.dtype == arr.dtype and hashlib.sha256(back.tobytes()).hexdigest()
              == want["sha256"], f"jax_orbax: leaf {name} changed on its way to the card")
        nbytes += arr.nbytes
    check(all(leaf(n) is None for n in expected["none"]), "jax_orbax: a None entry")
    check(all(leaf(n) == {} for n in expected["empty"]), "jax_orbax: an empty entry")
    check(len(head) == expected["level19"]["size"]
          and hashlib.sha256(head).hexdigest() == expected["level19"]["sha256"],
          "jax_orbax: the level-19 frame")
    big = torch.from_numpy(leaf("params/big")).to("cuda").view(torch.uint8).flatten()
    cut = torch.frombuffer(bytearray(head), dtype=torch.uint8).to("cuda")
    same = bool(torch.equal(big[:cut.numel()], cut))
    check(same, "jax_orbax: the level-19 frame differs on the card from the leaf's start")
    out = {"build_ms": BUILD_S.get("zstd decoder", float("nan")) * 1e3, "read_ms": read_ms,
           "leaves": len(expected["leaves"]), "bytes": nbytes,
           "level19_ms": level19_ms, "level19_bytes": len(head), "card_equal": same}
    print(f"[jax_orbax] phase 18: decoder built in {out['build_ms']:.1f} ms (phase 2, in "
          f"parallel with the kernels); fixture read in {read_ms:.3f} ms ({out['leaves']} leaves, "
          f"{nbytes} bytes), every leaf as expected.json and equal after the card; level-19 frame "
          f"({len(frame)} -> {len(head)} bytes) in {level19_ms:.3f} ms, equal on the card to the "
          f"leaf's start; {power}")
    return out


def attention_f32_work(shape, sm_clock_hz: float, backward: bool):
    """(flops, exps, bytes, bound_ms, bound_by) of one fp32 attention call:
    its products as fp32 FMAs on the CUDA cores (132 SMs x 128 lanes x 2 at
    the clock: 4 T^2 DH a head forward, 10 backward), one exponential per
    logit, each input read and each output written once (fp32; the backward
    reads q, k, v, o, do and the row log-sum-exp and writes dq, dk, dv)."""
    b, h, t, dh = shape
    flops = (10 if backward else 4) * b * h * t * t * dh
    exps = b * h * t * t
    nbytes = (8 * b * h * t * dh + b * h * t if backward else 4 * b * h * t * dh) * 4
    times = {"operations (fp32 FMA)": flops / (132 * 128 * 2 * sm_clock_hz),
             "operations (exponentials)": exps / (SFU_PER_CLOCK * sm_clock_hz),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return flops, exps, nbytes, times[by] * 1e3, by


def _f32_readings(got, want, tol: dict, what: str, tf32_want=None) -> dict:
    """``got`` against ``want`` element-wise at ``tol`` (fatal), and, given,
    the plain version run with TF32 matmuls against the same ``want``: the
    control, whose violations are returned with the readings."""
    check(bool(all(torch.isfinite(g).all() for g in got)), f"{what}: not finite")
    out = {"max_abs_err": 0.0, "tf32_max_abs_err": 0.0, "tf32_violations": 0}
    for i, (g, w) in enumerate(zip(got, want)):
        check_close(g, w, tol, f"{what}[{i}], kernel vs plain (fp32)")
        out["max_abs_err"] = max(out["max_abs_err"], (g - w).abs().max().item())
        if tf32_want is not None:
            err = (tf32_want[i] - w).abs()
            out["tf32_max_abs_err"] = max(out["tf32_max_abs_err"], err.max().item())
            out["tf32_violations"] += int((err > tol["atol"] + tol["rtol"] * w.abs()).sum())
    return out


def phase_attention_f32(sm_clock_hz: float):
    """The fp32 forward and backward kernels at ATTN_SHAPES against the plain
    versions on the same fp32 inputs (TF32 off), with the plain version under
    TF32 matmuls as the control that must fail the tolerance; ms of the
    kernel, the plain version and ``scaled_dot_product_attention`` on the same
    fp32 tensors (forward, and backward through autograd), beside the bound."""
    from slice3d_tpu_torch.ops import spatial_attention as sa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(19)
    fwd, bwd = [], []
    for shape in ATTN_SHAPES:
        q, k = (2.0 * torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        v, do = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        scale = shape[-1] ** -0.5
        with tf32(False), torch.no_grad():
            got = sa.spatial_attention(q, k, v, scale)
            torch.cuda.synchronize()
            want = sa.spatial_attention_ref(q, k, v, scale)
            with tf32(True):
                control = sa.spatial_attention_ref(q, k, v, scale)
            r = _f32_readings([got], [want], ATTN_F32_TOL, f"spatial_attention_f32 {shape}",
                              [control])
            r["sdpa_max_abs_err"] = (sdpa(q, k, v, scale=scale) - want).abs().max().item()
            del got, want, control
            ms = cuda_ms(lambda: sa.spatial_attention(q, k, v, scale), 10)
            plain_ms = cuda_ms(lambda: sa.spatial_attention_ref(q, k, v, scale), 3)
            library_ms = cuda_ms(lambda: sdpa(q, k, v, scale=scale), 10)
        flops, exps, nbytes, bound_ms, by = attention_f32_work(shape, sm_clock_hz, False)
        fwd.append({"shape": list(shape), **r, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by,
                    "gflop": flops / 1e9, "gexp": exps / 1e9, "mbytes": nbytes / 1e6,
                    "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9})
        with tf32(False):
            qkv = [x.clone().requires_grad_() for x in (q, k, v)]
            out = sa.spatial_attention(*qkv, scale)
            got = torch.autograd.grad(out, qkv, do, retain_graph=True)
            torch.cuda.synchronize()
            want = sa.spatial_attention_bwd_ref(q, k, v, do, scale)
            with tf32(True):
                control = sa.spatial_attention_bwd_ref(q, k, v, do, scale)
            rb = _f32_readings(got, want, ATTN_BWD_F32_TOL,
                               f"spatial_attention_bwd_f32 {shape} (dq, dk, dv)", control)
            del got, want, control
            out_k, lse = out.detach(), out.grad_fn.saved_tensors[4]
            ms_b = cuda_ms(lambda: sa._backward_kernel(q, k, v, out_k, lse, do, scale), 5)
            autograd_ms = cuda_ms(lambda: torch.autograd.grad(out, qkv, do, retain_graph=True),
                                  5)
            plain_b = cuda_ms(lambda: sa.spatial_attention_bwd_ref(q, k, v, do, scale), 2)
            lib_out = sdpa(*qkv, scale=scale)
            library_b = cuda_ms(lambda: torch.autograd.grad(lib_out, qkv, do,
                                                            retain_graph=True), 5)
            del out, lib_out, qkv, lse
        flops, exps, nbytes, bound_b, by = attention_f32_work(shape, sm_clock_hz, True)
        bwd.append({"shape": list(shape), **rb, "ms": ms_b, "autograd_ms": autograd_ms,
                    "plain_ms": plain_b, "library_ms": library_b, "bound_ms": bound_b,
                    "bound_by": by, "gflop": flops / 1e9, "gexp": exps / 1e9,
                    "mbytes": nbytes / 1e6, "bound_share": bound_b / ms_b,
                    "tflops": flops / ms_b / 1e9})
        for name, m in (("spatial_attention_f32", fwd[-1]), ("spatial_attention_bwd_f32",
                                                              bwd[-1])):
            print(f"[kernel] {name} {shape}: kernel {m['ms']:.4f} ms"
                  + (f" (through autograd {m['autograd_ms']:.4f} ms)" if "autograd_ms" in m
                     else "")
                  + f", plain {m['plain_ms']:.4f} ms, library (scaled_dot_product_attention"
                  f"{' backward, through autograd' if 'autograd_ms' in m else ''}, fp32) "
                  f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by "
                  f"{m['bound_by']} ({m['gflop']:.2f} GFLOP, {m['gexp']:.4f} G exp, "
                  f"{m['mbytes']:.2f} MB; {m['tflops']:.2f} TFLOP/s, bound / kernel "
                  f"{m['bound_share']:.4f}); max_abs_err {m['max_abs_err']:.6g}, the plain "
                  f"version with TF32 matmuls {m['tf32_max_abs_err']:.6g} "
                  f"({m['tf32_violations']} violations)")
        for name, m, tol in (("spatial_attention_f32", fwd[-1], ATTN_F32_TOL),
                             ("spatial_attention_bwd_f32", bwd[-1], ATTN_BWD_F32_TOL)):
            check(m["tf32_violations"] > 0, f"{name} {shape}: the plain version with TF32 "
                  f"matmuls passes |k-p| <= {tol['atol']} + {tol['rtol']}*|p|, so the "
                  "tolerance cannot tell fp32 from TF32")
    return fwd, bwd


def _ldm_f32_card_vs_cpu():
    """One tiny fp32 ``LDMTrainer`` step (TRAIN_TINY_F32: heads of 24, T =
    1024 at ds 1) on the CPU (the plain attention, which the CPU tests hold
    against the JAX package) and on the card (the fp32 kernels: 3 forward and
    3 backward launches), from the same weights, batch and draws: logs to
    REG_LOSS_RTOL, gradients to the regression trainers' tolerance with TF32
    off, which must agree, and on, which must not."""
    from slice3d_tpu_torch.diffusion.latent import init_latent_diffusion
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    tiny = init_latent_diffusion(seed=1, **TRAIN_TINY_F32)
    rng = np.random.default_rng(19)
    batch = {"image": rng.uniform(-1, 1, (2, 13, 16, 16, 3)).astype(np.float32),
             "img_ipt_view": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)}
    draws = {"posterior_noise": rng.normal(size=(2, 13, 8, 8, 4)).astype(np.float32),
             "t": np.array([3, 17]), "noise": rng.normal(size=(2, 32, 32, 4)).astype(np.float32)}

    def step(dev):
        tr = LDMTrainer(img_size=16, batch_size=2, timesteps=20, module=tiny, device=dev)
        logs, grads = _ldm_grads(tr, tr.init_state(), batch, draws)
        return logs, {n: g.cpu() for n, g in grads.items()}

    c_logs, cpu = step("cpu")
    readings = {"cpu": c_logs}
    for on in (False, True):
        with tf32(on):
            reset_counts()
            g_logs, gpu = step("cuda")
            counts = read_counts()
        check(counts["spatial_attention_f32"] == 3 and counts["spatial_attention_bwd_f32"] == 3
              and counts["spatial_attention"] == 0 and counts["spatial_attention_bwd"] == 0,
              f"the tiny fp32 step on the card launched {counts}, expected 3 + 3 fp32")
        r = regression_grad_readings(gpu, cpu, REG_GRAD_FP32_TOL)
        r["log_rel_err"] = max(abs(g_logs[k] - c_logs[k]) / abs(c_logs[k]) for k in c_logs)
        r["card"] = g_logs
        ok = r["violations"] == 0 and r["log_rel_err"] <= REG_LOSS_RTOL
        mode = "TF32 on" if on else "fp32"
        print(f"[check] LDM step, tiny fp32 (heads of 24, T 1024 at ds 1), card ({mode}, the "
              f"fp32 attention kernels) vs CPU (plain attention): logs "
              f"{r['log_rel_err']:.6g} apart, relative (tolerance {REG_LOSS_RTOL}); gradients "
              f"max_abs_err {r['max_err_G']:.6g} G, {r['err_G_without_ties']:.6g} G with at "
              f"most {REG_TIE_FRAC} of a tensor set aside, largest tensor L2 error / its norm "
              f"{r['max_rel_l2']:.6g}; tolerance |card-cpu| <= {REG_GRAD_FP32_TOL['atol']}*G + "
              f"{REG_GRAD_FP32_TOL['rtol']}*|cpu|, violations {r['violations']}: "
              f"{'agree' if ok else 'disagree'}; launches {counts}")
        check(ok != on, "tiny fp32 LDM step, card vs CPU: "
              + ("the check did not see TF32" if on else "disagree"))
        readings["tf32" if on else "fp32"] = r
    return readings


def phase_fp32_attention(sm_clock_hz: float, power: str, bf16_step=None):
    """Phase 19: the fp32 attention kernels alone (``phase_attention_f32``),
    then the paths that run them: ``main -t --dtype float32`` and ``--mode
    sample --dtype float32`` (DDIM-20) at configs/objaverse-ldm-kl-8.yaml's
    widths on a synthetic dataset in ``_smoke/`` (removed after), with exact
    launch counts, and the tiny fp32 step card vs CPU.  ``bf16_step`` is
    phase 14's ms per step of the same config in bf16, printed beside."""
    from slice3d_tpu_torch.data.builders import create_synthetic_dataset
    from slice3d_tpu_torch.data.image import load_image
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    t_phase = time.perf_counter()
    fwd, bwd = phase_attention_f32(sm_clock_hz)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = os.path.join(SMOKE_DIR, "data", "objaverse")
    create_synthetic_dataset(data, n_shapes=F32_SHAPES, n_views=12, img_size=128, n_sdf=64,
                             seed=4)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "objaverse-ldm-kl-8.yaml")
    common = ["-b", config, "--data_root", data, "-s", "3", "--dtype", "float32"]
    counts_all = {}
    try:
        logdir, steps, dt, counts, peak = run_train_main(
            "f32 train", common + ["-t", "-l", os.path.join(SMOKE_DIR, "logs"),
                                   f"--max_steps={F32_STEPS}", "--ckpt_every=1000",
                                   "--val_every=0", "--log_images_every=0"], LDMTrainer)
        n = F32_STEPS
        check(counts["spatial_attention_f32"] == 10 * n
              and counts["spatial_attention_bwd_f32"] == 10 * n
              and counts["spatial_attention"] == 0 and counts["spatial_attention_bwd"] == 0,
              f"main -t --dtype float32: launches {counts} over {n} steps, expected 10 fp32 "
              "forward and 10 fp32 backward a step and no bf16 one")
        check([s["step"] for s in steps] == list(range(1, n + 1))
              and all(np.isfinite(v) for s in steps for v in s["logs"].values()),
              f"main -t --dtype float32: steps {[(s['step'], s['logs']) for s in steps]}")
        ms = _ms_stats(steps[1:])
        bf16 = (f"; phase 14's bf16 steps p50 {bf16_step['p50']:.4f}, min "
                f"{bf16_step['min']:.4f}, max {bf16_step['max']:.4f}" if bf16_step else "")
        print(f"[fp32] main -t --dtype float32: ms per step over steps {ms['steps']}: p50 "
              f"{ms['p50']:.4f}, min {ms['min']:.4f}, max {ms['max']:.4f}; peak memory "
              f"{peak:.4f} GB; the CLI {dt:.4f} s; 10 + 10 fp32 attention launches a step "
              f"(exact){bf16}; {power}")
        train = {"ms_per_step": ms, "step_ms": [s["ms"] for s in steps], "peak_gb": peak,
                 "cli_s": dt, "launches": counts, "losses": [s["logs"] for s in steps]}
        counts_all = dict(counts)

        ret, per_batch, dt_s, counts, batches = run_main(
            "f32 sample", common + ["-r", logdir, "--mode", "sample"] + F32_SAMPLE)
        check(ret == logdir and len(per_batch) == 1 and per_batch[0][1] == 8
              and set(batches) == {8}, f"--mode sample --dtype float32: {per_batch} in {ret}, "
              f"attention at batches {set(batches)}")
        check(counts["spatial_attention_f32"] == 200 and counts["spatial_attention_bwd_f32"] == 0
              and counts["spatial_attention"] == 0,
              f"--mode sample --dtype float32 (DDIM-20): launches {counts}, expected 200 fp32 "
              "forward and nothing else")
        mont = [load_image(os.path.join(logdir, "images_testing_sampled", f"0_{c}.png"))
                for c in range(8)]
        check(all(m.shape == (512, 512, 3) and m[:384].std() > 0 for m in mont),
              "--mode sample --dtype float32: a montage of the wrong shape or constant")
        print(f"[fp32] --mode sample --dtype float32, DDIM-20: {per_batch[0][2]:.4f} s per batch "
              f"of 8, 200 fp32 attention launches at batch 8 (exact); the CLI {dt_s:.4f} s; "
              f"{power}")
        sample = {"s_per_batch": per_batch[0][2], "cli_s": dt_s, "launches": counts}
        counts_all = {k: counts_all[k] + v for k, v in counts.items()}
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    tiny = _ldm_f32_card_vs_cpu()
    phase_s = time.perf_counter() - t_phase
    print(f"[fp32] phase 19 in {phase_s:.4f} s; launches {counts_all}; {power}")
    return {"forward": fwd, "backward": bwd, "train": train, "sample": sample,
            "card_vs_cpu": tiny, "phase_s": phase_s}, counts_all


def phase_parallel(power: str):
    """Phase 15: sharded reconstruction, training in an NCCL group of one and
    the CLIs' multi-card options; the launches under the path "parallel"."""
    t0 = time.perf_counter()
    recon, c1 = phase_parallel_reconstruction()
    train, c2 = phase_parallel_training(power)
    clis, c3 = phase_parallel_clis()
    counts = {k: c1[k] + c2[k] + c3[k] for k in c1}
    dt = time.perf_counter() - t0
    print(f"[parallel] phase 15 in {dt:.4f} s; launches {counts}; {power}")
    return {"reconstruction": recon, "training": train, "clis": clis, "phase_s": dt}, counts


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
    gentrain, gentrain_counts = phase_generation_training_cli(power)
    parallel, parallel_counts = phase_parallel(power)
    fsdp, fsdp_counts = phase_fsdp(power)
    ckpt, ckpt_counts = phase_checkpoints(power)
    jax_orbax = phase_jax_orbax(power)
    fp32, fp32_counts = phase_fp32_attention(clock * 1e6, power,
                                             gentrain["ldm"]["runs"]["train"]["ms_per_step"])
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")

    by_path = {"regression": main_counts, "generation": gen["counts"],
               "training": train["counts"], "serving": serve_counts, "split": split_counts,
               "options": options_counts, "generation_cli": gencli_counts,
               "regression_training": {k: sum(r["counts"][k] for r in regtrain.values()
                                              if isinstance(r, dict) and "counts" in r)
                                       for k in regcli_counts},
               "regression_cli": regcli_counts, "generation_training_cli": gentrain_counts,
               "parallel": parallel_counts, "fsdp": fsdp_counts, "checkpoints": ckpt_counts,
               "fp32": fp32_counts}
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
    attention_f32 = []
    for name, f32_modes, tol in (("spatial_attention_f32", fp32["forward"], ATTN_F32_TOL),
                                 ("spatial_attention_bwd_f32", fp32["backward"],
                                  ATTN_BWD_F32_TOL)):
        ds1 = f32_modes[0]
        attention_f32.append({
            "name": name, "route": "cuda", "source": ATTN_F32_SRC[name][0],
            "replaces": ATTN_F32_SRC[name][1],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {k: c[name] for k, c in by_path.items()},
            "max_abs_err": max(m["max_abs_err"] for m in f32_modes),
            "tol": f"|k-p| <= {tol['atol']} + {tol['rtol']}*|p|", "ms": ds1["ms"],
            "kernel_ms": ds1["ms"], "plain_ms": ds1["plain_ms"], "bound_ms": ds1["bound_ms"],
            "bound_by": "bytes" if ds1["bound_by"] == "bytes" else "operations",
            "library_ms": ds1["library_ms"], "modes": f32_modes})
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
                      "generation_cli": gencli, "regression_training": regtrain,
                      "generation_training_cli": gentrain, "parallel": parallel,
                      "fsdp": fsdp, "checkpoints": ckpt, "jax_orbax": jax_orbax,
                      "fp32": {k: v for k, v in fp32.items()
                               if k not in ("forward", "backward")}}))
    print(json.dumps({"kernels": [encoder, attention, attention_bwd, ffn, *attention_f32]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
