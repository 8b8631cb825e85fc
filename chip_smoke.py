"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its results as JSON lines:
  1. device and build: the card's name and power limit (nvidia-smi), then the
     nvcc build of every kernel in dpot_tpu_torch/csrc;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, with its CUDA-event time, the device time of its launches
     (torch.profiler), the plain version's time and the least time the card
     could take (its bound):
     - fused_gn_afno at the Ti block shapes (B in {1, 8, 20}): bf16 with
       tanh-GELU on the two-launch Hopper kernel (afno_hopper.cu) and f32
       with erf-GELU on the two-launch f32 Hopper kernel (afno_hopper_f32.cu,
       3xTF32 products), each in the same call as the five-launch general
       kernel (afno_fused.cu) on the same inputs, timed old, new, new, old;
       each at the init's weight scale, at N(0, 0.05^2) weights and with a
       non-GELU activation (silu); and at the DPOT-H block shapes (C 2048,
       8 AFNO blocks of 256 channels) bf16 on the two-launch kernel for
       256-channel blocks (afno_hopper_wide.cu) in the same way; at the
       DPOT-L block shapes (C 1536, 16 AFNO blocks of 96 channels, groups
       of 192) bf16 on afno_hopper_l.cu and f32 on afno_hopper_f32_l.cu in
       the same way, bf16 also at B = 16 (L's pretraining batch); the five
       shape gates against their mirrors in the CUDA sources;
     - its gradient (fused_gn_afno_vjp, torch ops, not a kernel) against
       torch.autograd through the plain version at the Ti block shapes of
       training (B = 20), with the plain version made to raise while the
       backward runs;
     - bias_act, all nine activations in f32 and bf16, at (8, 64, 64, 512)
       and at a ragged (3, 17, 5, 37), forward and gradient;
  3. serve: `python -m dpot_tpu_torch.cli.serve` in-process at DPOT-Ti full
     width and depth (seeded weights), bf16 and then f32 compute, each
     answering rollout requests over HTTP on 127.0.0.1; every served
     rollout is checked for shape and finite values, one against a direct
     loop over model(x), the kernel's launch count against depth x model
     applications (bf16 all on the Hopper path, f32 all on the f32 Hopper
     path), and the served model's forward on the card against the same
     weights' forward on the CPU (the plain versions there);
  4. step: where one model application's time goes at B = 1 and 8 (wall
     time, device busy time and idle share, the fused kernel's part);
  5. train: `python -m dpot_tpu_torch.cli.train` in-process at DPOT-Ti full
     width and depth on a synthetic 128x128 dataset (40 train and 4 test
     trajectories of 21 frames, 4 channels) with the optimization of
     configs/pretrain_tiny.yaml (adam, lr 1e-3, beta2 0.9, noise 5e-4,
     batch 20, T_ar 1, OneCycle with 1 warm-up epoch) for 3 epochs, in f32
     and then bf16: every loss finite, the kernel's launch count against
     depth x (train + eval model applications), by path as in serving, a
     resume from the last
     checkpoint stepped twice from the same state giving the same losses,
     and where a train step's time goes (wall, device busy, idle share,
     samples/s; the shares of the fused kernel with its bf16 weight
     copies, its VJP and the optimizer);
  6. train card vs CPU: one f32 Ti train step at B = 4 on shared weights,
     batch and noise, on the card and on the CPU: the loss and every
     parameter's gradient;
  7. DPOT-H (preset H: embed 2048, depth 27, 1.03 B parameters, seeded
     weights drawn once and reused) in bf16: served through the serve CLI
     (batches 1 and 2, steps 1 and 4), every answer against the same
     rollout on the card with fused_gn_afno's plain version, launches =
     depth x model applications, all on afno_hopper_wide.cu; one model
     application profiled at B = 1 and 8 as in phase 4; three adam train
     steps (noise 5e-4) at B = 64 through make_train_step: finite losses,
     launches = depth x steps on the same kernel, and where a step's time
     goes as in phase 5;
  8. eval_L: DPOT-L (preset L: embed 1536, depth 24, 16 AFNO blocks of 96
     channels, GroupNorm groups of 192; seeded weights written as a
     reference-layout .pth) evaluated through `python -m
     dpot_tpu_torch.cli.evaluate --metrics` in-process on a synthetic 128^2
     test set (24 trajectories, t_test 10, batch 8), bf16 and then f32:
     every number finite, launches = depth x applications, all on the
     kernel for 96-channel blocks of the compute type (afno_hopper_l.cu,
     afno_hopper_f32_l.cu), a rollout with AFNO weights redrawn against
     the same rollout with the mixer's plain version on the card and with
     plain mixers wrong on purpose, one application profiled at B = 1 and
     8 as in phase 4, peak memory;
  9. train_L: `python -m dpot_tpu_torch.cli.sweep --config_file <copy of
     configs/pretrain_large.yaml>` in-process, the copy's data cut (twelve
     synthetic sets of their namesakes' grids, channels and lengths, 2
     train and 2 test trajectories each, 2 epochs) and every other key the
     file's: DPOT-L at full width and depth, bf16, lamb, batch 16, remat.
     The steps exact, launches = depth x (2 x train + eval applications),
     all on afno_hopper_l.cu, every loss finite, the checkpoint restoring
     through restore_params; where a step's time goes as in phase 5, with
     the dense layers' f32->bf16 weight copies, and peak memory;
  10. remat_L: one bf16 L step at batch 16 with remat and without, from the
     same weights, batch and noise: the losses and every gradient compared
     (expected identical), each way's step time and peak memory;
  11. params_lp_L: five bf16 lamb L steps at batch 16 with the bf16 working
     copy of the parameters and without: each loss within 5 %, the copy the
     master's exact cast after every step, all launches on afno_hopper_l.cu,
     each way's step profile and weight-copy time;
  12. finetune_S: `python -m dpot_tpu_torch.cli.finetune` from a seeded
     4-channel DPOT-S .pth onto a synthetic 3-channel 128^2 set (40 train,
     8 test) with configs/dpot_finetune.yaml's optimization (load_components
     all) for 2 epochs in bf16: the units copied, finite losses, launches
     all on the Hopper kernel; then cli.evaluate --config_from_ckpt on the
     run's checkpoint directory, whose loss_full equals the loop's last
     test metric;
  13. varyres_Ti: cli.evaluate --varyres at DPOT-Ti over the 11 default
     resolutions, every loss finite, two of them (odd and even) against the
     same sweep with the mixer's plain version;
  14. convert_resume_serve: cli.convert turns the S .pth into a checkpoint
     directory, cli.train --resume_path takes one epoch from it from step
     0, cli.serve --resume_path serves it over HTTP, the answer against a
     direct loop over model(x).
One dispatch (CUDA graphs): on the card the eval rollouts (phases 5, 8, 9,
12, 14) and the served rollouts (3, 7, 14) replay one graph per shape after
an eager first call, whose launches count as the replays' do; the serve
phases' counts take in start()'s capture of every bucket; the plain- and
faulty-mixer rollouts of phase 8 each capture a graph of their own under
the mixer they test. Four phases hold the graphs against eager runs
(relative 1e-6 on losses, relative L2 1e-6 on weights, moments and
predictions, or the eager path's own spread where larger):
  15. dispatch_Ti (after phase 5): phase 5's bf16 run through the train CLI
     at --steps_per_dispatch 4 on a synthetic set of 180 trajectories (two
     4-step dispatches and one tail step an epoch, 2 epochs) against the
     same run at 1, twice: every per-step loss, launches exact; then a
     step's wall, device busy, idle share and samples/s at K = 1 and
     replayed at K = 4, and the loader's time per batch;
  16. rollouts (after eval_L in bf16): DPOT-Ti bf16 served in-process
     (RolloutServer) eager and graphed in turns at B = 1 and 8, 4 steps:
     request latency, application wall, every answer against a direct
     loop; DPOT-L bf16 evaluated at B = 8 eager and graphed in turns:
     avg_step_time, losses, one batch's predictions; launches exact;
  17. stale_weights: a Ti bf16 train step captured and replayed 3 times,
     with the eval rollout's graph replayed after each, against the same
     run eagerly; and a control rollout captured with cached bf16 weight
     copies, which must land above the limit;
  18. dispatch_L (after remat_L): one 2-step dispatch of bf16 lamb L steps
     at batch 16 with remat (train_L's model) against two eager steps from
     the same state, batches and noise: both losses, every weight and
     moment; each way's wall, device busy and peak memory.
The 3D fine-tuning path and the separable route (torch.fft, cuFFT on the
card, and einsums: no kernel, as in the JAX package, whose code there is
XLA), after phase 14:
  19. finetune3d_L: `python -m dpot_tpu_torch.cli.finetune3d` in-process,
     DPOT3D at DPOT-L's widths (embed 1536, depth 24, 16 AFNO blocks of 96,
     mlp_ratio 4, out_layer_dim 128; 598 M parameters) on a synthetic set
     of ns3d_pdb_M1_turb's grid, channels and lengths (64^3, 5 channels, 21
     frames, t_test 11; 8 train and 4 test trajectories), patch 8, modes 32
     and temporal_modes 8, bf16, batch 4, 2 epochs, inflated from eval_L's
     seeded L .pth (4 channels, 128^2): the inflated count, finite losses,
     no fused_gn_afno launch, the checkpoint restoring; cli.evaluate
     --metrics on its checkpoint (loss_full = the loop's last test metric);
     where a train step's time goes (wall, busy, idle, samples/s; the
     shares of the cuFFT kernels, the mode MLP, out_layer.0's product, the
     other dense GEMMs and the optimizer), its peak memory, and the
     loader's time per batch;
  20. card_vs_cpu_3d: that model at depth 2 in f32, B = 1, its AFNO weights
     redrawn: the card's forward against the CPU's (relative L2 1e-4), a
     CPU mixer wrong on purpose (kw = Y//2+1, as 2D halves) above it; the
     3D eval rollout replayed as a graph against the eager one (1e-6), the
     cuFFT plan cache unchanged by the capture and the replay;
  21. separable_Ti: DPOT-Ti at img_size 512, patch 4 (a 16384-px latent)
     in f32 and bf16, B = 2: the card's forward against the CPU's (1e-4,
     3e-2), one train step with a finite loss, the route's calls = depth x
     applications and no fused_gn_afno launch; one application's wall,
     busy and idle.
The other model families (PR 11), after phase 21:
  22. train_cdpot: `python -m dpot_tpu_torch.cli.sweep --config_file <copy
     of configs/cdpot_parallel.yaml>` in-process, the copy's data cut as
     train_L's (twelve synthetic sets, 2 + 2 trajectories, 2 epochs) and
     every other key the file's: CDPOT at Ti widths (embed 512, depth 4,
     4 blocks of 128), f32, adam, batch 20. The steps exact, launches =
     depth x (train + eval applications), all on afno_hopper_f32.cu, every
     loss finite, the checkpoint restoring; where a step's time goes (the
     fused kernel, its VJP, the antialiased resampling, peak memory); then
     cli.evaluate --config_from_ckpt --metrics on the checkpoint (launches
     exact, loss_full against the loop's last test metric) and cli.serve of
     it in bf16 over HTTP (launches all on afno_hopper.cu, the answers
     against the same rollouts with the mixer's plain version);
  23. card_vs_cpu_families: a forward of CDPOT (the config's widths, AFNO
     weights redrawn), FNO2d (128^2, patch 1, width 64, 4 layers, modes
     16), UNet (128^2, width 32, eval mode) and FNO3d (32^3, width 32, 4
     layers, modes 8; the FNOs' spectral weights redrawn) on the card
     against the CPU, f32, FNO2d with torch.fft.irfftn's reading of a
     non-Hermitian spectrum on the card as a control above the limit; CDPOT's and UNet's
     eval rollouts replayed as graphs against eager; UNet's running
     statistics after two graphed 2-step dispatches against four eager
     steps; cli.convert of a seeded FNO3d reference .pth with torch.cfloat
     spectral weights, then cli.evaluate --metrics on a synthetic 32^3 set.
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
float32 matrix products run in full float32 (TF32 off, set below).
Any failure raises, so the script exits non-zero and prints no result. It
needs one CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from dpot_tpu_torch.ops.bias_act import activation_funcs, bias_act_ref
from dpot_tpu_torch.ops.cuda import afno_fused, build
from dpot_tpu_torch.ops.cuda.afno_fused import (
    fused_gn_afno,
    fused_gn_afno_ref,
    fused_gn_afno_vjp,
    hopper_f32_l_supported,
    hopper_f32_supported,
    hopper_l_supported,
    hopper_supported,
    hopper_wide_supported,
)
from dpot_tpu_torch.ops.cuda.bias_act import bias_act
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM3;
# TF32 tensor cores, which the f32 Hopper kernel runs three times per product
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

# DPOT-Ti serving geometry: 128^2 grid, patch 8 -> 16x16 latent, modes 32
TI = dict(H=16, W=16, C=512, nb=4, modes=32, groups=8, depth=4)
# DPOT-H (preset H) on the same grid: AFNO blocks of 256 channels
DPOT_H = dict(H=16, W=16, C=2048, nb=8, modes=32, groups=8, depth=27)
# DPOT-S (preset S) on the same grid: 8 AFNO blocks of 128 channels, each
# one GroupNorm(8) group
DPOT_S = dict(H=16, W=16, C=1024, nb=8, modes=32, groups=8, depth=6)
# DPOT-L (preset L) on the same grid: 16 AFNO blocks of 96 channels, so that
# GroupNorm(8)'s groups of 192 channels straddle two blocks (the kernels for
# 96-channel blocks, afno_hopper_l.cu and afno_hopper_f32_l.cu)
DPOT_L = dict(H=16, W=16, C=1536, nb=16, modes=32, groups=8, depth=24)
TI_FLAGS = [
    "--model", "DPOT", "--res", "128", "--patch_size", "8", "--width", "512",
    "--n_layers", "4", "--n_blocks", "4", "--modes", "32", "--mlp_ratio", "1",
    "--out_layer_dim", "32", "--T_in", "10", "--n_channels", "4",
    "--host", "127.0.0.1", "--port", "0",
]
# DPOT-H serving: preset H (embed 2048, depth 27, 8 blocks, mlp_ratio
# 3.951171875, out_layer_dim 128) on the same grid, at full width and depth
H_FLAGS = [
    "--model", "DPOT", "--res", "128", "--patch_size", "8", "--width", "2048",
    "--n_layers", "27", "--n_blocks", "8", "--modes", "32", "--mlp_ratio", "3.951171875",
    "--out_layer_dim", "128", "--T_in", "10", "--n_channels", "4",
    "--host", "127.0.0.1", "--port", "0",
]
TI_ARCH = TI_FLAGS[:TI_FLAGS.index("--host")]
# DPOT-L (preset L: mlp_ratio 4, out_layer_dim 128) and DPOT-S (preset S) at
# full width and depth on the same grid
L_ARCH = [
    "--model", "DPOT", "--res", "128", "--patch_size", "8", "--width", "1536",
    "--n_layers", "24", "--n_blocks", "16", "--modes", "32", "--mlp_ratio", "4",
    "--out_layer_dim", "128", "--T_in", "10",
]
S_ARCH = [
    "--model", "DPOT", "--res", "128", "--patch_size", "8", "--width", "1024",
    "--n_layers", "6", "--n_blocks", "8", "--modes", "32", "--mlp_ratio", "1",
    "--out_layer_dim", "32", "--T_in", "10",
]
# the evaluations' synthetic 128^2 test sets: three batches of 8 of one shape
# for L (one batch per shape would report avg_step_time 0.0); the fine-tune
# target with the 3 channels of ns2d_cond_pda; the resolution sweep's
EVAL_L_SPEC = dict(name="synthetic_eval_l", train_size=8, test_size=24, t_total=20,
                   t_test=10, in_size=(128, 128), n_channels=4)
FT_SPEC = dict(name="synthetic_ft_s", train_size=40, test_size=8, t_total=20, t_test=10,
               in_size=(128, 128), n_channels=3)
VARYRES_SPEC = dict(name="synthetic_varyres", train_size=8, test_size=8, t_total=20,
                    t_test=10, in_size=(128, 128), n_channels=4)
EVAL_BATCH = 8
# the kernel that serves DPOT-L's mixer in each compute type
L_PATH = {"bfloat16": "hopper_l", "float32": "hopper_f32_l"}
# the evaluations' plain-mixer comparisons: every AFNO weight of the
# smoke's copy of the model drawn from N(0, MIXER_SCALE^2), the kernel
# phase's MLP-dominated case (at the init's scale, U[0, 1) / bs^2, the mixer
# adds almost nothing to the normed input and a wrong one would pass); the
# rollout's predictions on the kernel against the plain mixer's, relative
# L2, at most MIXER_TOL[model/dtype]; the faults of MIXER_CAUGHT, plain
# mixers computed wrong on purpose, must land above it. Each limit lies
# between the readings on the card (NVIDIA H100 80GB HBM3, 700 W): L bf16
# kernel 4.7e-3, faults 3.7e-2 and up; L f32 kernel 8.7e-7, faults 1.9e-3
# and up; the Ti sweep at 41 px kernel 1.1e-3, faults 3.5e-3 and up
MIXER_SCALE = 0.05
MIXER_TOL = {"L/bfloat16": 1.3e-2, "L/float32": 2e-4, "Ti/bfloat16": 2e-3}
MIXER_FAULTS = ("block_groups", "conj_w2", "drop_mode")
# bf16 rounding through the model moves the predictions by about as much as
# the kernel's reading, whatever changes upstream: a fault smaller than that
# (drop_mode, 1.9e-3 at L in f32) is logged in bf16 but not required; the
# f32 comparison and the kernel phase's single calls catch it
MIXER_CAUGHT = {"float32": MIXER_FAULTS, "bfloat16": ("block_groups", "conj_w2")}
# the sweep's resolutions compared with the plain mixer's: one odd, one even
VARYRES_CHECKED = (41, 50)
# the fine-tune's copied units (JAX names), from the shapes: everything but
# the patch embedding and the last output layer, whose shapes follow the
# channel count
FT_COPIED = sorted([f"blocks_{i}" for i in range(DPOT_S["depth"])] + [
    "pos_embed", "time_agg", "cls_head_0", "cls_head_1", "cls_head_2", "out_deconv",
    "out_conv1"])
# the evaluator's loss_full against the train loop's last test metric on the
# same weights and rollout
FT_EVAL_TOL = 1e-3
# a served DPOT-H answer against the same rollout on the card with
# fused_gn_afno's plain version: a few bf16 roundings per layer that fall
# the other way, as card against CPU for Ti
H_SERVE_TOL = 3e-2
# DPOT-H train steps: adam with noise 5e-4 (configs/pretrain_tiny.yaml's
# optimizer). A step peaked at 29.0 GB at B = 16, 46.9 GB at B = 64 and
# 79.1 GB at B = 128 on the 80 GiB (85.9 GB) card: 64 is the largest power
# of two that leaves the allocator room (128 ran, within 7 GB of the card)
H_TRAIN = dict(batch=64, steps=3, lr=1e-4)
# kernel vs plain version: f32 differs by summation order only; bf16 may
# differ where one rounding of z, h or o to bf16 falls the other way
TOL = {
    torch.float32: dict(max_abs=5e-5, rel_l2=1e-5),
    torch.bfloat16: dict(max_abs_ulps=4, rel_l2=4e-3),
}
BF16_EPS = 2.0 ** -7
# whole forward, card against CPU on the same weights: f32 differs by
# summation order through ~20 layers; bf16 by a few bf16 roundings per layer
CPU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# VJP against autograd through the plain version, rel-L2 per cotangent: f32
# differs by summation order; in bf16 the kernel's forward and the VJP's
# recompute round z and h to bf16 independently, and a rounding that falls
# the other way moves a cotangent by one bf16 ulp (2^-8) there
VJP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bias_act kernel against its plain version, per element: the kernel
# computes in f32 and rounds once, the plain version rounds after each op;
# f32 agrees to 1e-6 relative, bf16 to two bf16 ulps of the value
BIAS_ACT_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -6, 2.0 ** -9)}
BIAS_ACT_SHAPES = ((8, 64, 64, 512), (3, 17, 5, 37))
# f32 operations per element besides the bias add, gain and clamp (4): an
# exp, tanh or log counts as one
BIAS_ACT_OPS = dict(linear=0, relu=1, lrelu=2, tanh=1, sigmoid=3, elu=2, selu=4,
                    softplus=5, swish=3)

# DPOT-Ti pretraining on a synthetic 128^2 dataset, with the optimization of
# configs/pretrain_tiny.yaml (its tasks: values; its 12 corpora are not here)
TRAIN_SPEC = dict(name="synthetic_ti", train_size=40, test_size=4, t_total=21,
                  t_test=10, in_size=(128, 128), n_channels=4)
TRAIN = dict(batch=20, epochs=3, t_ar=1, t_bundle=1)
TRAIN_FLAGS = [
    "--model", "DPOT", "--train_paths", "synthetic_ti", "--res", "128",
    "--patch_size", "8", "--width", "512", "--n_layers", "4", "--n_blocks", "4",
    "--modes", "32", "--mlp_ratio", "1", "--T_in", "10",
    "--T_ar", str(TRAIN["t_ar"]), "--T_bundle", str(TRAIN["t_bundle"]),
    "--opt", "adam", "--lr", "1e-3", "--beta1", "0.9", "--beta2", "0.9",
    "--noise_scale", "5e-4", "--batch_size", str(TRAIN["batch"]),
    "--lr_method", "cycle", "--warmup_epochs", "1", "--epochs", str(TRAIN["epochs"]),
    "--num_workers", "4", "--use_writer", "true", "--seed", "0",
]
# one Ti train step, card against CPU on shared weights, batch and noise: the
# loss through ~20 layers differs by f32 summation order, and the gradients
# by that order through the backward as well
TRAIN_CPU_TOL = dict(loss=1e-5, grad=1e-4)
# a resumed step on the card against the same step resumed again: the same
# state and batch; cuBLAS may order a reduction differently from call to call
RESUME_TOL = 1e-6
ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "build" / "chip_smoke"
# DPOT-L pretraining through the sweep CLI from a copy of
# configs/pretrain_large.yaml with only its data cut: each of the file's
# twelve corpora is stood in for by an in-memory synthetic set with its
# namesake's grid, channels and trajectory and rollout lengths (the port's
# data registry), `ntrain` trajectories to train (ntrain_list) and `ntest`
# to test, for `epochs` epochs; the run's logs go under the smoke's
# directory (log_path). Every other key is the file's: width 1536, depth 24,
# 16 blocks, bf16, lamb, remat, batch 16, noise 5e-4, lr 5e-4, cycle
L_CONFIG = ROOT / "configs" / "pretrain_large.yaml"
TRAIN_L = dict(epochs=2, ntrain=2, ntest=2)
# one bf16 L step at batch 16 with remat and without, from the same weights,
# batch and noise: the recomputation runs the same kernels on the same
# inputs, so the two are expected to be identical
REMAT_TOL = dict(loss=1e-6, grad=1e-3)
# five bf16 L steps (lamb, batch 16, batches of the cut corpora) with the
# bf16 working copy and without: each loss within 5 % (JAX's bar for the
# working copy, tests/test_bf16_params.py). lr is a tenth of the file's
# peak, a point of its warm-up: this lamb has no trust ratio, so at the
# peak every weight moves by about lr a step, 2 % of a typical L weight
# (1/sqrt(1536)); the file reaches the peak after 200 warm-up epochs, and
# a fresh L taken there at once diverges, with the working copy or without
# (PERF.md, section 6)
PARAMS_LP = dict(steps=5, loss_rel=0.05, lr=5e-5)
L_BATCH = 16
# one dispatch (CUDA graphs): graph against eager runs the same kernels on
# the same inputs, so the two are expected to be bitwise equal. Losses are
# held to relative GRAPH_TOL, weights, moments and predictions to relative
# L2 GRAPH_TOL, unless the eager path's own run-to-run spread, measured in
# the same phase and logged, is larger: that spread is then the limit
GRAPH_TOL = 1e-6
# finetune3d_L: DPOT3D at DPOT-L's widths (embed 1536, depth 24, 16 AFNO
# blocks of 96, groups of 192, mlp_ratio 4, out_layer_dim 128) on a
# synthetic set of ns3d_pdb_M1_turb's grid, channels and lengths (64^3, 5
# channels, 21 frames, t_test 11), 8 train and 4 test trajectories, patch 8
# (an 8^3 latent), T_in 10, modes 32 and temporal_modes 8, bf16, batch 4,
# 2 epochs, inflated from the L .pth that eval_L writes (4 channels, 128^2)
FT3D_SPEC = dict(name="synthetic_ns3d_l", train_size=8, test_size=4, t_total=21, t_test=11,
                 in_size=(64, 64, 64), n_channels=5)
FT3D = dict(batch=4, epochs=2)
L3D = dict(img_size=64, patch_size=8, in_channels=5, in_timesteps=10, embed_dim=1536,
           n_blocks=16, mlp_ratio=4.0, out_layer_dim=128, modes=32, n_cls=1)
L3D_ARCH = ["--res", "64", "--patch_size", "8", "--width", "1536", "--n_layers", "24",
            "--n_blocks", "16", "--mlp_ratio", "4", "--out_layer_dim", "128", "--modes", "32",
            "--T_in", "10"]
# the entries the 2D->3D inflation copies from L: 12 a trunk block (both
# norms, the four AFNO tensors, the MLP's two weights and biases) and the
# time aggregator's w and gamma
FT3D_INFLATED = 12 * DPOT_L["depth"] + 2
# card_vs_cpu_3d: that model at depth 2, f32, B = 1, its AFNO weights
# redrawn; the 3D eval rollout's steps for the graph against eager
CPU3D_DEPTH = 2
ROLL3D_STEPS = 3
# separable_Ti: DPOT-Ti at img_size 512, patch 4 (a 128^2 = 16384 px latent)
SEP_TI = dict(preset="Ti", img_size=512, patch_size=4, in_channels=4, in_timesteps=10,
              n_cls=1)
SEP_BATCH = 2
# dispatch_Ti: the train phase's bf16 run (configs/pretrain_tiny.yaml's
# optimization, batch 20) at 4 steps a dispatch on a synthetic set of 180
# trajectories (two full dispatches and one tail step an epoch), against
# the same run at 1 step a dispatch, twice, from the same seed
DISPATCH_K = 4
DISPATCH_SPEC = dict(TRAIN_SPEC, name="synthetic_ti_dispatch", train_size=180)
DISPATCH_EPOCHS = 2
# dispatch_L: one dispatch of 2 bf16 lamb steps of train_L's model (remat,
# batch 16, corpus batches, params_lp_L's lr) against two eager steps
DISPATCH_L_K = 2
# rollouts: the served Ti bf16 rollout at 4 steps, 20 requests of each
# batch, and as many rollouts timed directly
ROLLOUT_STEPS = 4
ROLLOUT_REQUESTS = 20
# stale weights: a Ti bf16 step at batch 4 captured, then replayed 3 times,
# with the eval rollout's graph (t_test 2) replayed after each
STALE = dict(batch=4, replays=3, t_test=2)
# train_cdpot: CDPOT pretrained through the sweep CLI from a copy of
# configs/cdpot_parallel.yaml with only its data cut, as train_L's: the
# twelve corpora as synthetic sets of their namesakes' grids, channels and
# lengths, 2 train and 2 test trajectories each, 2 epochs; every other key
# the file's (Ti widths: embed 512, depth 4, 4 blocks of 128; patch 8, res
# 128, modes 32, adam, batch 20, cycle, f32). Its checkpoint is then
# evaluated (cli.evaluate --metrics, loss_full against the loop's within
# FT_EVAL_TOL) and served in bf16 (every answer within CDPOT_SERVE_TOL of
# the same rollout with the mixer's plain version)
CDPOT_CONFIG = ROOT / "configs" / "cdpot_parallel.yaml"
TRAIN_CDPOT = dict(epochs=2, ntrain=2, ntest=2)
CDPOT_SERVE_TOL = 3e-2
# card_vs_cpu_families: a forward of each family on the card against the
# CPU, f32 (CPU_TOL), at CDPOT's config widths (its AFNO weights redrawn from
# N(0, MIXER_SCALE^2)) and at sizes chosen to keep the phase short (the
# repository has no config of FNO or UNet): FNO2d at 128^2, patch 1, width
# 64, 4 layers, modes 16; UNet at 128^2, width 32 (out_layer_dim's
# default); FNO3d at 32^3, width 32, 4 layers, modes 8. Then the eval
# rollout (FAMILY_ROLL_STEPS frames) of CDPOT and UNet replayed as a graph
# against the eager one, UNet's running statistics after UNET_DISPATCH's
# graphed K-step dispatches against as many eager steps (GRAPH_TOL), and
# cli.convert of a seeded FNO3d reference .pth with torch.cfloat weights,
# then cli.evaluate --metrics on FNO3D_SPEC
FAMILY_SIZES = {
    "FNO": dict(img_size=128, patch_size=1, embed_dim=64, depth=4, modes=16),
    "UNet": dict(img_size=128, out_layer_dim=32),
    "FNO3D": dict(img_size=32, embed_dim=32, depth=4, modes=8),
}
FAMILY_BATCH = 2
# the FNOs' spectral weights are redrawn from N(0, FNO_SPECTRAL_SCALE^2), at
# which the spectral convolutions carry about half of the output (at their
# init scale, under 1 %); a forward with torch's own irfftn on the card,
# whose reading of a non-Hermitian spectrum is cuFFT's, must exceed the
# limit in 2D (the port drops the parts cuFFT reads otherwise,
# ops/spectral.py irfftn_pair)
FNO_SPECTRAL_SCALE = 0.25
FAMILY_ROLL_STEPS = 3
UNET_DISPATCH = dict(K=2, dispatches=2, batch=4, lr=1e-4)
FNO3D_SPEC = dict(name="synthetic_fno3d", train_size=2, test_size=4, t_total=14, t_test=4,
                  in_size=(32, 32, 32), n_channels=4)
FNO3D_ARCH = ["--res", "32", "--width", "32", "--n_layers", "4", "--modes", "8", "--T_in", "10"]


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over `runs` of one call's CUDA-event time, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# fused_gn_afno's launches by kernel name: the general path's five and the
# two of each Hopper path
GENERAL_KERNELS = ("gn_stats_kernel", "analysis_kernel", "mode_hidden_kernel",
                   "mode_out_kernel", "synthesis_kernel")
HOPPER_KERNELS = ("spectral_kernel", "spectral_wide_kernel", "spectral_l_kernel",
                  "tma_synthesis_kernel")
HOPPER_F32_KERNELS = ("spectral_f32_kernel", "spectral_f32_l_kernel", "synthesis_f32_kernel")
SUB_KERNELS = GENERAL_KERNELS + HOPPER_KERNELS + HOPPER_F32_KERNELS


def sub_kernel(name: str) -> str | None:
    """Which launch of fused_gn_afno a profiler event name is, or None."""
    m = re.search(r"::(\w+_kernel)\b", name)
    return m.group(1) if m and m.group(1) in SUB_KERNELS else None


def profile_events(fn, runs: int, record_shapes: bool = False) -> list:
    """torch.profiler events of `runs` calls of fn (with their inputs' shapes
    and types when `record_shapes`). The profiler now and then returns no
    device activity; it is then asked again, up to three times, and an
    empty list means that the device time was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events
    return []


def is_kernel(e) -> bool:
    """A device event of the card's own work: not the span that a profiler
    range (record_function) also draws on the device's timeline."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def union_us(events) -> float:
    """Device time in µs in which at least one of the events ran: the
    union of their intervals, so that the Hopper path's two launches,
    which overlap (programmatic dependent launch), count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_us(fn, runs: int) -> dict[str, float]:
    """Device time in µs, summed over `runs` calls of fn, of each CUDA kernel
    that fn launched, by name, from torch.profiler ({}: not measured)."""
    times: dict[str, float] = {}
    for e in profile_events(fn, runs):
        if is_kernel(e):
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    return times


def device_ms(fn, runs: int = 20) -> dict | None:
    """Device time per call of each launch of fused_gn_afno that fn made, in
    ms (a launch that waits on an earlier one counts its wait), the device
    time of the call (the union of its launches), and the launches per
    call that the profiler counted (None: not measured)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    events = profile_events(fn, runs)
    if not events:
        return None
    mine = [e for e in events if e.device_type == DeviceType.CUDA and sub_kernel(e.name)]
    out: dict = {}
    for e in mine:
        k = sub_kernel(e.name)
        out[k] = out.get(k, 0.0) + e.time_range.elapsed_us() / runs / 1e3
    out["total"] = union_us(mine) / runs / 1e3
    out["launches_per_call"] = len(mine) / runs
    return out


def host_us(fn, runs: int = 200) -> float:
    """Host time per call in µs: the time to enqueue `runs` calls back to
    back, without waiting for the card (the wrapper's own cost)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / runs * 1e6


@contextlib.contextmanager
def forced_path(path: str):
    """Send every fused_gn_afno call to one kernel, whatever the shape gate
    says: to run the five-launch kernel where a Hopper kernel applies."""
    real = afno_fused.kernel_path
    afno_fused.kernel_path = lambda *shapes: path
    try:
        yield
    finally:
        afno_fused.kernel_path = real


def afno_case(B: int, dtype: torch.dtype, weight_scale: float | None, seed: int,
              geo: dict = TI):
    """Seeded kernel arguments at the block geometry `geo` (TI, DPOT_S,
    DPOT_H or DPOT_L).
    weight_scale None draws the AFNO weights as the init does, scale *
    U[0, 1) with scale 1/bs^2; a number draws them from N(0,
    weight_scale^2) so the mode MLP matters."""
    H, W, C, nb, groups = geo["H"], geo["W"], geo["C"], geo["nb"], geo["groups"]
    bs = C // nb
    kh, kw = kept_modes(H, W, geo["modes"])
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    def w(shape):
        if weight_scale is None:
            return rng.random(shape) / (bs * bs)
        return rng.standard_normal(shape) * weight_scale

    A, Ainv = combined_spectral_ops(H, W, kh, kw, dtype, torch.device("cuda"))
    args = (
        t(rng.standard_normal((B, H * W, C)), dtype),
        t(1.0 + 0.1 * rng.standard_normal(C)),
        t(0.1 * rng.standard_normal(C)),
        A, Ainv,
        t(w((2, nb, bs, bs))), t(w((2, nb, bs))),
        t(w((2, nb, bs, bs))), t(w((2, nb, bs))),
    )
    return args, kh * kw, groups


# the kernels that read the bf16 weight copies, and those whose products are
# 3xTF32 on the tensor cores
BF16_WEIGHT_PATHS = ("hopper", "hopper_wide", "hopper_l")
TF32_PATHS = ("hopper_f32", "hopper_f32_l")


def afno_bound_ms(B: int, dtype: torch.dtype, K: int, path: str,
                  geo: dict = TI) -> tuple[float, str]:
    """Least time for one call on kernel `path` at the block geometry `geo`:
    operations over the peak for the operand type, or bytes (each input
    read once, the output written once) over HBM bandwidth, whichever is
    larger. The bf16 Hopper kernels read the cached bf16 copies of w1 and
    w2, the other kernels the f32 weights. The f32 Hopper kernels do each
    product three times (3xTF32) on the TF32 tensor cores (495 TFLOP/s);
    the general kernel's f32 products run on the FMA pipes (67 TFLOP/s)."""
    HW, C, nb = geo["H"] * geo["W"], geo["C"], geo["nb"]
    bs = C // nb
    s = torch.empty((), dtype=dtype).element_size()
    ws = 2 if path in BF16_WEIGHT_PATHS else 4
    flops = B * (2 * 2 * K * HW * C            # analysis A . xn
                 + 2 * 2 * K * (2 * bs) ** 2 * nb  # two MLP layers
                 + 2 * HW * 2 * K * C)          # synthesis Ainv . o
    nbytes = (2 * B * HW * C * s               # x in, out
              + 2 * 2 * K * HW * s             # A, Ainv
              + 2 * 2 * nb * bs * bs * ws      # w1, w2
              + 2 * 2 * nb * bs * 4            # b1, b2
              + 2 * C * 4)                     # gscale, gbias
    if path in TF32_PATHS:
        t_ops = 3 * flops / PEAK_TF32 * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_afno(B, dtype, weight_scale, seed, path, act="gelu", geo=TI) -> dict:
    """One fused_gn_afno call on kernel `path` against the plain version."""
    args, K, groups = afno_case(B, dtype, weight_scale, seed, geo)
    approx = dtype == torch.bfloat16
    before = fused_gn_afno.launches_by_path[path]
    with forced_path(path):
        got = fused_gn_afno(*args, K, groups, approx, act).float()
    want = fused_gn_afno_ref(*args, K, groups, approx, act).float()
    torch.cuda.synchronize()
    if fused_gn_afno.launches_by_path[path] != before + 1:
        raise AssertionError(f"fused_gn_afno B={B} {dtype}: no launch on the {path} path")
    if not torch.isfinite(got).all():
        raise AssertionError(f"fused_gn_afno B={B} {dtype} {path}: non-finite output")
    max_abs = (got - want).abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    tol = TOL[dtype]
    lim = tol.get("max_abs") or tol["max_abs_ulps"] * BF16_EPS * want.abs().max().item()
    if max_abs > lim or rel_l2 > tol["rel_l2"]:
        raise AssertionError(
            f"fused_gn_afno C={args[0].shape[-1]} B={B} {dtype} {path} {act} "
            f"scale={weight_scale}: max_abs "
            f"{max_abs} (limit {lim}), rel_l2 {rel_l2} (limit {tol['rel_l2']})"
        )
    return dict(args=args, K=K, groups=groups, approx=approx,
                max_abs_err=max_abs, rel_l2=rel_l2, max_abs_limit=lim)


def check_gate_mirror() -> int:
    """Each Hopper kernel's gate in afno_fused.py (hopper_supported, ...,
    hopper_f32_l_supported) against its mirror in the CUDA source
    (dpot_afno_hopper_supported, ...), on the presets and on shapes any of
    them may refuse."""
    gates = []
    for lib, gate, dtype in (("afno_hopper", hopper_supported, torch.bfloat16),
                             ("afno_hopper_wide", hopper_wide_supported, torch.bfloat16),
                             ("afno_hopper_l", hopper_l_supported, torch.bfloat16),
                             ("afno_hopper_f32", hopper_f32_supported, torch.float32),
                             ("afno_hopper_f32_l", hopper_f32_l_supported, torch.float32)):
        fn = getattr(build.load_library(lib), f"dpot_{lib}_supported")
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        gates.append((fn, gate, dtype))
    shapes = [(B, 256, C, 144, nb, 8) for B in (1, 20)
              for C, nb in ((512, 4), (1024, 8), (1536, 16), (2048, 8))]
    shapes += [(3, 64, 96, 9, 4, 8), (3, 48, 40, 15, 2, 4), (1, 128, 512, 40, 4, 8),
               (1, 128, 512, 80, 4, 8), (1, 256, 512, 4, 4, 8), (1, 256, 512, 143, 4, 8),
               (1, 256, 512, 160, 4, 8), (1, 256, 512, 164, 4, 8), (1, 256, 512, 144, 4, 2),
               (1, 256, 512, 144, 4, 4), (1, 256, 512, 144, 4, 16), (1, 256, 512, 144, 4, 64),
               (1, 256, 512, 144, 4, 128), (1, 256, 128, 144, 1, 8), (1, 256, 1024, 144, 8, 128),
               (1, 1024, 512, 144, 4, 8), (0, 256, 512, 144, 4, 8)]
    shapes += [(2, 64, 512, 16, 4, 8), (2, 4096, 512, 144, 4, 8), (1, 8192, 512, 144, 4, 8),
               (1, 96, 512, 40, 4, 8), (1, 32, 512, 10, 4, 8), (1, 256, 512, 9, 4, 8),
               (1, 256, 512, 2, 4, 8), (65535, 256, 512, 144, 4, 8), (65536, 256, 512, 144, 4, 8)]
    # the wide gate's edges: groups of 8 to 256 channels, one block, a
    # 128-px latent, groups that straddle blocks, ragged K, a latent too big
    shapes += [(1, 256, 2048, 144, 8, g) for g in (1, 4, 16, 64, 256, 512)]
    shapes += [(2, 128, 2048, 40, 8, 8), (2, 256, 256, 144, 1, 1), (2, 256, 256, 144, 1, 32),
               (2, 256, 512, 144, 2, 1), (2, 256, 2048, 160, 8, 8), (2, 256, 2048, 164, 8, 8),
               (2, 256, 2048, 142, 8, 8), (2, 512, 2048, 144, 8, 8), (2, 64, 2048, 16, 8, 8),
               (65535, 256, 2048, 144, 8, 8), (65536, 256, 2048, 144, 8, 8)]
    # the edges of the gates for 96-channel blocks: a group per block or
    # per pair, groups over three blocks or of 48 channels, C not a
    # multiple of 128 (bf16's synthesis tile) or of 64 (f32's), ragged K,
    # 2K at the bf16 limit and past it, latents of 64, 128, 512 and 1024 px
    shapes += [(2, 256, 384, 144, 4, g) for g in (1, 2, 4, 8)]
    shapes += [(2, 256, 1536, 144, 16, g) for g in (4, 16, 32)]
    shapes += [(2, 256, 192, 144, 2, 1), (2, 256, 192, 144, 2, 2), (2, 256, 96, 144, 1, 1),
               (2, 256, 576, 144, 6, 3), (2, 256, 1536, 160, 16, 8),
               (2, 256, 1536, 164, 16, 8), (2, 256, 1536, 142, 16, 8),
               (2, 256, 1536, 143, 16, 8), (2, 128, 384, 40, 4, 4), (2, 64, 384, 16, 4, 4),
               (2, 512, 384, 144, 4, 4), (2, 1024, 384, 144, 4, 4), (2, 96, 384, 40, 4, 4),
               (65535, 256, 1536, 144, 16, 8), (65536, 256, 1536, 144, 16, 8),
               (0, 256, 1536, 144, 16, 8)]
    for fn, gate, dtype in gates:
        for sh in shapes:
            if bool(fn(*sh)) != gate(*sh, dtype):
                raise AssertionError(f"{gate.__name__} differs from the CUDA source's at {sh}")
    return len(shapes)


def time_afno(r: dict, path: str) -> dict:
    """CUDA-event time per call (synchronised each call), device time of its
    launches and host time per call of fused_gn_afno on kernel `path`."""
    a, K, g, ap = r["args"], r["K"], r["groups"], r["approx"]
    with forced_path(path):
        return dict(ms=cuda_ms(lambda: fused_gn_afno(*a, K, g, ap)),
                    host_us=host_us(lambda: fused_gn_afno(*a, K, g, ap)),
                    device_ms=device_ms(lambda: fused_gn_afno(*a, K, g, ap)))


# the kernel phase's cases: (key prefix, block geometry, dtype, the
# five-launch kernel and the kernel that serves the shapes)
KERNEL_CASES = (("", TI, torch.bfloat16, ("general", "hopper")),
                ("", TI, torch.float32, ("general", "hopper_f32")),
                ("S/", DPOT_S, torch.bfloat16, ("general", "hopper")),
                ("H/", DPOT_H, torch.bfloat16, ("general", "hopper_wide")),
                ("L/", DPOT_L, torch.bfloat16, ("general", "hopper_l")),
                ("L/", DPOT_L, torch.float32, ("general", "hopper_f32_l")))
KERNEL_BATCHES = (1, 8, TRAIN["batch"])
# the batches of each case: L in bf16 also at the batch of its pretraining
CASE_BATCHES = {("L/", torch.bfloat16): (1, 8, L_BATCH, TRAIN["batch"])}


def phase_kernels() -> dict:
    """fused_gn_afno against its plain version on each kernel that serves a
    compute type at the Ti shapes, in bf16 at the DPOT-S and DPOT-H shapes
    and in both types at the DPOT-L shapes, each beside the five-launch
    kernel, and timed; returns per-config numbers."""
    log("kernel", name="fused_gn_afno", gate_mirror_shapes=check_gate_mirror())
    results = {}
    for prefix, geo, dtype, paths in KERNEL_CASES:
        dname = str(dtype).replace("torch.", "")
        for B in CASE_BATCHES.get((prefix, dtype), KERNEL_BATCHES):
            checks = {}
            for path in paths:
                check_afno(B, dtype, 0.05, 100 + B, path, geo=geo)          # MLP-dominated
                check_afno(B, dtype, 0.05, 300 + B, path, "silu", geo=geo)  # another act
                checks[path] = check_afno(B, dtype, None, B, path, geo=geo)  # the init's scale
            r = checks[paths[0]]  # the same inputs (seed B) on every path
            a, K, g, ap = r["args"], r["K"], r["groups"], r["approx"]
            # old, new, new, old: the five-launch kernel around a Hopper one
            runs = [(p, time_afno(r, p)) for p in paths + paths[::-1]]
            plain_ms = cuda_ms(lambda: fused_gn_afno_ref(*a, K, g, ap))
            for path in paths:
                bound, by = afno_bound_ms(B, dtype, K, path, geo)
                mine = [t for p, t in runs if p == path]
                dev = [t["device_ms"] for t in mine if t["device_ms"]]
                key = f"{prefix}{dname}/{path}/B{B}"
                results[key] = dict(
                    max_abs_err=checks[path]["max_abs_err"], rel_l2=checks[path]["rel_l2"],
                    max_abs_limit=checks[path]["max_abs_limit"],
                    ms=statistics.median(t["ms"] for t in mine), ms_each=[t["ms"] for t in mine],
                    host_us=statistics.median(t["host_us"] for t in mine),
                    device_ms=dev[-1] if dev else None,
                    device_ms_each=[d["total"] for d in dev],
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                )
                if path in TF32_PATHS:  # its work against the FMA peak too
                    results[key]["bound_fma_ms"] = afno_bound_ms(B, dtype, K, "general", geo)[0]
                log("kernel", name="fused_gn_afno", config=key, **results[key])
    return results


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _plain_forbidden(*args, **kwargs):
    raise AssertionError("the backward of fused_gn_afno ran its plain version")


def phase_vjp() -> dict:
    """The gradient of fused_gn_afno (its VJP, torch ops) against
    torch.autograd through the plain version, at the Ti block shapes of a
    train step (B = 20), in bf16/tanh and f32/erf. While the backward runs
    the plain version raises, so it cannot be what the backward computes."""
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        args, K, groups = afno_case(TRAIN["batch"], dtype, 0.05, seed=200)
        approx = dtype == torch.bfloat16
        leaves = [args[i].requires_grad_() for i in (0, 1, 2, 5, 6, 7, 8)]
        out = fused_gn_afno(*args, K, groups, approx)
        if type(out.grad_fn).__name__ != "FusedGnAfnoBackward":
            raise AssertionError(f"fused_gn_afno on the card has grad_fn {out.grad_fn}")
        gen = torch.Generator(device="cuda").manual_seed(201)
        g = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
        afno_fused.fused_gn_afno_ref = _plain_forbidden
        try:
            got = torch.autograd.grad(out, leaves, g)
        finally:
            afno_fused.fused_gn_afno_ref = fused_gn_afno_ref
        want = torch.autograd.grad(fused_gn_afno_ref(*args, K, groups, approx), leaves, g)
        torch.cuda.synchronize()
        names = ("x", "gscale", "gbias", "w1", "b1", "w2", "b2")
        rels = {n: rel_l2(a, b) for n, a, b in zip(names, got, want)}
        bad = {n: r for n, r in rels.items() if not r <= VJP_TOL[dtype]}
        if bad or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"fused_gn_afno VJP {dtype}: rel_l2 {bad} above "
                                 f"{VJP_TOL[dtype]} or non-finite")
        plain = [t.detach() for t in args]
        ms = cuda_ms(lambda: fused_gn_afno_vjp(g, *plain, K, groups, approx))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            fused_gn_afno_ref(*args, K, groups, approx), leaves, g))
        key = str(dtype).replace("torch.", "")
        results[key] = dict(batch=TRAIN["batch"], rel_l2=rels, limit=VJP_TOL[dtype],
                            vjp_ms=ms, autograd_through_plain_ms=plain_ms)
        log("vjp", name="fused_gn_afno_vjp", dtype=key, **results[key])
    return results


def bias_act_bound_ms(shape, dtype: torch.dtype, act: str) -> tuple[float, str]:
    """Least time for one call: x read and the output written once (the
    bias is C values), or its f32 operations over the f32 peak."""
    n, C = math.prod(shape), shape[-1]
    s = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * n + C) * s / PEAK_BYTES * 1e3
    t_ops = n * (4 + BIAS_ACT_OPS[act]) / PEAK_FLOPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_bias_act() -> dict:
    """bias_act against its plain version: every activation, f32 and bf16,
    without and with a clamp, forward and gradient (first order; the
    Function's backward differentiates the plain composition). Timed at
    (8, 64, 64, 512) without clamp."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for shape in BIAS_ACT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (2 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
            b = torch.randn(shape[-1], device="cuda", generator=gen).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            rtol, atol = BIAS_ACT_TOL[dtype]
            dname = str(dtype).replace("torch.", "")
            for act in sorted(activation_funcs):
                max_err = 0.0
                for clamp in (None, 3.0):
                    before = bias_act.launches
                    got = bias_act(x, b, act, clamp=clamp)
                    want = bias_act_ref(x, b, -1, act, clamp=clamp)
                    torch.cuda.synchronize()
                    if bias_act.launches != before + 1 or got.dtype != want.dtype:
                        raise AssertionError(f"bias_act {act} {dtype}: no launch or dtype "
                                             f"{got.dtype} != {want.dtype}")
                    err = (got.float() - want.float()).abs()
                    if not (err <= rtol * want.float().abs() + atol).all():
                        raise AssertionError(
                            f"bias_act {act} {dtype} {shape} clamp={clamp}: max error "
                            f"{err.max().item()} above {rtol}|y| + {atol}")
                    max_err = max(max_err, err.max().item())
                xs, bs = x.clone().requires_grad_(), b.clone().requires_grad_()
                got = torch.autograd.grad(bias_act(xs, bs, act), [xs, bs], g)
                want = torch.autograd.grad(bias_act_ref(xs, bs, -1, act), [xs, bs], g)
                grad_rel = max(rel_l2(a, w) for a, w in zip(got, want))
                if not grad_rel <= 1e-6:
                    raise AssertionError(f"bias_act {act} {dtype} gradient rel_l2 {grad_rel}")
                row = dict(shape=list(shape), dtype=dname, act=act, max_abs_err=max_err,
                           grad_rel_l2=grad_rel)
                if shape == BIAS_ACT_SHAPES[0]:
                    dev = kernel_us(lambda: bias_act(x, b, act), 20)
                    bound, by = bias_act_bound_ms(shape, dtype, act)
                    row.update(
                        ms=cuda_ms(lambda: bias_act(x, b, act)),
                        plain_ms=cuda_ms(lambda: bias_act_ref(x, b, -1, act)),
                        device_ms=sum(v for k, v in dev.items() if "bias_act_kernel" in k)
                        / 20 / 1e3 if dev else "not measured",
                        bound_ms=bound, bound_by=by,
                    )
                    results[f"{dname}/{act}"] = row
                log("kernel", name="bias_act", **row)
    return results


def post_rollout(port: int, body: bytes, steps: int) -> tuple[np.ndarray, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rollout?steps={steps}", data=body, method="POST"
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = np.load(io.BytesIO(r.read()))
    return out, (time.perf_counter() - t0) * 1e3


def npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def bf16_npy(x: np.ndarray) -> bytes:
    """A bfloat16 .npy body without ml_dtypes: the raw 16-bit words, saved
    as void-V2 (the descr numpy gives a bfloat16 array it cannot name)."""
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    return npy(bits.view("V2"))


def direct_rollout(model, x: np.ndarray, steps: int, wire: torch.dtype) -> torch.Tensor:
    carry = torch.from_numpy(x).to("cuda").to(wire)
    outs = []
    with torch.inference_mode():
        for _ in range(steps):
            im = model(carry)[0]
            outs.append(im)
            carry = torch.cat([carry[..., 1:, :], im.to(wire)], dim=-2)
    return torch.cat(outs, dim=-2).float()


def card_vs_cpu_forward(model, x: np.ndarray) -> float:
    """Relative L2 distance between the model's forward on the card (the
    CUDA kernel) and a copy of it on the CPU (the plain versions)."""
    cpu = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        want = cpu(torch.from_numpy(x))[0]
        got = model(torch.from_numpy(x).to("cuda"))[0].cpu()
    return ((got - want).norm() / want.norm()).item()


def warmup_applications(rs) -> int:
    """Model applications of a server's start() on the card: one batch of
    every bucket at each warm-up step count, each captured as a graph after
    its eager run (the capture itself launches nothing)."""
    return len(rs.batch_buckets) * sum(rs._warmup_steps)


def reset_launch_counts() -> None:
    from dpot_tpu_torch.ops.spectral import separable_gn_afno

    fused_gn_afno.launches = bias_act.launches = separable_gn_afno.calls = 0
    fused_gn_afno.launches_by_path.update(dict.fromkeys(afno_fused.PATHS, 0))


def check_paths(dtype: str, launches: int, want: str | None = None) -> dict:
    """Every launch of a run went through one kernel: by default, for Ti,
    the Hopper kernel in bf16 and the f32 Hopper kernel in f32."""
    want = want or ("hopper" if dtype == "bfloat16" else "hopper_f32")
    by_path = dict(fused_gn_afno.launches_by_path)
    if by_path[want] != launches or sum(by_path.values()) != launches:
        raise AssertionError(f"{dtype}: launches by path {by_path}, expected all "
                             f"{launches} on {want}")
    return by_path


def send_requests(port: int, batches, response_dtype: str, seed: int = 7) -> list[dict]:
    """Rollout requests of each batch size at steps 1 and 4, each sent as an
    f32 and as a bf16 .npy body; every answer checked for shape, dtype and
    finite values. Returns the requests with their answers."""
    rng = np.random.default_rng(seed)
    sent = []
    for B in batches:
        for steps in (1, 4):
            x = rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32)
            for body in (npy(x), bf16_npy(x)):
                pred, ms = post_rollout(port, body, steps)
                if pred.shape != (B, 128, 128, steps, 4):
                    raise AssertionError(f"served shape {pred.shape}")
                if pred.dtype != np.dtype(response_dtype):
                    raise AssertionError(f"served dtype {pred.dtype}")
                if not np.isfinite(pred).all():
                    raise AssertionError("served rollout has non-finite values")
                sent.append(dict(x=x, steps=steps, pred=pred, ms=ms))
    return sent


def phase_serve(dtype: str, response_dtype: str) -> dict:
    """Serve DPOT-Ti through the CLI and check every answer."""
    from dpot_tpu_torch.cli.serve import main as serve_main

    reset_launch_counts()
    httpd, rs = serve_main(
        TI_FLAGS + ["--dtype", dtype, "--response_dtype", response_dtype,
                    "--device", "cuda"],
        wait=False,
    )
    try:
        port = httpd.server_address[1]
        sent = send_requests(port, (1, 2, 4), response_dtype)
        # the warm-up batches, then the requests (the first of each new
        # bucket and step count eager, the rest replays of its graph)
        applications = warmup_applications(rs) + sum(r["steps"] for r in sent)
        lat = [r["ms"] for r in sent]
        kept = next((r["x"], r["pred"]) for r in sent
                    if r["x"].shape[0] == 1 and r["steps"] == 4)
        torch.cuda.synchronize()
        launches, bias_act_launches = fused_gn_afno.launches, bias_act.launches
        want_launches = TI["depth"] * applications
        if launches != want_launches:
            raise AssertionError(
                f"fused_gn_afno launched {launches} times, expected depth x "
                f"applications = {want_launches}"
            )
        by_path = check_paths(dtype, launches)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        # the same request, replayed as a direct loop over model(x)
        x, pred = kept
        wire = torch.bfloat16 if rs.wire_dtype == "bfloat16" else torch.float32
        ref = direct_rollout(rs.model, x, 4, wire).to(getattr(torch, response_dtype))
        ref = ref.float().cpu()
        got = torch.from_numpy(pred.astype(np.float32))
        rel = ((got - ref).norm() / ref.norm()).item()
        if rel > 1e-5:
            raise AssertionError(f"served rollout differs from a direct loop: rel_l2 {rel}")
        cpu_rel = card_vs_cpu_forward(rs.model, x)
        if cpu_rel > CPU_TOL[dtype]:
            raise AssertionError(
                f"{dtype} forward on the card differs from the CPU's: rel_l2 {cpu_rel} "
                f"(limit {CPU_TOL[dtype]})"
            )
        out = dict(
            dtype=dtype, response_dtype=response_dtype, requests=len(lat),
            applications=applications, launches=launches, launches_by_path=by_path,
            bias_act_launches=bias_act_launches, client_p50_ms=statistics.median(lat), client_ms=lat,
            direct_loop_rel_l2=rel, card_vs_cpu_rel_l2=cpu_rel,
            card_vs_cpu_limit=CPU_TOL[dtype], metrics=metrics,
        )
        log("serve", **out)
        return out
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()


@contextlib.contextmanager
def plain_mixer(mixer=fused_gn_afno_ref):
    """Every fused_gn_afno call of the model runs `mixer`, by default its
    plain version, on the card: the reference rollout of the DPOT-H serve
    phase and of the evaluations."""
    from dpot_tpu_torch.models import dpot

    real = dpot.fused_gn_afno
    dpot.fused_gn_afno = mixer
    try:
        yield
    finally:
        dpot.fused_gn_afno = real


def faulty_mixer(fault: str):
    """fused_gn_afno's plain version with one fault a kernel could make:
    GroupNorm statistics per AFNO block instead of per group
    ("block_groups"), the second layer's imaginary weights negated
    ("conj_w2"), or the last kept mode left out of the synthesis
    ("drop_mode")."""

    def mix(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups=8, approximate=True,
            act="gelu"):
        if fault == "block_groups":
            groups = w1.shape[1]
        elif fault == "conj_w2":
            w2 = torch.stack([w2[0], -w2[1]])
        elif fault == "drop_mode":
            # two single-column fills: an index list would be a host-to-device
            # copy, which a CUDA graph's capture refuses
            Ainv = Ainv.clone()
            Ainv[:, K - 1] = 0
            Ainv[:, 2 * K - 1] = 0
        else:
            raise ValueError(fault)
        return fused_gn_afno_ref(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups,
                                 approximate, act)

    return mix


def draw_mixer_weights(model, seed: int) -> None:
    """Every AFNO weight and bias of `model` from N(0, MIXER_SCALE^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            for w in (blk.filter.w1, blk.filter.b1, blk.filter.w2, blk.filter.b2):
                w.copy_(torch.randn(w.shape, generator=g) * MIXER_SCALE)


def mixer_readings(preds, model: str, dtype: str, what: str) -> dict:
    """Relative L2 of the predictions `preds()` (B, H, W, T, C) on the
    kernel and with each faulty plain mixer from the plain mixer's, over
    the rollout and per step; the kernel's must be at most
    MIXER_TOL[model/dtype] and each fault of MIXER_CAUGHT[dtype] above it.
    The plain runs must launch no kernel."""
    limit = MIXER_TOL[f"{model}/{dtype}"]
    got = preds()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite predictions on the kernel")
    before = fused_gn_afno.launches
    with plain_mixer():
        want = preds()
    runs = {"kernel": got}
    for fault in MIXER_FAULTS:
        with plain_mixer(faulty_mixer(fault)):
            runs[fault] = preds()
    check_no_launch(before, f"{what} with the plain mixers")
    norm = functools.partial(torch.linalg.vector_norm, dim=(0, 1, 2, 4))
    readings = {name: dict(rel_l2=rel_l2(p, want), per_step=(
        norm(p.float() - want.float()) / norm(want.float())).tolist())
        for name, p in runs.items()}
    log("mixer_check", what=what, limit=limit, caught=MIXER_CAUGHT[dtype], **readings)
    wrong = min(readings[f]["rel_l2"] for f in MIXER_CAUGHT[dtype])
    if not readings["kernel"]["rel_l2"] <= limit < wrong:
        raise AssertionError(
            f"{what}: predictions' rel-L2 from the plain mixer's {readings['kernel']['rel_l2']} "
            f"on the kernel, {wrong} at the least with a fault of {MIXER_CAUGHT[dtype]}: the "
            f"limit {limit} must lie between")
    return {name: r["rel_l2"] for name, r in readings.items()}


def phase_serve_h() -> tuple[dict, torch.nn.Module]:
    """Serve DPOT-H in bf16 through the CLI: every launch on the kernel for
    AFNO blocks of 256 channels, depth x model applications of them, and
    every answer against the same rollout on the card in which
    fused_gn_afno runs its plain version. Returns the row and the served
    model, which the H step and train phases reuse (1.03 B parameters,
    drawn once)."""
    from dpot_tpu_torch.cli.serve import main as serve_main

    reset_launch_counts()
    httpd, rs = serve_main(
        H_FLAGS + ["--dtype", "bfloat16", "--response_dtype", "float32", "--device", "cuda"],
        wait=False,
    )
    try:
        sent = send_requests(httpd.server_address[1], (1, 2), "float32", seed=8)
        torch.cuda.synchronize()
        launches, bias_act_launches = fused_gn_afno.launches, bias_act.launches
        applications = warmup_applications(rs) + sum(r["steps"] for r in sent)
        if launches != DPOT_H["depth"] * applications:
            raise AssertionError(
                f"DPOT-H: fused_gn_afno launched {launches} times, expected depth x "
                f"applications = {DPOT_H['depth'] * applications}")
        by_path = check_paths("bfloat16", launches, "hopper_wide")
        wire = torch.bfloat16 if rs.wire_dtype == "bfloat16" else torch.float32
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()
    with plain_mixer():
        rels = [rel_l2(torch.from_numpy(r["pred"]),
                       direct_rollout(rs.model, r["x"], r["steps"], wire).cpu())
                for r in sent]
    if not max(rels) <= H_SERVE_TOL:
        raise AssertionError(f"DPOT-H answers differ from the plain mixer's rollout: rel_l2 "
                             f"{rels} (limit {H_SERVE_TOL})")
    out = dict(dtype="bfloat16", requests=len(sent), applications=applications,
               launches=launches, launches_by_path=by_path, bias_act_launches=bias_act_launches,
               client_p50_ms=statistics.median(r["ms"] for r in sent),
               client_ms=[r["ms"] for r in sent], plain_mixer_rel_l2=rels,
               plain_mixer_limit=H_SERVE_TOL, params_m=rs.n_params / 1e6)
    log("serve_h", **out)
    return out, rs.model


def phase_step(dtype: str, runs: int = 10, model=None, preset: str = "Ti",
               batches=(1, 8)) -> list[dict]:
    """Where one rollout step's time goes: one model application (Ti, or the
    given 2D model) at each batch size on the card. Wall time on the host
    clock (synchronised), device busy time and the fused kernel's part of
    it from torch.profiler; the device is idle for the rest of the wall
    time."""
    from dpot_tpu_torch.models import build_model

    if model is None:
        model = build_model(
            "DPOT", preset="Ti", img_size=128, patch_size=8, in_channels=4,
            in_timesteps=10, n_cls=1, dtype=getattr(torch, dtype), device="cuda", seed=0,
        )
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    n = model.img_size
    for B in batches:
        x = torch.randn((B, n, n, model.in_timesteps, model.in_channels), generator=gen,
                        device="cuda")
        with torch.inference_mode():
            def step():
                return model(x)

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(runs):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / runs * 1e3
            events = [e for e in profile_events(step, runs) if is_kernel(e)]
        row = dict(preset=preset, dtype=dtype, batch=B, wall_ms=wall)
        if events:
            times: dict[str, float] = {}
            for e in events:
                times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
            busy = union_us(events) / runs / 1e3
            fused = union_us([e for e in events if sub_kernel(e.name)]) / runs / 1e3
            fft = union_us([e for e in events if "fft" in e.name.lower()]) / runs / 1e3
            top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
            row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
                       fused_gn_afno_ms=fused, fft_ms=fft, fft_share=fft / busy,
                       top_kernels={k[:80]: v / runs / 1e3 for k, v in top})
        else:
            row.update(device_busy_ms="not measured")
        log("step", **row)
        rows.append(row)
    return rows


def read_metrics(log_dir: str) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    with open(Path(log_dir) / "metrics.jsonl") as f:
        for rec in map(json.loads, f):
            out.setdefault(rec["tag"], []).append(rec["value"])
    return out


EVAL_FN = "autograd::engine::evaluate_function: "


def weight_shapes(model) -> set[tuple[int, ...]]:
    """The shapes of the model's parameters and of the 2-D views in which
    the dense layers cast them ((out, rest) and (rest, last))."""
    shapes = set()
    for p in model.parameters():
        n = p.numel()
        shapes |= {tuple(p.shape), (p.shape[0], n // p.shape[0]), (n // p.shape[-1], p.shape[-1])}
    return shapes


# c10::ScalarType::BFloat16, as a profile that records shapes lists a dtype
# argument among an op's concrete inputs
BF16_SCALAR_TYPE = 15


def weight_copy_ms(events, shapes: set, runs: int) -> float | str:
    """Device time per step of the dense layers' casts of their weights to
    bf16: the aten::to calls to bf16 on a tensor of a parameter's shape (or
    its 2-D view), from a profile that recorded shapes (a call on a tensor
    that is bf16 already copies nothing and takes no device time)."""
    from torch.autograd import DeviceType

    casts = [e for e in events if e.device_type == DeviceType.CPU and e.name == "aten::to"
             and e.input_shapes and tuple(e.input_shapes[0]) in shapes]
    if casts and not any(getattr(e, "concrete_inputs", None) for e in casts):
        return "not measured"
    return sum(e.device_time_total for e in casts
               if list(e.concrete_inputs[1:2]) == [BF16_SCALAR_TYPE]) / runs / 1e3


def train_step_profile(state, batch, step_fn, runs: int = 10,
                       weight_copies: bool = False, extra=None) -> dict:
    """Where a train step's time goes, over `runs` steps after a warm-up:
    median wall time per step on the host clock (synchronised each step),
    then one profiled window of `runs` steps for the device busy time and
    the parts of it in the fused kernel with the bf16 weight copies that
    its Hopper path makes (a profiler range in the wrapper), in its VJP
    (the autograd node FusedGnAfnoBackward, which torch.profiler records)
    and in the optimizer update. The update is timed by CUDA events around
    it in the timed steps (from when the card reaches it to its end: its
    device time where the card runs behind the host, as at DPOT-H, plus the
    host's gaps where it does not, as at Ti) and by a profiler range around
    it in the profiled window, whose device time the profiler attributed
    wrongly at DPOT-H (more than the whole step). Peak memory is that of
    the timed steps, and of the first one's forward and backward alone
    (read as its update starts). With `weight_copies` the profile records
    shapes, and the dense layers' f32->bf16 weight copies are counted too.
    `extra(events, runs, busy)` adds the row's keys of a model's own parts."""
    from torch.autograd import DeviceType

    def step():
        return step_fn(state, batch)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    apply_gradients = state.apply_gradients
    updates = []
    before_update = []

    def timed_apply(*grads):
        before_update.append(torch.cuda.max_memory_allocated())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apply_gradients(*grads)
        end.record()
        updates.append((start, end))

    state.apply_gradients = timed_apply
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    opt = statistics.median(s.elapsed_time(e) for s, e in updates)
    row = dict(wall_ms=wall, wall_ms_each=walls,
               samples_per_s=batch["x"].shape[0] / wall * 1e3,
               peak_step_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_before_update_gb=before_update[0] / 1e9)

    def traced_apply(*grads):
        with torch.profiler.record_function("optimizer_update"):
            apply_gradients(*grads)

    state.apply_gradients = traced_apply
    events = profile_events(step, runs, record_shapes=weight_copies)
    del state.apply_gradients
    if not events:
        row.update(device_busy_ms="not measured")
        return row
    cuda_events = [e for e in events if is_kernel(e)]
    busy = union_us(cuda_events) / runs / 1e3
    fused = union_us([e for e in cuda_events if sub_kernel(e.name)]) / runs / 1e3

    def range_ms(prefix):
        return sum(e.device_time_total for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith(prefix)
                   ) / runs / 1e3

    vjp = range_ms(EVAL_FN + "FusedGnAfnoBackward")
    opt_profiled = range_ms("optimizer_update")
    # the Hopper path's bf16 weight copies, made once per step after the
    # optimizer changes the weights: part of the forward's cost
    casts = range_ms(afno_fused.BF16_BLOCKS_RANGE)
    # the dense layers (the pointwise MLP, which dominates, the embeddings
    # and heads): forward products under aten::linear, and the backward
    # nodes with the most device time (their products and the rest)
    linear = range_ms("aten::linear")
    nodes: dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(EVAL_FN):
            name = e.name[len(EVAL_FN):]
            nodes[name] = nodes.get(name, 0.0) + e.device_time_total / runs / 1e3
    top = dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:6])
    row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
               fused_gn_afno_ms=fused + casts, fused_gn_afno_share=(fused + casts) / busy,
               fused_gn_afno_kernels_ms=fused, weight_cast_ms=casts,
               vjp_ms=vjp, vjp_share=vjp / busy, optimizer_ms=opt,
               optimizer_share=opt / busy, optimizer_profiled_ms=opt_profiled,
               linear_forward_ms=linear,
               linear_forward_share=linear / busy, backward_nodes_ms=top)
    if weight_copies:
        row["dense_weight_copy_ms"] = weight_copy_ms(events, weight_shapes(state.model), runs)
    if extra is not None:
        row.update(extra(events, runs, busy))
    return row


def phase_train(dtype: str) -> dict:
    """Pretrain DPOT-Ti through the train CLI for a few epochs and check it."""
    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.train.checkpoint import restore_checkpoint
    from dpot_tpu_torch.train.loop import build_everything
    from dpot_tpu_torch.train.step import make_train_step
    from dpot_tpu_torch.utils.config import load_config

    make_synthetic_spec(**TRAIN_SPEC)
    argv = TRAIN_FLAGS + ["--dtype", dtype, "--log_path", str(RUN_DIR / f"train_{dtype}")]
    t0 = time.perf_counter()
    reset_launch_counts()
    out = train_main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    launches, bias_act_launches = fused_gn_afno.launches, bias_act.launches
    run_s = time.perf_counter() - t0

    # model applications: T_ar / T_bundle per train step; per epoch and
    # test batch, ceil(t_test / T_bundle) in the eval rollout
    B, epochs = TRAIN["batch"], TRAIN["epochs"]
    steps = epochs * math.ceil(TRAIN_SPEC["train_size"] / B)
    train_apps = steps * (TRAIN["t_ar"] // TRAIN["t_bundle"])
    eval_apps = (epochs * math.ceil(TRAIN_SPEC["test_size"] / B)
                 * math.ceil(TRAIN_SPEC["t_test"] / TRAIN["t_bundle"]))
    want_launches = TI["depth"] * (train_apps + eval_apps)
    if out["state"].step != steps:
        raise AssertionError(f"train took {out['state'].step} steps, expected {steps}")
    if launches != want_launches:
        raise AssertionError(
            f"fused_gn_afno launched {launches} times in training, expected depth x "
            f"(train + eval applications) = {want_launches}")
    by_path = check_paths(dtype, launches)
    metrics = read_metrics(out["log_dir"])
    losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
    losses += [out["train_l2_step"], out["train_l2_full"], *out["test_l2_steps"],
               *out["test_l2_fulls"]]
    if len(metrics.get("train_loss_step", [])) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"train losses missing or not finite: {metrics}")

    # resume from the last checkpoint, twice, and take two steps each time
    cfg = load_config(argv)
    _, state, _, train_dl, _, train_ds = build_everything(cfg, "cuda")
    x, y, _, cls = next(iter(train_dl))
    wire = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    batch = {"x": torch.from_numpy(x).to("cuda", wire), "y": torch.from_numpy(y).cuda(),
             "cls": torch.from_numpy(cls).cuda()}
    if not train_ds.train_masks_are_ones:
        raise AssertionError("the synthetic train masks are expected to be all ones")
    step_fn = make_train_step(noise_scale=cfg.noise_scale, ones_mask=True,
                              time_major=bool(train_ds.time_major_batches))
    resumed = []
    for _ in range(2):
        restore_checkpoint(str(Path(out["log_dir"]) / "model"), state)
        if state.step != steps:
            raise AssertionError(f"checkpoint holds step {state.step}, expected {steps}")
        resumed.append([step_fn(state, batch)[1]["loss_step"].item() for _ in range(2)])
    diff = max(abs(a - b) / abs(b) for a, b in zip(*resumed))
    if not diff <= RESUME_TOL:
        raise AssertionError(f"two resumes from one checkpoint give losses {resumed}")

    prof = train_step_profile(state, batch, step_fn)
    row = dict(dtype=dtype, batch=B, steps=steps, train_applications=train_apps,
               eval_applications=eval_apps, launches=launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, run_s=run_s,
               loop_step_s=out["step_seconds"], train_l2_step=out["train_l2_step"],
               test_l2_steps=out["test_l2_steps"], resumed_losses=resumed,
               resume_rel_diff=diff, **prof)
    log("train", **row)
    return row


def phase_train_h(model) -> dict:
    """A few bf16 train steps of DPOT-H at full width and depth on the card
    (the served model, its weights as drawn), through make_train_step on a
    synthetic batch: adam, noise 5e-4. Every loss finite and every
    fused_gn_afno launch on the kernel for AFNO blocks of 256 channels,
    depth x steps of them; then where a step's time goes, as for Ti. No
    checkpoint: the Ti train phase checks the CLI's, and a full DPOT-H state
    is 16.5 GB."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    B = H_TRAIN["batch"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"x": torch.randn((B, 128, 128, 10, 4), generator=gen, device="cuda")
             .to(torch.bfloat16),
             "y": torch.randn((B, 128, 128, 1, 4), generator=gen, device="cuda"),
             "cls": torch.zeros(B, dtype=torch.int32, device="cuda")}
    model.train()
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), H_TRAIN["lr"]),
                              seed=0)
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [step_fn(state, batch)[1]["loss_step"].item() for _ in range(H_TRAIN["steps"])]
    torch.cuda.synchronize()
    launches, bias_act_launches = fused_gn_afno.launches, bias_act.launches
    if launches != DPOT_H["depth"] * H_TRAIN["steps"]:
        raise AssertionError(f"DPOT-H train: fused_gn_afno launched {launches} times, expected "
                             f"depth x steps = {DPOT_H['depth'] * H_TRAIN['steps']}")
    by_path = check_paths("bfloat16", launches, "hopper_wide")
    if not np.isfinite(losses).all():
        raise AssertionError(f"DPOT-H train losses not finite: {losses}")
    row = dict(dtype="bfloat16", batch=B, steps=H_TRAIN["steps"], losses=losses,
               launches=launches, launches_by_path=by_path, bias_act_launches=bias_act_launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               **train_step_profile(state, batch, step_fn, runs=5))
    log("train_h", **row)
    return row


def phase_train_card_vs_cpu(B: int = 4) -> dict:
    """One f32 Ti train step on the card (kernel + VJP) and on the CPU (plain
    version + VJP), on the same weights, batch and noise draws."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    model = build_model(
        "DPOT", preset="Ti", img_size=128, patch_size=8, in_channels=4,
        in_timesteps=10, n_cls=1, dtype=torch.float32, device="cuda", seed=5,
    )
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(22)
    msk = np.ones((B, 128, 128, 1, 4), np.float32)
    msk[0, ::2] = 0.0
    batch = dict(
        x=rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32),
        y=rng.standard_normal((B, 128, 128, 1, 4)).astype(np.float32),
        msk=msk, cls=np.zeros(B, np.int32),
        noise=rng.standard_normal((1, B, 128, 128, 10, 4)).astype(np.float32),
    )
    step_fn = make_train_step(noise_scale=5e-4)
    aux = {}
    for name, m, dev in (("card", model, "cuda"), ("cpu", cpu_model, "cpu")):
        state = TrainState.create(m, build_optimizer("adam", m.parameters(), 0.0), seed=0)
        _, aux[name] = step_fn(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    loss_rel = abs(aux["card"]["loss_step"].item() - aux["cpu"]["loss_step"].item()) \
        / abs(aux["cpu"]["loss_step"].item())
    grads = {}
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"{name}: a gradient on one device only")
        if p.grad is not None:
            grads[name] = rel_l2(p.grad.cpu(), q.grad)
    worst = max(grads, key=grads.get)
    if not (loss_rel <= TRAIN_CPU_TOL["loss"] and grads[worst] <= TRAIN_CPU_TOL["grad"]):
        raise AssertionError(
            f"train step card vs CPU: loss rel {loss_rel} (limit {TRAIN_CPU_TOL['loss']}), "
            f"{worst} gradient rel_l2 {grads[worst]} (limit {TRAIN_CPU_TOL['grad']})")
    row = dict(batch=B, loss_rel=loss_rel, worst_grad=worst, worst_grad_rel_l2=grads[worst],
               n_grads=len(grads), limits=TRAIN_CPU_TOL)
    log("train_card_vs_cpu", **row)
    return row


def preset_model(preset: str, dtype: str, seed: int, device: str = "cuda"):
    """A seeded DPOT of a registry preset on the 128^2 grid (patch 8, T_in
    10, 4 channels, one dataset class)."""
    from dpot_tpu_torch.models import build_model

    return build_model("DPOT", preset=preset, img_size=128, patch_size=8, in_channels=4,
                       in_timesteps=10, n_cls=1, dtype=getattr(torch, dtype),
                       device=device, seed=seed)


def save_reference_pth(model, path: Path) -> str:
    """The model's weights as a reference-layout .pth ({'model': state dict})."""
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               path)
    return str(path)


def eval_applications(spec: dict, batch: int = EVAL_BATCH) -> int:
    """Model applications of one evaluation: t_test per batch (T_bundle 1)."""
    return math.ceil(spec["test_size"] / batch) * spec["t_test"]


def finite(values) -> bool:
    return bool(np.isfinite(np.asarray(list(values), np.float64)).all())


def check_no_launch(before: int, what: str) -> None:
    """The plain-mixer run that a result is compared with launched no kernel."""
    if fused_gn_afno.launches != before:
        raise AssertionError(f"{what} launched fused_gn_afno "
                             f"{fused_gn_afno.launches - before} times")


def phase_eval_l(dtype: str) -> tuple[dict, torch.nn.Module]:
    """DPOT-L through the evaluate CLI with --metrics: all launches on the
    kernel for 96-channel blocks of the compute type, finite numbers, one
    application's time, and peak memory. The smoke's own copy of the model
    (the same seed) writes the .pth and runs the profile; then, its AFNO
    weights redrawn so that the mixer matters, the evaluation's rollout of
    the first test batch against the plain mixer's on the card."""
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.train.step import make_eval_rollout

    name = EVAL_L_SPEC["name"]
    make_synthetic_spec(**EVAL_L_SPEC)
    t0 = time.perf_counter()
    model = preset_model("L", dtype, seed=0)
    pth = RUN_DIR / "L.pth"
    if not pth.exists():
        save_reference_pth(model, pth)
    build_s = time.perf_counter() - t0
    argv = L_ARCH + ["--dtype", dtype, "--resume_path", str(pth), "--test_paths", name,
                     "--batch_size", str(EVAL_BATCH), "--num_workers", "4", "--metrics",
                     "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(argv)
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    bias_act_launches = bias_act.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    apps = eval_applications(EVAL_L_SPEC)
    if launches != DPOT_L["depth"] * apps:
        raise AssertionError(f"DPOT-L eval: fused_gn_afno launched {launches} times, "
                             f"expected depth x applications = {DPOT_L['depth'] * apps}")
    by_path = check_paths(dtype, launches, L_PATH[dtype])
    vals = got[name]
    if not finite([*vals.values(), got["avg_step_time"]]) or not got["avg_step_time"] > 0:
        raise AssertionError(f"DPOT-L eval {dtype}: {got}")
    steps = phase_step(dtype, model=model, preset="L")
    ds = MixedTemporalDataset([name], res=128, t_in=10, t_ar=-1, n_channels=4, train=False)
    x, y, msk, _ = next(iter(DataLoader(ds, EVAL_BATCH, shuffle=False, num_workers=0)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in (("x", x), ("y", y), ("msk", msk))}
    draw_mixer_weights(model, seed=5)

    def graphed_preds() -> torch.Tensor:
        # a fresh rollout each time: its first call runs eagerly and then
        # captures the graph under the mixer in force; the second replays
        # that graph, which must follow the mixer it was captured with
        roll = make_eval_rollout()
        roll(model, batch)
        return roll(model, batch)["pred"]

    rels = mixer_readings(graphed_preds, "L", dtype, f"DPOT-L eval {dtype}")
    row = dict(dtype=dtype, applications=apps, launches=launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, results=vals,
               avg_step_time_s=got["avg_step_time"], plain_mixer_rel_l2=rels,
               plain_mixer_limit=MIXER_TOL[f"L/{dtype}"], run_s=run_s,
               build_and_write_s=build_s, peak_memory_gb=peak,
               params_m=sum(q.numel() for q in model.parameters()) / 1e6,
               step_b8=steps[-1])
    log("eval_l", **row)
    return row, model


def phase_finetune_s() -> dict:
    """DPOT-S fine-tuned through the finetune CLI from a seeded 4-channel
    .pth onto a 3-channel set, with the optimization of
    configs/dpot_finetune.yaml (only the data and the epochs cut), then its
    checkpoint evaluated through the evaluate CLI with --config_from_ckpt."""
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.cli.finetune import main as finetune_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec

    name = FT_SPEC["name"]
    make_synthetic_spec(**FT_SPEC)
    src = save_reference_pth(preset_model("S", "float32", seed=1, device="cpu"),
                             RUN_DIR / "S.pth")
    argv = ["--config_file", str(Path(__file__).resolve().parent / "configs" /
                                 "dpot_finetune.yaml"),
            "--resume_path", src, "--train_paths", name, "--test_paths", name,
            "--epochs", "2", "--warmup_epochs", "40", "--batch_size", "8",
            "--noise_scale", "0", "--T_in", "10", "--dtype", "bfloat16", "--seed", "0",
            "--num_workers", "4", "--log_path", str(RUN_DIR / "finetune"),
            "--device", "cuda"]
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = finetune_main(argv)
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    bias_act_launches = bias_act.launches
    train_apps = 2 * math.ceil(FT_SPEC["train_size"] / 8)
    eval_apps = 2 * eval_applications(FT_SPEC)
    if launches != DPOT_S["depth"] * (train_apps + eval_apps):
        raise AssertionError(f"finetune: fused_gn_afno launched {launches} times, expected "
                             f"depth x applications = {DPOT_S['depth'] * (train_apps + eval_apps)}")
    by_path = check_paths("bfloat16", launches, "hopper")
    if sorted(out["copied"]) != FT_COPIED:
        raise AssertionError(f"finetune copied {sorted(out['copied'])}, expected {FT_COPIED}")
    metrics = read_metrics(out["log_dir"])
    losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
    if not losses or not finite(losses + out["test_l2_fulls"] + [out["train_l2_step"]]):
        raise AssertionError(f"finetune losses missing or not finite: {metrics}")

    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path",
                             str(Path(out["log_dir"]) / "model"), "--test_paths", name,
                             "--batch_size", "8", "--dtype", "bfloat16", "--num_workers", "4",
                             "--device", "cuda"])
    torch.cuda.synchronize()
    eval_launches = fused_gn_afno.launches
    bias_act_launches += bias_act.launches
    if eval_launches != DPOT_S["depth"] * eval_applications(FT_SPEC):
        raise AssertionError(f"finetune eval: {eval_launches} launches")
    eval_by_path = check_paths("bfloat16", eval_launches, "hopper")
    rel = abs(got[name]["loss_full"] - out["test_l2_fulls"][-1]) / out["test_l2_fulls"][-1]
    if not rel <= FT_EVAL_TOL:
        raise AssertionError(f"evaluate's loss_full {got[name]['loss_full']} against the loop's "
                             f"{out['test_l2_fulls'][-1]}: rel {rel} (limit {FT_EVAL_TOL})")
    row = dict(dtype="bfloat16", copied=sorted(out["copied"]), steps=out["state"].step,
               launches=launches, train_launches_by_path=by_path, eval_launches=eval_launches,
               eval_launches_by_path=eval_by_path, bias_act_launches=bias_act_launches,
               launches_by_path={k: v + eval_by_path[k] for k, v in by_path.items()},
               run_s=run_s, train_l2_step=out["train_l2_step"],
               test_l2_fulls=out["test_l2_fulls"], evaluate_loss_full=got[name]["loss_full"],
               evaluate_rel=rel, evaluate_limit=FT_EVAL_TOL)
    log("finetune_s", **row)
    return row


def phase_varyres_ti() -> dict:
    """The resolution sweep at DPOT-Ti in bf16 through the evaluate CLI;
    then, the smoke's copy's AFNO weights redrawn so that the mixer
    matters, the sweep's rollout of one batch at two resolutions against
    the plain mixer's on the card."""
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.ops.spectral import resize_temporal
    from dpot_tpu_torch.train.evaluator import VARYRES_LIST, make_varyres_rollout

    name = VARYRES_SPEC["name"]
    make_synthetic_spec(**VARYRES_SPEC)
    model = preset_model("Ti", "bfloat16", seed=2)
    pth = save_reference_pth(model, RUN_DIR / "Ti.pth")
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(TI_ARCH + ["--varyres", "--resume_path", pth, "--dtype",
                                       "bfloat16", "--test_paths", name, "--batch_size",
                                       str(EVAL_BATCH), "--num_workers", "4",
                                       "--device", "cuda"])
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    apps = len(VARYRES_LIST) * eval_applications(VARYRES_SPEC)
    if launches != TI["depth"] * apps:
        raise AssertionError(f"varyres: {launches} launches, expected depth x applications "
                             f"= {TI['depth'] * apps}")
    by_path = check_paths("bfloat16", launches, "hopper")
    if list(got) != list(VARYRES_LIST) or not finite(
            v for r in got.values() for v in r[name].values()):
        raise AssertionError(f"varyres results: {got}")
    step = make_varyres_rollout(128)
    x0 = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (EVAL_BATCH, 128, 128, 10, 4)).astype(np.float32)).to("cuda")

    def sweep_preds(res: int) -> torch.Tensor:
        x, preds = resize_temporal(x0, (res, res)), []
        for _ in range(VARYRES_SPEC["t_test"]):
            preds.append(step(model, x, res))
            x = torch.cat([x[..., 1:, :], preds[-1].to(x.dtype)], dim=-2)
        return torch.cat(preds, dim=-2)

    draw_mixer_weights(model, seed=6)
    rels = {res: mixer_readings(lambda: sweep_preds(res), "Ti", "bfloat16",
                                f"varyres at {res}")
            for res in VARYRES_CHECKED}
    row = dict(dtype="bfloat16", resolutions=list(got), applications=apps,
               launches=launches, launches_by_path=by_path, run_s=run_s,
               loss_full={res: got[res][name]["loss_full"] for res in got},
               plain_mixer_rel_l2=rels, plain_mixer_limit=MIXER_TOL["Ti/bfloat16"])
    log("varyres_ti", **row)
    return row


def phase_convert_resume_serve() -> dict:
    """The S .pth through cli.convert; cli.train --resume_path on the
    directory for one epoch from step 0 (on the 4-channel Ti training set);
    cli.serve --resume_path on it, one answer against a direct loop."""
    from dpot_tpu_torch.cli.convert import main as convert_main
    from dpot_tpu_torch.cli.serve import main as serve_main
    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.train.checkpoint import restore_params

    ckpt = str(RUN_DIR / "S_converted")
    src = str(RUN_DIR / "S.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_main(S_ARCH + ["--n_channels", "4", "--resume_path", src, "--out_path", ckpt,
                               "--device", "cuda"])
    make_synthetic_spec(**TRAIN_SPEC)
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_main(S_ARCH + ["--train_paths", TRAIN_SPEC["name"], "--resume_path",
                                   ckpt, "--epochs", "1", "--batch_size", "20",
                                   "--dtype", "bfloat16", "--num_workers", "4",
                                   "--use_writer", "true", "--log_path",
                                   str(RUN_DIR / "resume"), "--device", "cuda"])
    torch.cuda.synchronize()
    train_launches = fused_gn_afno.launches
    steps = math.ceil(TRAIN_SPEC["train_size"] / 20)
    apps = steps + math.ceil(TRAIN_SPEC["test_size"] / 20) * TRAIN_SPEC["t_test"]
    if out["state"].step != steps or train_launches != DPOT_S["depth"] * apps:
        raise AssertionError(f"resume from the converted directory: step {out['state'].step}"
                             f" (expected {steps}), {train_launches} launches "
                             f"(expected {DPOT_S['depth'] * apps})")
    train_by_path = check_paths("bfloat16", train_launches, "hopper")
    logs = (Path(out["log_dir"]) / "logs.txt").read_text()
    if "step 0, continuing at epoch 0" not in logs or not finite(
            [out["train_l2_step"], *out["test_l2_fulls"]]):
        raise AssertionError(f"resume did not start at step 0 with finite losses: {logs}")

    reset_launch_counts()
    httpd, rs = serve_main(S_ARCH + ["--n_channels", "4", "--resume_path", ckpt, "--dtype",
                                     "bfloat16", "--host", "127.0.0.1", "--port", "0",
                                     "--device", "cuda"], wait=False)
    try:
        x = np.random.default_rng(13).standard_normal((2, 128, 128, 10, 4)).astype(np.float32)
        pred, ms = post_rollout(httpd.server_address[1], npy(x), 3)
        torch.cuda.synchronize()
        serve_launches = fused_gn_afno.launches
        applications = warmup_applications(rs) + 3
        wire = torch.bfloat16 if rs.wire_dtype == "bfloat16" else torch.float32
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()
    if serve_launches != DPOT_S["depth"] * applications:
        raise AssertionError(f"serve: {serve_launches} launches, expected "
                             f"{DPOT_S['depth'] * applications}")
    serve_by_path = check_paths("bfloat16", serve_launches, "hopper")
    want_sd = restore_params(src)
    if not all(torch.equal(v.cpu(), want_sd[k]) for k, v in rs.model.state_dict().items()):
        raise AssertionError("the served weights are not the converted .pth's")
    rel = rel_l2(torch.from_numpy(pred), direct_rollout(rs.model, x, 3, wire).cpu())
    if not (pred.shape == (2, 128, 128, 3, 4) and rel <= 1e-5):
        raise AssertionError(f"served answer {pred.shape} differs from a direct loop: {rel}")
    row = dict(dtype="bfloat16", train_steps=out["state"].step, train_launches=train_launches,
               train_launches_by_path=train_by_path, train_l2_step=out["train_l2_step"],
               serve_applications=applications, serve_launches=serve_launches,
               serve_launches_by_path=serve_by_path, client_ms=ms, direct_loop_rel_l2=rel,
               launches_by_path={k: v + serve_by_path[k] for k, v in train_by_path.items()})
    log("convert_resume_serve", **row)
    return row


def sweep_file(config: Path, tag: str, cut: dict, run_dir: Path) -> tuple[Path, list]:
    """Write the copy of the sweep file `config` with only its data cut
    (`cut`: ntrain and ntest trajectories of each corpus, epochs) into
    run_dir, its corpora the synthetic sets synthetic_{tag}_{corpus} of
    their namesakes' grids, channels and lengths, its logs under
    run_dir/train_{tag}; returns its path and the sets' specs, in the
    file's order of corpora."""
    import yaml

    from dpot_tpu_torch.data.registry import get_spec, make_synthetic_spec

    doc = yaml.safe_load(config.read_text())
    specs = []
    for name in doc["train_paths"]:
        real = get_spec(name)
        specs.append(make_synthetic_spec(
            f"synthetic_{tag}_{name}", train_size=cut["ntrain"], test_size=cut["ntest"],
            t_total=real.t_total, t_test=real.t_test, in_size=real.in_size,
            n_channels=real.n_channels))
    names = [spec.name for spec in specs]
    doc.update(train_paths=names, test_paths=names, ntrain_list=[cut["ntrain"]] * len(names),
               log_path=str(run_dir / f"train_{tag.lower()}"))
    doc["tasks"]["epochs"] = [cut["epochs"]]
    path = run_dir / f"{config.stem}_data_cut.yaml"
    path.write_text(yaml.safe_dump(doc, sort_keys=False))
    return path, specs


def sweep_applications(specs, weights, batch: int, epochs: int,
                       t_in: int = 10) -> tuple[int, int]:
    """The train steps and eval model applications of a cut sweep run: each
    corpus gives ntrain x its weight train samples (one window each, T_ar
    1, so one application a step), and per epoch ceil(ntest / batch) eval
    batches of as many applications as its test rollout has frames
    (t_test, or the frames after the first t_in where fewer)."""
    samples = sum(s.train_size * w for s, w in zip(specs, weights))
    steps = epochs * math.ceil(samples / batch)
    evals = epochs * sum(math.ceil(s.test_size / batch) * min(s.t_test, s.t_total - t_in)
                         for s in specs)
    return steps, evals


def phase_train_l() -> tuple[dict, torch.nn.Module]:
    """Pretrain DPOT-L through the sweep CLI (`python -m
    dpot_tpu_torch.cli.sweep --config_file <copy>`, in-process) from
    configs/pretrain_large.yaml with only its data cut: bf16, lamb, batch
    16, remat. The steps and the kernel's launches exact (remat runs each
    block's forward again in the backward: depth x (2 x train + eval
    applications), all on afno_hopper_l.cu), every loss finite, the
    checkpoint the run wrote restoring through restore_params to the
    state's weights; then where a step's time goes, as for Ti, with the
    dense layers' weight copies. Returns the row and the trained model."""
    import yaml

    from dpot_tpu_torch.cli.sweep import main as sweep_main
    from dpot_tpu_torch.train.checkpoint import restore_params
    from dpot_tpu_torch.train.step import make_train_step

    cfg_path, specs = sweep_file(L_CONFIG, "L", TRAIN_L, RUN_DIR)
    doc = yaml.safe_load(cfg_path.read_text())
    batch = doc["tasks"]["batch_size"][0]
    if (batch, doc["opt"], doc["dtype"], doc["remat"]) != (L_BATCH, "lamb", "bfloat16", True):
        raise AssertionError(f"{L_CONFIG.name} no longer pretrains L as this phase expects")
    steps, eval_apps = sweep_applications(specs, doc["data_weights"], batch,
                                          TRAIN_L["epochs"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        (out,) = sweep_main(["--config_file", str(cfg_path), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    bias_act_launches = bias_act.launches
    run_peak = torch.cuda.max_memory_allocated() / 1e9
    state, model = out["state"], out["model"]
    if not model.remat or state.step != steps:
        raise AssertionError(f"train_l: remat {model.remat}, {state.step} steps, expected "
                             f"remat and {steps}")
    want = DPOT_L["depth"] * (2 * steps + eval_apps)
    if launches != want:
        raise AssertionError(f"train_l: fused_gn_afno launched {launches} times, expected "
                             f"depth x (2 x train + eval applications) = {want}")
    by_path = check_paths("bfloat16", launches, "hopper_l")
    metrics = read_metrics(out["log_dir"])
    losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
    losses += [out["train_l2_step"], out["train_l2_full"], *out["test_l2_steps"],
               *out["test_l2_fulls"]]
    if len(metrics.get("train_loss_step", [])) != steps or not finite(losses):
        raise AssertionError(f"train_l losses missing or not finite: {metrics}")
    saved = restore_params(str(Path(out["log_dir"]) / "model"))
    mine = state.params_state_dict()
    if saved.keys() != mine.keys() or not all(torch.equal(saved[k], mine[k].cpu())
                                               for k in saved):
        raise AssertionError("train_l: the checkpoint does not restore to the state's weights")
    del saved, mine

    (b,) = l_corpus_batches(1, seed=1)
    del b["noise"]  # the step draws its noise from the state's generator, as in the run
    step_fn = make_train_step(noise_scale=doc["tasks"]["noise_scale"][0], ones_mask=True)
    prof = train_step_profile(state, b, step_fn, weight_copies=True)
    row = dict(dtype="bfloat16", batch=batch, steps=steps, train_applications=steps,
               eval_applications=eval_apps, launches=launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, run_s=run_s, run_peak_memory_gb=run_peak,
               loop_step_s=out["step_seconds"], train_l2_step=out["train_l2_step"],
               test_l2_steps=out["test_l2_steps"],
               params_m=sum(p.numel() for p in model.parameters()) / 1e6,
               corpora={s.name: dict(channels=s.n_channels, in_size=s.in_size,
                                     t_total=s.t_total, t_test=s.t_test) for s in specs},
               **prof)
    log("train_l", **row)
    del out, state
    return row, model


def corpus_batches(config: Path, tag: str, cut: dict, batch: int, x_dtype: torch.dtype,
                   n: int, seed: int) -> list[dict]:
    """n train batches of the cut corpora that sweep_file registered for
    `config`, as the loop ships them to the card (x in x_dtype, one target
    frame, no mask), each with the noise draws of its step."""
    import yaml

    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset

    doc = yaml.safe_load(config.read_text())
    names = [f"synthetic_{tag}_{name}" for name in doc["train_paths"]]
    ds = MixedTemporalDataset(names, [cut["ntrain"]] * len(names),
                              res=doc["tasks"]["res"][0], t_in=10, t_ar=1, train=True,
                              data_weights=doc["data_weights"])
    loader = iter(DataLoader(ds, batch, shuffle=True, num_workers=8, seed=seed,
                             drop_last=True))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(n):
        x, y, _, cls = next(loader)
        batches.append({"x": torch.from_numpy(x).to("cuda", x_dtype),
                        "y": torch.from_numpy(y).cuda(), "cls": torch.from_numpy(cls).cuda(),
                        "noise": torch.randn((1, *x.shape), generator=gen, device="cuda")})
    return batches


def l_corpus_batches(n: int, seed: int) -> list[dict]:
    """n train batches of batch 16 of the cut L corpora that train_L
    registered, x in bf16."""
    return corpus_batches(L_CONFIG, "L", TRAIN_L, L_BATCH, torch.bfloat16, n, seed)


def phase_remat_l(model) -> dict:
    """One bf16 step of the trained DPOT-L at batch 16 with remat and
    without, from the same weights (lr 0 keeps them), batch (of the cut
    corpora) and noise: the losses within REMAT_TOL["loss"] and every
    gradient within REMAT_TOL["grad"] relative L2 (expected identical);
    where each way's step time goes, as for Ti, with its peak memory, and
    its launches: depth x (2 or 1) a step. The gradients are compared on
    the host, so that no copy of them weighs on the card's peak."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    (batch,) = l_corpus_batches(1, seed=31)
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    runs, row = {}, {}
    for remat in (False, True):
        model.remat = remat
        state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 0.0), 0)
        reset_launch_counts()
        loss = step_fn(state, batch)[1]["loss_step"].item()
        per_step = DPOT_L["depth"] * (2 if remat else 1)
        check_paths("bfloat16", per_step, "hopper_l")
        grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        prof = train_step_profile(state, batch, step_fn)
        launches = fused_gn_afno.launches
        if launches != per_step * 24:  # the step, then 3 + 10 + 10 in the profile
            raise AssertionError(f"remat_l {remat}: {launches} launches, expected {per_step * 24}")
        runs[remat] = (loss, grads)
        row[f"remat_{str(remat).lower()}"] = dict(
            loss=loss, launches=launches, launches_by_path=dict(fused_gn_afno.launches_by_path),
            **prof)
        del state, grads
    (l0, g0), (l1, g1) = runs[False], runs[True]
    loss_rel = abs(l1 - l0) / abs(l0)
    rels = {n: rel_l2(g1[n], g0[n]) for n in g0}
    worst = max(rels, key=rels.get)
    identical = [n for n in g0 if torch.equal(g1[n], g0[n])]
    if g0.keys() != g1.keys() or not (loss_rel <= REMAT_TOL["loss"]
                                      and rels[worst] <= REMAT_TOL["grad"]):
        raise AssertionError(f"remat_l: loss rel {loss_rel}, {worst} gradient rel_l2 "
                             f"{rels[worst]} (limits {REMAT_TOL})")
    row.update(batch=L_BATCH, loss_rel=loss_rel, worst_grad=worst,
               worst_grad_rel_l2=rels[worst], grads=len(rels),
               grads_bitwise_equal=len(identical), limits=REMAT_TOL,
               launches_by_path={p: sum(row[k]["launches_by_path"][p]
                                        for k in ("remat_false", "remat_true"))
                                 for p in afno_fused.PATHS})
    log("remat_l", **row)
    model.remat = True
    return row


def phase_params_lp_l(model) -> dict:
    """Five bf16 lamb steps of DPOT-L at batch 16 (remat on, as the file
    says) from the same weights, batches (of the cut corpora) and noise
    with the bf16 working copy of the parameters and without: each loss
    within PARAMS_LP's 5 %, after every step the copy exactly the master
    cast to bf16, every launch on afno_hopper_l.cu; then where a step's
    time goes each way, with the dense layers' f32->bf16 weight copies.
    The model's weights are left as the working copy's bf16."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batches = l_corpus_batches(PARAMS_LP["steps"], seed=40)
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    row: dict = dict(batch=L_BATCH, steps=PARAMS_LP["steps"], limit=PARAMS_LP["loss_rel"])
    losses = {}
    for lp in (False, True):
        model.load_state_dict(start, strict=True)
        opt = build_optimizer("lamb", model.parameters(), PARAMS_LP["lr"])
        state = TrainState.create(model, opt, 0,
                                  param_working_dtype=torch.bfloat16 if lp else None)
        reset_launch_counts()
        losses[lp] = []
        for b in batches:
            losses[lp].append(step_fn(state, b)[1]["loss_step"].item())
            if lp and not all(torch.equal(p, m.to(torch.bfloat16))
                              for p, m in zip(state.params_lp, state.optimizer.params)):
                raise AssertionError("params_lp_l: the working copy is not the master's cast")
        launches = fused_gn_afno.launches
        by_path = check_paths("bfloat16", launches, "hopper_l")
        if launches != 2 * DPOT_L["depth"] * PARAMS_LP["steps"]:
            raise AssertionError(f"params_lp_l {lp}: {launches} launches")
        prof = train_step_profile(state, batches[0], step_fn, weight_copies=True)
        row["working_copy" if lp else "f32_master"] = dict(
            losses=losses[lp], launches=launches, launches_by_path=by_path, **prof)
        del state, opt
    rels = [abs(b - a) / abs(a) for a, b in zip(losses[False], losses[True])]
    if not finite(losses[False] + losses[True]) or not max(rels) <= PARAMS_LP["loss_rel"]:
        raise AssertionError(f"params_lp_l losses {losses} differ by {rels}")
    row.update(loss_rel=rels, launches_by_path={
        p: row["f32_master"]["launches_by_path"][p] + row["working_copy"]["launches_by_path"][p]
        for p in afno_fused.PATHS})
    log("params_lp_l", **row)
    return row


def max_rel(a, b) -> float:
    """The largest relative difference of two equal-length number lists."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))


def state_tensors(state) -> list[torch.Tensor]:
    """The tensors an optimizer step writes: weights (the f32 master where
    there is a working copy) and both moments."""
    opt = state.optimizer
    return [*opt.params, *opt.mu, *opt.nu]


def worst_rel_l2(xs, ys) -> float:
    """The largest relative L2 distance over pairs of tensors (0 where a
    pair is equal, so that all-zero moments count)."""
    worst = 0.0
    for x, y in zip(xs, ys, strict=True):
        d = (x.float() - y.float()).norm().item()
        if d:
            worst = max(worst, d / y.float().norm().item())
    return worst


@contextlib.contextmanager
def eager_eval():
    """Every eval rollout runs eagerly, as without graphs: the comparison
    of the rollouts phase."""
    from dpot_tpu_torch.train.step import EvalRollout

    real = EvalRollout.__call__
    EvalRollout.__call__ = lambda self, model, batch: self.run(model, batch)
    try:
        yield
    finally:
        EvalRollout.__call__ = real


def dispatch_profile(state, batches, fn, runs: int = 10) -> dict:
    """Where a K-step dispatch's time goes, per optimizer step: the first
    call runs the K steps eagerly and captures the graph; then the median
    wall of `runs` replays (synchronised each) and one profiled window of
    `runs` replays for the device busy time and the fused kernel's part."""
    K, B = batches["x"].shape[:2]
    t0 = time.perf_counter()
    fn(state, batches)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    fn(state, batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / K)
    wall = statistics.median(walls)
    row = dict(steps_per_dispatch=K, first_call_ms=first, wall_ms=wall, wall_ms_each=walls,
               samples_per_s=B / wall * 1e3,
               peak_step_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    events = [e for e in profile_events(lambda: fn(state, batches), runs) if is_kernel(e)]
    if not events:
        row.update(device_busy_ms="not measured")
        return row
    busy = union_us(events) / runs / 1e3 / K
    fused = union_us([e for e in events if sub_kernel(e.name)]) / runs / 1e3 / K
    row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
               fused_gn_afno_kernels_ms=fused, fused_gn_afno_share=fused / busy)
    return row


def phase_dispatch_ti() -> dict:
    """DPOT-Ti pretrained through the train CLI at 4 steps a dispatch (one
    CUDA graph of 4 steps, tails as single eager steps) against the same
    run at 1 step a dispatch, twice (the eager path's own spread), from the
    same seed: every per-step loss, the optimizer steps and dispatch units
    and the launches exact; then where a step's time goes at K = 1 and at
    K = 4 on the run's state and one loader batch of 4 x 20 samples."""
    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.train.step import make_train_step

    name, K, B, epochs = DISPATCH_SPEC["name"], DISPATCH_K, TRAIN["batch"], DISPATCH_EPOCHS
    make_synthetic_spec(**DISPATCH_SPEC)
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--train_paths") + 1] = name
    flags[flags.index("--epochs") + 1] = str(epochs)
    noise = float(flags[flags.index("--noise_scale") + 1])
    n = DISPATCH_SPEC["train_size"]
    steps = epochs * math.ceil(n / B)
    full, rest = divmod(n, K * B)
    units = ([K] * full + [1] * math.ceil(rest / B)) * epochs
    eval_apps = epochs * math.ceil(DISPATCH_SPEC["test_size"] / B) * DISPATCH_SPEC["t_test"]
    want = TI["depth"] * (steps + eval_apps)
    runs, outs = {}, {}
    for run, k in (("k4", K), ("k1", 1), ("k1_again", 1)):
        argv = flags + ["--dtype", "bfloat16", "--steps_per_dispatch", str(k), "--log_path",
                        str(RUN_DIR / f"dispatch_{run}"), "--device", "cuda"]
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = fused_gn_afno.launches
        if out["state"].step != steps or out["dispatch_steps"] != (units if k > 1
                                                                   else [1] * steps):
            raise AssertionError(f"dispatch_ti {run}: step {out['state'].step}, dispatch "
                                 f"units {out['dispatch_steps']} (expected {steps}, {units})")
        if launches != want:
            raise AssertionError(f"dispatch_ti {run}: {launches} launches, expected depth x "
                                 f"(train + eval applications) = {want}")
        by_path = check_paths("bfloat16", launches)
        losses = read_metrics(out["log_dir"])["train_loss_step"]
        if len(losses) != steps or not finite(losses + out["test_l2_fulls"]):
            raise AssertionError(f"dispatch_ti {run}: losses {losses}")
        logs = (Path(out["log_dir"]) / "logs.txt").read_text()
        # the loop's host time per optimizer step over its full dispatches
        # (K = 4: after the first, which runs eagerly and captures)
        per_step = [t / u for t, u in zip(out["step_seconds"], out["dispatch_steps"])
                    if u == k][1:]
        runs[run] = dict(
            steps_per_dispatch=k, run_s=run_s, launches=launches, launches_by_path=by_path,
            bias_act_launches=bias_act.launches, losses=losses,
            test_l2_fulls=out["test_l2_fulls"],
            loop_ms_per_step=statistics.median(per_step) * 1e3,
            load_avg_s=[float(v) for v in re.findall(r"load avg ([-0-9.e]+)", logs)],
            train_avg_s=[float(v) for v in re.findall(r"time train avg ([-0-9.e]+)", logs)])
        outs[run] = out
    spread = max_rel(runs["k1_again"]["losses"], runs["k1"]["losses"])
    limit = max(GRAPH_TOL, spread)
    dev = max_rel(runs["k4"]["losses"], runs["k1"]["losses"])
    test_dev = max_rel(runs["k4"]["test_l2_fulls"], runs["k1"]["test_l2_fulls"])
    if not (dev <= limit and test_dev <= limit):
        raise AssertionError(f"dispatch_ti: K = {K} losses differ from K = 1 by {dev} (test "
                             f"{test_dev}); limit {limit} (eager spread {spread})")

    ds = MixedTemporalDataset([name], res=128, t_in=10, t_ar=1, train=True)
    x, y, _, cls = next(iter(DataLoader(ds, K * B, shuffle=True, num_workers=4, seed=1)))
    stacked = {"x": torch.from_numpy(x).to("cuda", torch.bfloat16),
               "y": torch.from_numpy(y).cuda(), "cls": torch.from_numpy(cls).cuda()}
    stacked = {k: v.reshape(K, B, *v.shape[1:]) for k, v in stacked.items()}
    kw = dict(noise_scale=noise, ones_mask=True, time_major=bool(ds.time_major_batches))
    state = outs["k4"]["state"]
    eager = train_step_profile(state, {k: v[0] for k, v in stacked.items()},
                               make_train_step(**kw))
    graphed = dispatch_profile(state, stacked, make_train_step(scan_steps=K, **kw))
    row = dict(dtype="bfloat16", batch=B, steps=steps, dispatch_units=units,
               launches=runs["k4"]["launches"], launches_by_path=runs["k4"]["launches_by_path"],
               bias_act_launches=sum(r["bias_act_launches"] for r in runs.values()),
               loss_rel_diff=dev, test_loss_rel_diff=test_dev, eager_spread=spread,
               limit=limit, runs=runs, profile_k1=eager, profile_k4=graphed)
    log("dispatch_ti", **row)
    return row


def phase_dispatch_l(model) -> dict:
    """One dispatch of two bf16 lamb DPOT-L steps at batch 16 with remat
    (train_L's model) replayed from the state its first call left, against
    two eager steps from the same state, batches and noise, twice (the
    eager path's own spread): both losses and every weight and moment;
    each way's wall, device busy and peak memory. The model's weights are
    put back as they came."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    K = DISPATCH_L_K
    parts = l_corpus_batches(K, seed=50)
    stacked = {k: torch.stack([b[k] for b in parts]) for k in parts[0]}
    if not model.remat:
        raise AssertionError("dispatch_l expects train_L's model, with remat")
    # the phase trains the model; params_lp_L then starts from its weights
    # as train_L left them
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, build_optimizer("lamb", model.parameters(),
                                                     PARAMS_LP["lr"]), 0)
    fn = make_train_step(scan_steps=K, noise_scale=5e-4, ones_mask=True)
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)

    def eager_steps():
        return [step_fn(state, {k: v[i] for k, v in stacked.items()})[1]["loss_step"]
                for i in range(K)]

    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    fn(state, stacked)  # K eager steps on a side stream, then the capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start = [t.clone() for t in state_tensors(state)]
    host = (state.step, state.optimizer.count)

    def rewind():
        with torch.no_grad():
            for dst, src in zip(state_tensors(state), start):
                dst.copy_(src)
        state.step, state.optimizer.count = host

    ways = {}
    for way in ("graphed", "eager", "eager_again"):
        rewind()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses = fn(state, stacked)[1]["loss_step"] if way == "graphed" else eager_steps()
        torch.cuda.synchronize()
        # the phase holds copies of the state besides the live one: the peak
        # is also read as what the run adds to what was allocated at its
        # start. A replay allocates almost nothing: its activations live in
        # the graph's private pool, which the reserved bytes count
        ways[way] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                         peak_over_start_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                         reserved_gb=torch.cuda.memory_reserved() / 1e9,
                         losses=[float(v) for v in losses])
        if way != "eager_again":
            ways[way]["out"] = [t.clone() for t in state_tensors(state)]
    torch.cuda.synchronize()
    launches = fused_gn_afno.launches
    by_path = check_paths("bfloat16", launches, "hopper_l")
    # the first call's K steps, the replay's K and twice K eager, two
    # applications a step under remat
    if launches != 4 * K * 2 * DPOT_L["depth"]:
        raise AssertionError(f"dispatch_l: {launches} launches, expected "
                             f"{4 * K * 2 * DPOT_L['depth']}")
    ref = ways["eager"].pop("out")
    got = ways["graphed"].pop("out")
    loss_spread = max_rel(ways["eager_again"]["losses"], ways["eager"]["losses"])
    tensor_spread = worst_rel_l2(state_tensors(state), ref)
    loss_dev = max_rel(ways["graphed"]["losses"], ways["eager"]["losses"])
    tensor_dev = worst_rel_l2(got, ref)
    del got, ref, start
    limits = dict(loss=max(GRAPH_TOL, loss_spread), tensors=max(GRAPH_TOL, tensor_spread))
    if not (loss_dev <= limits["loss"] and tensor_dev <= limits["tensors"]):
        raise AssertionError(f"dispatch_l: graph against eager: losses {loss_dev}, weights "
                             f"and moments {tensor_dev}; limits {limits}")
    for way, run in (("graphed", lambda: fn(state, stacked)), ("eager", eager_steps)):
        events = [e for e in profile_events(run, 3) if is_kernel(e)]
        busy = union_us(events) / 3 / 1e3 if events else None
        ways[way].update(device_busy_ms=busy if events else "not measured",
                         device_idle_share=1 - busy / ways[way]["wall_ms"] if events
                         else "not measured")
    del fn, state
    model.load_state_dict(weights)
    del weights
    torch.cuda.empty_cache()
    row = dict(dtype="bfloat16", batch=L_BATCH, steps_per_dispatch=K, first_call_s=first_s,
               launches=launches, launches_by_path=by_path, bias_act_launches=bias_act.launches,
               loss_rel_diff=loss_dev, tensor_rel_l2=tensor_dev, loss_spread=loss_spread,
               tensor_spread=tensor_spread, limits=limits, **ways)
    log("dispatch_l", **row)
    return row


def phase_rollouts(model_l) -> dict:
    """The one-dispatch rollouts against eager ones: DPOT-Ti bf16 served
    in-process (RolloutServer, eager and graphed, each twice, in turns) at
    B = 1 and 8 and 4 steps, request latency and model application wall,
    every answer against a direct loop over model(x); DPOT-L bf16 (eval_L's
    model) evaluated at B = 8 with graphed and eager rollouts, in turns:
    avg_step_time, the losses, and one batch's predictions from a replay
    against the eager rollout's. Launches exact over the served and the
    evaluated runs."""
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.serve import RolloutServer
    from dpot_tpu_torch.train.evaluator import evaluate
    from dpot_tpu_torch.train.step import make_eval_rollout

    model = preset_model("Ti", "bfloat16", seed=0)
    rng = np.random.default_rng(21)
    xs = {B: rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32) for B in (1, 8)}
    reset_launch_counts()
    ti_apps = 0
    serve, answers = {}, {}
    for way in ("eager", "graphed", "graphed_again", "eager_again"):
        rs = RolloutServer(model, max_wait_ms=0.0, warmup_steps=(ROLLOUT_STEPS,),
                           device="cuda")
        rs._graphed = way.startswith("graphed")
        rs.start()
        ti_apps += (len(rs.batch_buckets) if rs._graphed else 1) * ROLLOUT_STEPS
        row = {}
        try:
            for B, x in xs.items():
                lat = []
                for _ in range(ROLLOUT_REQUESTS):
                    t0 = time.perf_counter()
                    pred = rs.submit(x, ROLLOUT_STEPS)
                    lat.append((time.perf_counter() - t0) * 1e3)
                answers[(way, B)] = torch.from_numpy(pred)
                xd = rs._upload(rs._to_wire(x))
                app = []
                for _ in range(ROLLOUT_REQUESTS):
                    t0 = time.perf_counter()
                    rs._rollout(xd, ROLLOUT_STEPS)
                    app.append((time.perf_counter() - t0) * 1e3 / ROLLOUT_STEPS)
                ti_apps += 2 * ROLLOUT_REQUESTS * ROLLOUT_STEPS
                row[f"B{B}"] = dict(latency_ms_p50=statistics.median(lat), latency_ms=lat,
                                    application_ms=statistics.median(app),
                                    application_ms_each=app)
            row["compiles"] = rs.metrics()["compiles"]
        finally:
            rs.stop(drain=True)
        serve[way] = row
    wire = torch.bfloat16
    direct = {B: direct_rollout(model, x, ROLLOUT_STEPS, wire).cpu() for B, x in xs.items()}
    ti_apps += len(xs) * ROLLOUT_STEPS
    spread = max(rel_l2(answers[("eager_again", B)], answers[("eager", B)]) for B in xs)
    limit = max(GRAPH_TOL, spread)
    vs_direct = {f"{way}/B{B}": rel_l2(answers[(way, B)], direct[B]) for way, B in answers}
    if not max(vs_direct.values()) <= limit:
        raise AssertionError(f"rollouts: served answers against a direct loop {vs_direct}, "
                             f"limit {limit}")

    name = EVAL_L_SPEC["name"]
    evals = {}
    l_apps = 0
    for way in ("graphed", "eager", "eager_again", "graphed_again"):
        with contextlib.ExitStack() as stack:
            if way.startswith("eager"):
                stack.enter_context(eager_eval())
            got = evaluate(model_l, [name], res=128, t_in=10, batch_size=EVAL_BATCH,
                           num_workers=4)
        l_apps += eval_applications(EVAL_L_SPEC)
        evals[way] = dict(avg_step_time_s=got["avg_step_time"], **got[name])
    ds = MixedTemporalDataset([name], res=128, t_in=10, t_ar=-1, n_channels=4, train=False)
    x, y, msk, _ = next(iter(DataLoader(ds, EVAL_BATCH, shuffle=False, num_workers=0)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in (("x", x), ("y", y), ("msk", msk))}
    roll = make_eval_rollout()
    roll(model_l, batch)
    replayed = roll(model_l, batch)["pred"]
    ref, again = (roll.run(model_l, batch)["pred"] for _ in range(2))
    l_apps += 4 * EVAL_L_SPEC["t_test"]
    torch.cuda.synchronize()
    by_path = dict(fused_gn_afno.launches_by_path)
    want = dict.fromkeys(afno_fused.PATHS, 0)
    want.update(hopper=TI["depth"] * ti_apps, hopper_l=DPOT_L["depth"] * l_apps)
    if by_path != want:
        raise AssertionError(f"rollouts: launches by path {by_path}, expected {want}")
    pred_spread = rel_l2(again, ref)
    pred_limit = max(GRAPH_TOL, pred_spread)
    pred_dev = rel_l2(replayed, ref)
    loss_dev = max(abs(evals["graphed"][k] - evals["eager"][k]) / abs(evals["eager"][k])
                   for k in ("loss_step", "loss_full"))
    loss_spread = max(abs(evals["eager_again"][k] - evals["eager"][k]) / abs(evals["eager"][k])
                      for k in ("loss_step", "loss_full"))
    if not (pred_dev <= pred_limit and loss_dev <= max(GRAPH_TOL, loss_spread)):
        raise AssertionError(f"rollouts: eval_L graph against eager: predictions {pred_dev} "
                             f"(limit {pred_limit}), losses {loss_dev} (eager spread "
                             f"{loss_spread})")
    row = dict(dtype="bfloat16", steps=ROLLOUT_STEPS, requests=ROLLOUT_REQUESTS, serve=serve,
               serve_vs_direct_rel_l2=vs_direct, serve_eager_spread=spread, serve_limit=limit,
               eval_l=evals, eval_pred_rel_l2=pred_dev, eval_pred_spread=pred_spread,
               eval_loss_rel_diff=loss_dev, eval_loss_spread=loss_spread,
               ti_applications=ti_apps, l_applications=l_apps,
               launches=sum(by_path.values()), launches_by_path=by_path,
               bias_act_launches=bias_act.launches)
    log("rollouts", **row)
    return row


def phase_stale_weights() -> dict:
    """A DPOT-Ti bf16 train step (adam, batch 4) captured as a graph after
    its eager first call and replayed 3 times, the eval rollout's graph
    (captured at the first evaluation) replayed after each step, against
    the same steps and rollouts run eagerly from the same weights, twice
    (the eager path's own spread): every loss, prediction and final weight.
    A graph that read a cached bf16 copy of the AFNO weights would replay
    the weights of its capture. The control shows that this check sees
    that: a rollout captured while the wrapper takes the cached copies
    (as it did before the port's graphs), replayed after a train step,
    must land above the limit."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import KStepDispatch, make_eval_rollout, make_train_step

    B, n, t_test = STALE["batch"], STALE["replays"], STALE["t_test"]
    gen = torch.Generator(device="cuda").manual_seed(60)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    train_batches = [{"x": rnd(1, B, 128, 128, 10, 4).to(torch.bfloat16),
                      "y": rnd(1, B, 128, 128, 1, 4),
                      "cls": torch.zeros((1, B), dtype=torch.long, device="cuda")}
                     for _ in range(n + 1)]
    eval_batch = {"x": rnd(B, 128, 128, 10, 4), "y": rnd(B, 128, 128, t_test, 4),
                  "msk": torch.ones((B, 128, 128, 1, 4), device="cuda")}
    step = make_train_step(noise_scale=5e-4, ones_mask=True)

    def fresh():
        model = preset_model("Ti", "bfloat16", seed=3)
        return TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 4)

    def eager_run():
        state = fresh()
        roll = make_eval_rollout()
        losses, preds = [], []
        for b in train_batches:
            losses.append(step(state, {k: v[0] for k, v in b.items()})[1]["loss_step"].item())
            preds.append(roll.run(state.model, eval_batch)["pred"])
        return losses, preds, state

    reset_launch_counts()
    graphed = fresh()
    dispatch = KStepDispatch(step, 1)
    roll = make_eval_rollout()
    g_losses, g_preds = [], []
    for b in train_batches:
        g_losses.append(dispatch(graphed, b)[1]["loss_step"][0].item())
        g_preds.append(roll(graphed.model, eval_batch)["pred"])
    e_losses, e_preds, eager = eager_run()
    torch.cuda.synchronize()
    launches = fused_gn_afno.launches
    by_path = check_paths("bfloat16", launches)
    # each way: n + 1 steps and as many rollouts of t_test applications
    if launches != 2 * TI["depth"] * (n + 1) * (1 + t_test):
        raise AssertionError(f"stale_weights: {launches} launches")
    a_losses, a_preds, again = eager_run()
    spread = max(max_rel(a_losses, e_losses), worst_rel_l2(a_preds, e_preds),
                 worst_rel_l2(state_tensors(again), state_tensors(eager)))
    limit = max(GRAPH_TOL, spread)
    devs = dict(losses=max_rel(g_losses, e_losses), preds=worst_rel_l2(g_preds, e_preds),
                tensors=worst_rel_l2(state_tensors(graphed), state_tensors(eager)))
    if not max(devs.values()) <= limit:
        raise AssertionError(f"stale_weights: graph against eager {devs}, limit {limit}")

    control = fresh()
    roll_c = make_eval_rollout()
    real = afno_fused.capturing
    afno_fused.capturing = lambda: False
    try:
        roll_c(control.model, eval_batch)  # eager, caches the copies; the capture takes them
    finally:
        afno_fused.capturing = real
    step(control, {k: v[0] for k, v in train_batches[0].items()})
    stale = rel_l2(roll_c(control.model, eval_batch)["pred"],
                   roll_c.run(control.model, eval_batch)["pred"])
    if not stale > limit:
        raise AssertionError(f"stale_weights: a rollout captured with cached weight copies "
                             f"replays within {stale} of the eager one (limit {limit})")
    row = dict(dtype="bfloat16", batch=B, replays=n, launches=launches,
               launches_by_path=by_path, bias_act_launches=bias_act.launches,
               graphed_losses=g_losses, eager_losses=e_losses, rel_diff=devs,
               eager_spread=spread, limit=limit, control_cached_copies_rel_l2=stale)
    log("stale_weights", **row)
    return row


def ft3d_shares(events, runs: int, busy: float) -> dict:
    """The parts of a DPOT3D train step's device time: the cuFFT kernels of
    the 3D mixer, the mode MLP's products (aten::bmm, which only its einsums
    call), the product of out_layer.0 (the aten::mm calls on its (D, p^3 O)
    kernel, forward and backward) and the other dense GEMMs (aten::mm and
    aten::addmm), from a profile that recorded shapes; ms per step."""
    from torch.autograd import DeviceType

    fft = union_us([e for e in events if is_kernel(e) and "fft" in e.name.lower()])
    out0_cols = 8 ** 3 * L3D["out_layer_dim"]

    def leaf_ms(names, pick=lambda e: True) -> float:
        return sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU
                   and e.name in names and pick(e)) / runs / 1e3

    out0 = leaf_ms(("aten::mm", "aten::addmm"),
                   lambda e: any(out0_cols in tuple(s) for s in e.input_shapes if s))
    parts = dict(fft=fft / runs / 1e3, mode_mlp=leaf_ms(("aten::bmm",)), out_layer0=out0,
                 dense_gemm=leaf_ms(("aten::mm", "aten::addmm")) - out0)
    return {**{f"{k}_ms": v for k, v in parts.items()},
            **{f"{k}_share": v / busy for k, v in parts.items()}}


def phase_finetune3d_l() -> dict:
    """DPOT3D at DPOT-L's widths through the finetune3d CLI, inflated from
    the seeded L 2D .pth, bf16: the inflated count, finite losses, no
    fused_gn_afno launch, the checkpoint restoring; then cli.evaluate
    --metrics on the checkpoint, whose loss_full equals the loop's last test
    metric; then where a train step's time goes, its peak memory, and the
    loader's time per batch."""
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.cli.finetune3d import main as finetune3d_main
    from dpot_tpu_torch.data import DataLoader, TemporalDataset3D
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.train.checkpoint import restore_params
    from dpot_tpu_torch.train.step import make_train_step

    name = FT3D_SPEC["name"]
    make_synthetic_spec(**FT3D_SPEC)
    pth = RUN_DIR / "L.pth"
    if not pth.exists():
        save_reference_pth(preset_model("L", "float32", seed=0, device="cpu"), pth)
    log_path = RUN_DIR / "finetune3d"
    argv = L3D_ARCH + ["--train_paths", name, "--batch_size", str(FT3D["batch"]),
                       "--epochs", str(FT3D["epochs"]), "--warmup_epochs", "1",
                       "--lr", "1e-4", "--dtype", "bfloat16", "--num_workers", "8",
                       "--use_writer", "true", "--log_path", str(log_path),
                       "--resume_path", str(pth), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = finetune3d_main(argv)
    torch.cuda.synchronize()
    run_s, run_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    check_no_launch(0, "finetune3d_L")
    if len(out["copied"]) != FT3D_INFLATED or \
            f"inflated {FT3D_INFLATED} 2D entries" not in printed.getvalue():
        raise AssertionError(f"finetune3d inflated {len(out['copied'])} entries, expected "
                             f"{FT3D_INFLATED}")
    losses = out["train_l2_step"] + out["test_l2_full"]
    if len(losses) != 2 * FT3D["epochs"] or not finite(losses):
        raise AssertionError(f"finetune3d losses: {losses}")
    state = out["state"]
    restored = restore_params(str(log_path))
    for k, v in state.params_state_dict().items():
        if not torch.equal(restored[k], v.cpu()):
            raise AssertionError(f"finetune3d checkpoint: {k} does not restore")
    del restored

    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path", str(log_path),
                             "--test_paths", name, "--batch_size", str(FT3D["batch"]),
                             "--dtype", "bfloat16", "--num_workers", "8", "--metrics",
                             "--device", "cuda"])
    torch.cuda.synchronize()
    check_no_launch(0, "finetune3d_L's evaluation")
    vals = got[name]
    rel = abs(vals["loss_full"] - out["test_l2_full"][-1]) / out["test_l2_full"][-1]
    if not finite(vals.values()) or not rel <= FT_EVAL_TOL:
        raise AssertionError(f"3D evaluate: {vals}, loss_full against the loop's "
                             f"{out['test_l2_full'][-1]}: rel {rel} (limit {FT_EVAL_TOL})")
    bias_act_launches = bias_act.launches
    by_path = dict(fused_gn_afno.launches_by_path)
    steps = state.step

    ds = TemporalDataset3D(name, res=64, t_in=10, t_ar=1, train=True)
    x, y, msk, _ = next(iter(DataLoader(ds, FT3D["batch"], shuffle=False, num_workers=8,
                                        prefetch=0)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in (("x", x), ("y", y), ("msk", msk))}
    batch["cls"] = torch.zeros(FT3D["batch"], dtype=torch.int64, device="cuda")
    prof = train_step_profile(state, batch, make_train_step(), runs=5, weight_copies=True,
                              extra=ft3d_shares)
    check_no_launch(0, "finetune3d_L's profiled steps")
    # the device time of one trunk GroupNorm's forward and backward alone,
    # at the step's shape (the step's profile cannot tell its composed
    # elementwise ops from others; CUDA events around it would time the
    # host, which issues its small kernels slower than the card runs them)
    xg = torch.randn((FT3D["batch"], 8, 8, 8, L3D["embed_dim"]), device="cuda",
                     dtype=torch.bfloat16, requires_grad=True)
    g_out = torch.randn_like(xg)
    norm = state.model.blocks[0].norm1
    gn_events = [e for e in profile_events(lambda: norm(xg).backward(g_out), 20)
                 if is_kernel(e)]
    if gn_events and isinstance(prof.get("device_busy_ms"), float):
        gn_ms = union_us(gn_events) / 20 / 1e3
        per_step = 2 * DPOT_L["depth"]
        prof.update(group_norm_call_ms=gn_ms, group_norms_per_step=per_step,
                    group_norm_step_ms=gn_ms * per_step,
                    group_norm_share=gn_ms * per_step / prof["device_busy_ms"])
    loads = out["load_seconds"]
    row = dict(dtype="bfloat16", inflated=len(out["copied"]), steps=steps,
               params_m=sum(q.numel() for q in state.model.parameters()) / 1e6,
               train_l2_step=out["train_l2_step"], test_l2_full=out["test_l2_full"],
               evaluate=vals, evaluate_rel=rel, evaluate_limit=FT_EVAL_TOL,
               launches=fused_gn_afno.launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, run_s=run_s, run_peak_memory_gb=run_peak,
               cli_step_s=out["step_seconds"], loader_s_per_batch=statistics.median(loads),
               loader_s_each=loads, step=prof)
    log("finetune3d_l", **row)
    return row


@contextlib.contextmanager
def halved_kw_mixer():
    """The 3D mixer wrong on purpose: it keeps kw = min(modes, Y//2+1) of
    the second axis, as the 2D mixer halves its last axis, where the 3D
    reference keeps min(modes, Y)."""
    from dpot_tpu_torch.models import dpot3d
    from dpot_tpu_torch.ops import spectral

    def wrong(x, w1, b1, w2, b2, modes, temporal_modes, act, compute_dtype=None):
        H, W, L = x.shape[1:4]
        x32 = x.float()
        corner = (min(modes, H), min(modes, W // 2 + 1), min(temporal_modes, L // 2 + 1))
        y = spectral._corner_mlp(x32, corner, w1, b1, w2, b2, act, compute_dtype)
        return (y + x32).to(x.dtype)

    real = dpot3d.afno_filter_3d
    dpot3d.afno_filter_3d = wrong
    try:
        yield
    finally:
        dpot3d.afno_filter_3d = real


def phase_card_vs_cpu_3d() -> dict:
    """DPOT3D at L width and depth 2, f32, B = 1, 64^3, its AFNO weights
    redrawn from N(0, MIXER_SCALE^2): the card's forward (cuFFT, cuBLAS)
    against the CPU's within CPU_TOL, and a CPU mixer wrong on purpose
    above it; then the 3D eval rollout replayed as a CUDA graph against
    the eager one, and the cuFFT plan cache unchanged by the capture and
    the replay."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.step import make_eval_rollout

    reset_launch_counts()
    model = build_model("DPOT3D", depth=CPU3D_DEPTH, dtype=torch.float32, device="cuda",
                        seed=11, **L3D)
    draw_mixer_weights(model, seed=12)
    cpu = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(31)
    x = rng.standard_normal((1, 64, 64, 64, 10, 5)).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to("cuda")).cpu()
        want = cpu(torch.from_numpy(x))
        with halved_kw_mixer():
            wrong = cpu(torch.from_numpy(x))
    rel, rel_wrong = rel_l2(got, want), rel_l2(wrong, want)
    limit = CPU_TOL["float32"]
    if not rel <= limit < rel_wrong:
        raise AssertionError(f"3D forward card vs CPU: rel-L2 {rel}, the wrong mixer's "
                             f"{rel_wrong}: the limit {limit} must lie between")
    del cpu

    y = rng.standard_normal((1, 64, 64, 64, ROLL3D_STEPS, 5)).astype(np.float32)
    batch = {"x": torch.from_numpy(x).to("cuda"), "y": torch.from_numpy(y).to("cuda"),
             "msk": torch.ones((1, 64, 64, 64, 1, 5), device="cuda")}
    plans = torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()]
    roll = make_eval_rollout()
    eager = roll.run(model, batch)
    sizes = [plans.size]
    first = roll(model, batch)       # eager, then the capture
    sizes.append(plans.size)
    replay = roll(model, batch)
    torch.cuda.synchronize()
    sizes.append(plans.size)
    graph = dict(pred=rel_l2(replay["pred"], eager["pred"]),
                 first_pred=rel_l2(first["pred"], eager["pred"]),
                 **{k: abs(replay[k].item() - eager[k].item()) / abs(eager[k].item())
                    for k in ("loss_step", "loss_full")})
    if roll.graphs.captures != 1 or max(graph.values()) > GRAPH_TOL or len(set(sizes)) != 1:
        raise AssertionError(f"3D rollout graph against eager: {graph} (limit {GRAPH_TOL}), "
                             f"captures {roll.graphs.captures}, plan cache sizes {sizes}")
    check_no_launch(0, "card_vs_cpu_3d")
    row = dict(dtype="float32", depth=CPU3D_DEPTH, rel_l2=rel, limit=limit,
               halved_kw_rel_l2=rel_wrong, graph_rel=graph, graph_limit=GRAPH_TOL,
               rollout_steps=ROLL3D_STEPS, cufft_plans=sizes,
               launches=fused_gn_afno.launches,
               launches_by_path=dict(fused_gn_afno.launches_by_path),
               bias_act_launches=bias_act.launches)
    log("card_vs_cpu_3d", **row)
    return row


def phase_separable_ti(dtype: str) -> dict:
    """DPOT-Ti at a 128^2 latent, above the fused op's 4096 px, where every
    block takes the separable route: one application on the card against
    the CPU's (CPU_TOL), one train step with a finite loss, the route's
    calls = depth x applications and no fused_gn_afno launch; then one
    application's wall, busy and idle at B = SEP_BATCH."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.ops.spectral import separable_gn_afno
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    model = build_model("DPOT", dtype=getattr(torch, dtype), device="cuda", seed=13, **SEP_TI)
    cpu = copy.deepcopy(model).to("cpu")  # before the train step moves the weights
    rng = np.random.default_rng(41)
    B, n = SEP_BATCH, SEP_TI["img_size"]
    x = rng.standard_normal((B, n, n, 10, 4)).astype(np.float32)
    batch = {"x": torch.from_numpy(x).to("cuda"),
             "y": torch.from_numpy(rng.standard_normal((B, n, n, 1, 4)).astype(np.float32)
                                   ).to("cuda"),
             "msk": torch.ones((B, n, n, 1, 4), device="cuda"),
             "cls": torch.zeros(B, dtype=torch.int64, device="cuda")}
    reset_launch_counts()
    with torch.inference_mode():
        got = model(batch["x"])[0].cpu()
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-4), seed=0)
    _, aux = make_train_step()(state, batch)
    loss = aux["loss_step"].item()
    calls, depth = separable_gn_afno.calls, TI["depth"]
    check_no_launch(0, f"separable_Ti {dtype}")
    if calls != depth * 2 or not math.isfinite(loss):
        raise AssertionError(f"separable_Ti {dtype}: the route called {calls} times, "
                             f"expected depth x applications = {depth * 2}; loss {loss}")
    with torch.inference_mode():
        want = cpu(torch.from_numpy(x))[0]
    del cpu
    rel, limit = rel_l2(got, want), CPU_TOL[dtype]
    if not rel <= limit:
        raise AssertionError(f"separable_Ti {dtype} card vs CPU: rel-L2 {rel} (limit {limit})")
    step = phase_step(dtype, model=model, preset=f"Ti@{n}/p4", batches=(B,))[0]
    row = dict(dtype=dtype, latent_px=(n // SEP_TI["patch_size"]) ** 2, batch=B,
               separable_calls=calls, applications=2, card_vs_cpu_rel_l2=rel, limit=limit,
               train_loss_step=loss, launches=fused_gn_afno.launches,
               launches_by_path=dict(fused_gn_afno.launches_by_path),
               bias_act_launches=bias_act.launches, application=step)
    log("separable_ti", **row)
    return row


def cdpot_sweep_model_kw() -> dict:
    """build_model's arguments for CDPOT at configs/cdpot_parallel.yaml's
    widths on the 128^2 grid (4 channels, T_in 10, its 12 classes)."""
    import yaml

    doc = yaml.safe_load(CDPOT_CONFIG.read_text())
    t = {k: v[0] for k, v in doc["tasks"].items()}
    return dict(img_size=t["res"], patch_size=t["patch_size"], embed_dim=t["width"],
                depth=t["n_layers"], n_blocks=t["n_blocks"], modes=t["modes"],
                mlp_ratio=t["mlp_ratio"], in_channels=4, in_timesteps=10,
                n_cls=len(doc["train_paths"]))


RESAMPLE_OPS = ("aten::_upsample_bilinear2d_aa", "aten::_upsample_bilinear2d_aa_backward")


def resample_share(events, runs: int, busy: float) -> dict:
    """The device time a step of the antialiased bilinear resampling
    (F.interpolate's aten::_upsample_bilinear2d_aa and its backward op)."""
    from torch.autograd import DeviceType

    ms = sum(e.device_time_total for e in events
             if e.device_type == DeviceType.CPU and e.name in RESAMPLE_OPS) / runs / 1e3
    return dict(resample_ms=ms, resample_share=ms / busy)


def phase_train_cdpot() -> tuple[dict, dict]:
    """Pretrain CDPOT through the sweep CLI (in-process) from
    configs/cdpot_parallel.yaml with only its data cut: f32, adam, batch
    20, Ti widths. The steps and launches exact (depth x (train + eval
    applications), all on afno_hopper_f32.cu), every loss finite, the
    checkpoint restoring to the state's weights; where a step's time goes
    (the fused kernel, its VJP, the resampling, peak memory); then
    cli.evaluate --config_from_ckpt --metrics on the checkpoint (launches
    exact, loss_full against the loop's last test metric), and cli.serve of
    it in bf16 (launches all on afno_hopper.cu, an answer against the same
    rollout with the mixer's plain version). Returns the train row (its
    launches the run's and the evaluation's) and the serve row."""
    import yaml

    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.cli.serve import main as serve_main
    from dpot_tpu_torch.cli.sweep import main as sweep_main
    from dpot_tpu_torch.train.checkpoint import restore_params
    from dpot_tpu_torch.train.step import make_train_step

    cfg_path, specs = sweep_file(CDPOT_CONFIG, "CDPOT", TRAIN_CDPOT, RUN_DIR)
    doc = yaml.safe_load(cfg_path.read_text())
    tasks = {k: v[0] for k, v in doc["tasks"].items()}
    batch, depth = tasks["batch_size"], tasks["n_layers"]
    if (doc["model"], doc["opt"], doc.get("dtype", "float32"), batch, tasks["width"],
            depth, tasks["n_blocks"]) != ("CDPOT", "adam", "float32", 20, 512, 4, 4):
        raise AssertionError(f"{CDPOT_CONFIG.name} no longer pretrains CDPOT as this phase "
                             "expects")
    names = [sp.name for sp in specs]
    steps, eval_apps = sweep_applications(specs, doc["data_weights"], batch,
                                          TRAIN_CDPOT["epochs"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        (out,) = sweep_main(["--config_file", str(cfg_path), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 1e9
    state, model = out["state"], out["model"]
    if type(model).__name__ != "CDPOTNet" or state.step != steps:
        raise AssertionError(f"train_cdpot: {type(model).__name__}, {state.step} steps, "
                             f"expected CDPOTNet and {steps}")
    if launches != depth * (steps + eval_apps):
        raise AssertionError(f"train_cdpot: fused_gn_afno launched {launches} times, "
                             f"expected depth x (train + eval applications) = "
                             f"{depth * (steps + eval_apps)}")
    by_path = check_paths("float32", launches, "hopper_f32")
    bias_act_launches = bias_act.launches
    metrics = read_metrics(out["log_dir"])
    losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
    losses += [out["train_l2_step"], out["train_l2_full"], *out["test_l2_steps"],
               *out["test_l2_fulls"]]
    if len(metrics.get("train_loss_step", [])) != steps or not finite(losses):
        raise AssertionError(f"train_cdpot losses missing or not finite: {metrics}")
    ckpt = str(Path(out["log_dir"]) / "model")
    saved, mine = restore_params(ckpt), state.params_state_dict()
    if saved.keys() != mine.keys() or not all(torch.equal(saved[k], mine[k].cpu())
                                               for k in saved):
        raise AssertionError("train_cdpot: the checkpoint does not restore to the state's "
                             "weights")

    (b,) = corpus_batches(CDPOT_CONFIG, "CDPOT", TRAIN_CDPOT, batch, torch.float32, 1, seed=1)
    del b["noise"]  # the step draws its noise from the state's generator, as in the run
    step_fn = make_train_step(noise_scale=tasks["noise_scale"], ones_mask=True)
    prof = train_step_profile(state, b, step_fn, extra=resample_share)
    loop = dict(loop_step_s=out["step_seconds"], train_l2_step=out["train_l2_step"],
                test_l2_fulls=out["test_l2_fulls"])
    del out, state, model, b
    torch.cuda.empty_cache()

    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path", ckpt,
                             "--train_paths", *names, "--test_paths", *names, "--metrics",
                             "--batch_size", str(batch), "--num_workers", "4",
                             "--device", "cuda"])
    torch.cuda.synchronize()
    eval_launches = fused_gn_afno.launches
    if eval_launches != depth * eval_apps // TRAIN_CDPOT["epochs"]:
        raise AssertionError(f"train_cdpot evaluate: {eval_launches} launches, expected "
                             f"{depth * eval_apps // TRAIN_CDPOT['epochs']}")
    eval_by_path = check_paths("float32", eval_launches, "hopper_f32")
    bias_act_launches += bias_act.launches
    eval_rel = max(abs(got[n]["loss_full"] - last) / last
                   for n, last in zip(names, loop["test_l2_fulls"]))
    if not eval_rel <= FT_EVAL_TOL or not finite(v for n in names for v in got[n].values()):
        raise AssertionError(f"train_cdpot evaluate against the loop: rel {eval_rel} (limit "
                             f"{FT_EVAL_TOL}): {got}")

    reset_launch_counts()
    httpd, rs = serve_main(["--config_from_ckpt", "true", "--resume_path", ckpt,
                            "--train_paths", *names, "--n_channels", "4", "--dtype", "bfloat16",
                            "--port", "0", "--device", "cuda"], wait=False)
    try:
        sent = send_requests(httpd.server_address[1], (1, 2), "float32", seed=9)
        applications = warmup_applications(rs) + sum(r["steps"] for r in sent)
        torch.cuda.synchronize()
        serve_launches = fused_gn_afno.launches
        if serve_launches != depth * applications:
            raise AssertionError(f"serve_cdpot: {serve_launches} launches, expected depth x "
                                 f"applications = {depth * applications}")
        serve_by_path = check_paths("bfloat16", serve_launches, "hopper")
        serve_bias_act = bias_act.launches
        rels = []
        for r in sent[::2]:  # the f32 bodies
            with plain_mixer():
                ref = direct_rollout(rs.model, r["x"], r["steps"], torch.bfloat16).cpu()
            rels.append(rel_l2(torch.from_numpy(r["pred"]), ref))
        check_no_launch(serve_launches, "serve_cdpot's plain-mixer rollouts")
        if max(rels) > CDPOT_SERVE_TOL:
            raise AssertionError(f"serve_cdpot against the plain mixer: rel-L2 {rels} (limit "
                                 f"{CDPOT_SERVE_TOL})")
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()
    row = dict(dtype="float32", batch=batch, steps=steps, train_applications=steps,
               eval_applications=eval_apps, run_launches=launches,
               run_launches_by_path=by_path, evaluate_launches=eval_launches,
               launches=launches + eval_launches,
               launches_by_path={k: v + eval_by_path[k] for k, v in by_path.items()},
               bias_act_launches=bias_act_launches, run_s=run_s, run_peak_memory_gb=run_peak,
               **loop, evaluate_rel=eval_rel, evaluate_limit=FT_EVAL_TOL,
               evaluate_metrics={n: got[n] for n in names[:2]},
               corpora={sp.name: dict(channels=sp.n_channels, in_size=sp.in_size,
                                      t_total=sp.t_total, t_test=sp.t_test) for sp in specs},
               **prof)
    serve_row = dict(dtype="bfloat16", requests=len(sent), applications=applications,
                     launches=serve_launches, launches_by_path=serve_by_path,
                     bias_act_launches=serve_bias_act, plain_mixer_rel_l2=rels,
                     limit=CDPOT_SERVE_TOL, client_p50_ms=statistics.median(r["ms"] for r in sent))
    log("train_cdpot", **row)
    log("serve_cdpot", **serve_row)
    return row, serve_row


@contextlib.contextmanager
def raw_irfftn():
    """The FNOs' real inverse FFT as torch.fft.irfftn alone, whose result
    for a non-Hermitian spectrum is the library's (cuFFT's on the card): the
    card-vs-CPU control of card_vs_cpu_families."""
    from dpot_tpu_torch.models import fno

    real = fno.irfftn_pair
    fno.irfftn_pair = lambda re, im, s, dims, norm="ortho": torch.fft.irfftn(
        torch.complex(re, im), s=s, dim=dims, norm=norm)
    try:
        yield
    finally:
        fno.irfftn_pair = real


def unet_dispatch_check(kw: dict) -> dict:
    """UNet's BatchNorm statistics under CUDA graphs: UNET_DISPATCH's K-step
    dispatches (the first run eagerly as the capture's warm-up, then
    replays) against as many eager steps from the same weights, batches and
    noise stream: every loss, weight, moment and running statistic within
    GRAPH_TOL, the batch counts equal. cuDNN's default convolution
    backward is not deterministic (two eager runs differ), so both run
    with its deterministic algorithms."""
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    K, n, B = UNET_DISPATCH["K"], UNET_DISPATCH["dispatches"], UNET_DISPATCH["batch"]
    states = []
    for _ in range(2):
        model = build_model("UNet", dtype=torch.float32, device="cuda", seed=21, **kw)
        states.append(TrainState.create(
            model, build_optimizer("adam", model.parameters(), UNET_DISPATCH["lr"]), seed=5))
    graphed, eager = states
    rng = np.random.default_rng(61)
    size = kw["img_size"]
    batches = [{"x": torch.from_numpy(rng.standard_normal((K, B, size, size, 10, 4)
                                                          ).astype(np.float32)).cuda(),
                "y": torch.from_numpy(rng.standard_normal((K, B, size, size, 1, 4)
                                                          ).astype(np.float32)).cuda(),
                "cls": torch.zeros((K, B), dtype=torch.int64, device="cuda")}
               for _ in range(n)]
    step_kw = dict(noise_scale=5e-4, ones_mask=True)
    dispatch = make_train_step(scan_steps=K, **step_kw)
    step = make_train_step(**step_kw)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = [v for bt in batches for v in dispatch(graphed, bt)[1]["loss_step"].tolist()]
        want = [step(eager, {k: v[i] for k, v in bt.items()})[1]["loss_step"].item()
                for bt in batches for i in range(K)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    stats = [dict(graphed.model.named_buffers()), dict(eager.model.named_buffers())]
    running = [k for k in stats[0] if "running" in k]
    counts = {k for k in stats[0] if k.endswith("num_batches_tracked")}
    out = dict(losses=max_rel(got, want),
               weights_moments=worst_rel_l2(state_tensors(graphed), state_tensors(eager)),
               running_stats=worst_rel_l2([stats[0][k] for k in running],
                                          [stats[1][k] for k in running]))
    tracked = {stats[0][k].item() for k in counts} | {stats[1][k].item() for k in counts}
    if max(out.values()) > GRAPH_TOL or tracked != {n * K}:
        raise AssertionError(f"UNet dispatches against eager steps: {out} (limit {GRAPH_TOL}), "
                             f"batches tracked {tracked}, expected {n * K}")
    return dict(rel=out, batches_tracked=n * K, k=K, dispatches=n, batch=B)


def phase_card_vs_cpu_families() -> dict:
    """Each model family's forward on the card against the CPU in f32
    (CPU_TOL; UNet in eval mode), CDPOT at configs/cdpot_parallel.yaml's
    widths with its AFNO weights redrawn, the FNOs with their spectral
    weights redrawn (FNO_SPECTRAL_SCALE) and FNO2d's forward with
    torch.fft.irfftn (raw_irfftn) above the limit; CDPOT's and UNet's eval rollouts
    replayed as graphs against the eager ones (GRAPH_TOL), CDPOT's launches
    = depth x applications, all on afno_hopper_f32.cu, the others none;
    UNet's statistics under graphed dispatches (unet_dispatch_check); and
    cli.convert of a seeded FNO3d reference .pth with torch.cfloat spectral
    weights, then cli.evaluate --metrics of the directory on a synthetic
    32^3 set."""
    from dpot_tpu_torch.cli.convert import main as convert_main
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.step import make_eval_rollout

    reset_launch_counts()
    cdpot_kw = cdpot_sweep_model_kw()
    common = dict(in_channels=4, in_timesteps=10, n_cls=cdpot_kw["n_cls"])
    cases = {"CDPOT": cdpot_kw, **{f: {**common, **kw} for f, kw in FAMILY_SIZES.items()}}
    rng = np.random.default_rng(71)
    row: dict = {"card_vs_cpu": {}, "graph_rel": {}, "limit": CPU_TOL["float32"]}
    cdpot_apps = 0
    for family, kw in cases.items():
        model = build_model(family, dtype=torch.float32, device="cuda", seed=17, **kw).eval()
        if family == "CDPOT":
            draw_mixer_weights(model, seed=18)
        elif family.startswith("FNO"):
            g = torch.Generator().manual_seed(18)
            with torch.no_grad():
                for p in model.spectral_convs.parameters():
                    p.copy_(torch.randn(p.shape, generator=g) * FNO_SPECTRAL_SCALE)
        grid = (kw["img_size"],) * (3 if family == "FNO3D" else 2)
        B = 1 if family == "FNO3D" else FAMILY_BATCH
        x = rng.standard_normal((B, *grid, 10, 4)).astype(np.float32)
        cpu = copy.deepcopy(model).to("cpu")

        def pred(m, xs):
            out = m(torch.from_numpy(xs).to(next(m.parameters()).device))
            return (out[0] if isinstance(out, tuple) else out).cpu()

        with torch.inference_mode():
            got, want = pred(model, x), pred(cpu, x)
            if family.startswith("FNO"):
                with raw_irfftn():
                    row.setdefault("raw_irfftn_rel_l2", {})[family] = rel_l2(pred(model, x),
                                                                             want)
        del cpu
        row["card_vs_cpu"][family] = rel = rel_l2(got, want)
        if not rel <= CPU_TOL["float32"]:
            raise AssertionError(f"{family} forward card vs CPU: rel-L2 {rel} (limit "
                                 f"{CPU_TOL['float32']})")
        if family == "FNO" and not row["raw_irfftn_rel_l2"][family] > CPU_TOL["float32"]:
            raise AssertionError(f"FNO2d with torch's irfftn on the card: rel-L2 "
                                 f"{row['raw_irfftn_rel_l2'][family]}, expected above the "
                                 f"limit {CPU_TOL['float32']}")
        cdpot_apps += family == "CDPOT"
        if family in ("CDPOT", "UNet"):
            y = rng.standard_normal((B, *grid, FAMILY_ROLL_STEPS, 4)).astype(np.float32)
            batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda(),
                     "msk": torch.ones((B, *grid, 1, 4), device="cuda")}
            roll = make_eval_rollout()
            eager = roll.run(model, batch)
            first = roll(model, batch)        # eager, then the capture
            replay = roll(model, batch)
            torch.cuda.synchronize()
            graph = dict(pred=rel_l2(replay["pred"], eager["pred"]),
                         first_pred=rel_l2(first["pred"], eager["pred"]),
                         **{k: abs(replay[k].item() - eager[k].item()) / abs(eager[k].item())
                            for k in ("loss_step", "loss_full")})
            row["graph_rel"][family] = graph
            if roll.graphs.captures != 1 or max(graph.values()) > GRAPH_TOL:
                raise AssertionError(f"{family} rollout graph against eager: {graph} (limit "
                                     f"{GRAPH_TOL}), captures {roll.graphs.captures}")
            cdpot_apps += 3 * FAMILY_ROLL_STEPS * (family == "CDPOT")
        del model
    depth = cdpot_kw["depth"]
    launches = fused_gn_afno.launches
    if launches != depth * cdpot_apps:
        raise AssertionError(f"card_vs_cpu_families: {launches} launches, expected CDPOT's "
                             f"depth x applications = {depth * cdpot_apps}")
    row.update(launches=launches, launches_by_path=check_paths("float32", launches,
                                                               "hopper_f32"),
               cdpot_applications=cdpot_apps)
    row["unet_dispatch"] = unet_dispatch_check(cases["UNet"])

    # FNO3d: a reference-layout .pth (torch.cfloat spectral weights, DDP
    # prefixes) converted and evaluated
    before = fused_gn_afno.launches
    spec = make_synthetic_spec(**FNO3D_SPEC)
    ref = build_model("FNO3D", device="cpu", seed=19, **cases["FNO3D"]).state_dict()
    cfloat = {k: torch.complex(v[0], v[1]) if ".weights" in k else v for k, v in ref.items()}
    pth = RUN_DIR / "fno3d_ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in cfloat.items()}}, pth)
    ckpt = RUN_DIR / "fno3d_ckpt"
    flags = ["--train_paths", spec.name, "--num_workers", "4", "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        convert_main(["--model", "FNO3D", *FNO3D_ARCH, "--n_channels", "4", "--resume_path",
                      str(pth), "--out_path", str(ckpt), *flags])
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path", str(ckpt),
                             "--test_paths", spec.name, "--metrics", "--batch_size", "2",
                             *flags])
    converted = torch.load(ckpt / "model.pth", map_location="cpu", weights_only=False)["model"]
    if converted.keys() != ref.keys() or not all(torch.equal(converted[k], v)
                                                 for k, v in ref.items()):
        raise AssertionError("FNO3d: the converted weights are not the reference's, split")
    metrics = got[spec.name]
    if not finite(metrics.values()):
        raise AssertionError(f"FNO3d evaluate: {metrics}")
    check_no_launch(before, "the FNO3d conversion and evaluation")
    row.update(fno3d_evaluate=metrics, bias_act_launches=bias_act.launches,
               sizes={f: kw for f, kw in cases.items()})
    log("card_vs_cpu_families", **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        libraries=[p.name for p in build.library_paths().values()],
        torch=torch.__version__, cuda=torch.version.cuda)

    k = phase_kernels()
    vjp = phase_vjp()
    ba = phase_bias_act()
    serve_bf16 = phase_serve("bfloat16", "float32")
    serve_f32 = phase_serve("float32", "float16")
    for dtype in ("bfloat16", "float32"):
        phase_step(dtype)
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    train = {dtype: phase_train(dtype) for dtype in ("float32", "bfloat16")}
    dispatch_ti = phase_dispatch_ti()
    shutil.rmtree(RUN_DIR)
    phase_train_card_vs_cpu()
    serve_h, model_h = phase_serve_h()
    phase_step("bfloat16", model=model_h, preset="H")
    train_h = phase_train_h(model_h)
    del model_h
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    eval_l = {}
    for dtype in ("bfloat16", "float32"):
        eval_l[dtype], model = phase_eval_l(dtype)
        if dtype == "bfloat16":
            rollouts = phase_rollouts(model)
        del model
    stale = phase_stale_weights()
    train_l, model_l = phase_train_l()
    remat_l = phase_remat_l(model_l)
    dispatch_l = phase_dispatch_l(model_l)
    params_lp_l = phase_params_lp_l(model_l)
    del model_l
    torch.cuda.empty_cache()
    finetune_s = phase_finetune_s()
    varyres = phase_varyres_ti()
    convert = phase_convert_resume_serve()
    torch.cuda.empty_cache()
    finetune3d = phase_finetune3d_l()
    torch.cuda.empty_cache()
    shutil.rmtree(RUN_DIR)
    cpu_3d = phase_card_vs_cpu_3d()
    separable = {dtype: phase_separable_ti(dtype) for dtype in ("float32", "bfloat16")}
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    train_cdpot, serve_cdpot = phase_train_cdpot()
    families = phase_card_vs_cpu_families()
    shutil.rmtree(RUN_DIR)

    def batches(prefix, dtype):
        return CASE_BATCHES.get((prefix, getattr(torch, dtype)), KERNEL_BATCHES)

    def by_batch(prefix, dtype, path):
        return {f"B{B}": {key: x[key] for key in ("ms", "device_ms_each", "host_us", "plain_ms",
                                                  "bound_ms", "bound_fma_ms", "max_abs_err")
                          if key in x}
                for B in batches(prefix, dtype) for x in [k[f"{prefix}{dtype}/{path}/B{B}"]]}

    kernels = []
    # the runs of the main path in each compute type, whose launches count
    bf16_runs = {"serve[bfloat16]": serve_bf16, "train[bfloat16]": train["bfloat16"],
                 "dispatch_ti": dispatch_ti, "rollouts": rollouts, "stale_weights": stale,
                 "finetune_s": finetune_s, "varyres_ti": varyres,
                 "convert_resume_serve": convert, "finetune3d_l": finetune3d,
                 "separable_ti[bfloat16]": separable["bfloat16"], "serve_cdpot": serve_cdpot}
    f32_runs = {"serve[float32]": serve_f32, "train[float32]": train["float32"],
                "card_vs_cpu_3d": cpu_3d, "separable_ti[float32]": separable["float32"],
                "train_cdpot": train_cdpot, "card_vs_cpu_families": families}
    l_runs = {"eval_l[bfloat16]": eval_l["bfloat16"], "rollouts": rollouts,
              "train_l": train_l, "remat_l": remat_l, "dispatch_l": dispatch_l,
              "params_lp_l": params_lp_l}
    # (name, kernel-phase key prefixes of the shapes its main path gives it,
    # the first the one whose times the row carries, dtype, path, source,
    # the runs whose launches count)
    rows = (("fused_gn_afno[bf16,hopper]", ("", "S/"), "bfloat16", "hopper", "afno_hopper.cu",
             bf16_runs),
            ("fused_gn_afno[bf16,hopper_wide]", ("H/",), "bfloat16", "hopper_wide",
             "afno_hopper_wide.cu", {"serve_h": serve_h, "train_h": train_h}),
            ("fused_gn_afno[bf16,hopper_l]", ("L/",), "bfloat16", "hopper_l",
             "afno_hopper_l.cu", l_runs),
            ("fused_gn_afno[bf16,general]", ("L/",), "bfloat16", "general", "afno_fused.cu",
             {**l_runs, **bf16_runs}),
            ("fused_gn_afno[f32,hopper]", ("",), "float32", "hopper_f32", "afno_hopper_f32.cu",
             f32_runs),
            ("fused_gn_afno[f32,hopper_l]", ("L/",), "float32", "hopper_f32_l",
             "afno_hopper_f32_l.cu", {"eval_l[float32]": eval_l["float32"]}),
            ("fused_gn_afno[f32,general]", ("L/",), "float32", "general", "afno_fused.cu",
             {"eval_l[float32]": eval_l["float32"], **f32_runs}))
    for name, prefixes, dtype, path, src, runs in rows:
        prefix = prefixes[0]
        # the row's times at the batch of the shapes' main path: L's
        # pretraining in bf16, else 8
        B_row = L_BATCH if L_BATCH in batches(prefix, dtype) else 8
        r = k[f"{prefix}{dtype}/{path}/B{B_row}"]
        by_phase = {phase: run["launches_by_path"][path] for phase, run in runs.items()}
        kernels.append(dict(
            name=name, route="cuda", source=f"dpot_tpu_torch/csrc/{src}",
            replaces="dpot_tpu/ops/pallas/afno_fused.py:114",
            launches=sum(by_phase.values()),
            max_abs_err=max(k[f"{p}{dtype}/{path}/B{B}"]["max_abs_err"]
                            for p in prefixes for B in batches(p, dtype)),
            max_abs_err_over=[p or "Ti/" for p in prefixes],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            phase=" + ".join(p for p, n in by_phase.items() if n)
            or "none: no main path takes it (forced on in the kernel phase)",
            shapes=f"{prefix or 'Ti/'}{dtype}/B{B_row}", launches_by_phase=by_phase,
            check="pass", max_abs_limit=r["max_abs_limit"], rel_l2=r["rel_l2"],
            device_ms=r["device_ms"] and r["device_ms"]["total"],
            launches_per_call=r["device_ms"] and r["device_ms"]["launches_per_call"],
            host_us=r["host_us"],
            by_batch=by_batch(prefix, dtype, path),
            vjp_ms=vjp[dtype]["vjp_ms"], vjp_rel_l2=vjp[dtype]["rel_l2"],
        ))
        if "S/" in prefixes:
            kernels[-1]["by_batch_at_s"] = by_batch("S/", dtype, path)
        if path == "general":  # forced on at the L, Ti, S and H shapes
            kernels[-1]["by_batch_at_ti"] = by_batch("", dtype, path)
            if dtype == "bfloat16":
                kernels[-1]["by_batch_at_s"] = by_batch("S/", dtype, path)
                kernels[-1]["by_batch_at_h"] = by_batch("H/", dtype, path)
    # bias_act lies on no main path: its count over the serve and train runs
    bias_act_launches = sum(r["bias_act_launches"] for r in (
        serve_bf16, serve_f32, *train.values(), dispatch_ti, serve_h, train_h,
        *eval_l.values(), rollouts, stale, train_l, dispatch_l, finetune_s, finetune3d,
        cpu_3d, *separable.values(), train_cdpot, serve_cdpot, families))
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        r = ba[f"{dtype}/lrelu"]
        kernels.append(dict(
            name=f"bias_act[{short},lrelu]", route="cuda",
            source="dpot_tpu_torch/csrc/bias_act.cu",
            replaces="dpot_tpu/ops/pallas/bias_act_kernel.py:47",
            launches=bias_act_launches,
            max_abs_err=max(v["max_abs_err"] for key, v in ba.items()
                            if key.startswith(dtype)),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            phase="none: no main path calls bias_act", shapes=r["shape"],
            check="pass", device_ms=r["device_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
