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
       the same way, bf16 also at B = 16 (L's pretraining batch), and at a
       tensor-parallel rank's share (C 768) at B in {1, 4, 16}, each bf16
       batch also through afno_hopper_l.cu's control entry (the walk's last
       mode chunk, modes 128-143, left out), which must miss the limits; f32 at
       the DPOT-H block shapes on afno_hopper_f32_wide.cu in the same way;
       at the block shapes of configs/afno_config_single.yaml (C 512, 8
       AFNO blocks of 64 channels, one group each; B in {1, 8, 32}, 32 its
       batch) bf16 and f32 on the pair paths (each pair of blocks packed
       into one 128-channel block with block-diagonal weights, launched on
       afno_hopper.cu and afno_hopper_f32.cu) in the same way; bf16 at
       DPOT-M's block shapes at res 256 and 64 (C 1024, 8 blocks of 128; a
       32^2 latent, K 544, and an 8^2 latent, K 40; B in {1, 8, 20}) and at
       DPOT-L's at res 256 (B in {1, 8, 16}) on the streamed kernel
       (afno_hopper_stream.cu) in the same way; DPOT-M's blocks at the
       ragged latents of res 96 (12^2, K 84), 72 (9^2, K 45), 160 (20^2,
       K 220) and 64 at patch 16 (4^2, K 12), B in {1, 8, 20}, bf16 on the
       streamed kernel and f32 on afno_hopper_f32.cu (both on operators
       zero-padded to whole 64-px tiles and K a multiple of 4), and L's and H's at
       12^2 in f32 on their f32 kernels (B 8), in the same way; a control
       that puts a 16 in the padded operators (M at 12^2 and 9^2, both
       types, B 8), which must miss the limits; the seven shape gates
       against their mirrors in the CUDA sources, and the two pair gates
       against the mirrors of the kernels they launch, asked at the packed
       shapes;
     - its gradient (fused_gn_afno_vjp, torch ops, not a kernel) against
       torch.autograd through the plain version at the Ti block shapes of
       training (B = 20), with the plain version made to raise while the
       backward runs;
     - bias_act, all nine activations in f32 and bf16, at (8, 64, 64, 512)
       and at a ragged (3, 17, 5, 37), forward and gradient; then on its
       one caller's path, filtered_lrelu (ops/upfirdn2d.py: upfirdn2d up 2,
       bias_act lrelu, upfirdn2d down 2) at x (8, 64, 64, 512) f32 and bf16
       with a 12-tap separable lowpass and a 4x4 filter, each padded to a
       64^2 output: one bias_act launch a call (these are the kernel row's
       launches), the output and first-order gradient against the same
       composition through bias_act_ref, and its times;
  3. serve: `python -m dpot_tpu_torch.cli.serve` in-process at DPOT-Ti full
     width and depth (seeded weights), bf16 and then f32 compute, each
     answering rollout requests over HTTP on 127.0.0.1; every served
     rollout is checked for shape and finite values, one against a direct
     loop over model(x), the kernel's launch count against depth x model
     applications (bf16 all on the Hopper path, f32 all on the f32 Hopper
     path), and the served model's forward on the card against the same
     weights' forward on the CPU (the plain versions there);
  4. step: where one model application's time goes at B = 1 and 8 (wall
     time, device busy time and idle share, the fused kernel's part); at Ti
     bf16 a few applications inside utils/profiling.py's trace under a
     profiled_function range, the Chrome trace naming the range and
     afno_hopper.cu's kernel;
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
     copies, its VJP and the optimizer); the loop's checkpoints written on
     the asynchronous writer's thread, the last one bit-equal to a
     synchronous save of the same state; the loop's rollback snapshots,
     host (pinned) and device, taken with no synchronisation before a
     step, each giving the state back bit for bit, and the snapshot rule's
     mode and bytes;
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
     goes as in phase 5; the rollback snapshots' mode and bytes at H;
     then DPOT-H in f32, the serve CLI's default compute type (a second
     model, drawn after the bf16 one is freed): served as in bf16 with
     every AFNO weight of the served model redrawn from N(0,
     MIXER_SCALE^2), launches = depth x model applications, all on
     afno_hopper_f32_wide.cu, every answer within MIXER_TOL["H/float32"]
     of the same rollout with the plain mixer and two faulty plain mixers
     above it; one model application profiled at B = 1 and 8;
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
     8 as in phase 4, peak memory; in bf16 with --viz_dir (the JAX
     package's file names where matplotlib imports on the card's host,
     else none written), in f32 the rollback snapshots' mode and bytes at L
     with lamb's moments;
  9. train_L: `python -m dpot_tpu_torch.cli.sweep --config_file <copy of
     configs/pretrain_large.yaml>` in-process, the copy's data cut (twelve
     synthetic sets of their namesakes' grids, channels and lengths, 2
     train and 2 test trajectories each, 2 epochs) and every other key the
     file's but the depth, cut to 3 blocks: DPOT-L at full width, bf16,
     lamb, batch 16, remat.
     The steps exact, launches = depth x (2 x train + eval applications),
     all on afno_hopper_l.cu, every loss finite, the checkpoint restoring
     through restore_params; where a step's time goes as in phase 5, with
     the dense layers' f32->bf16 weight copies, and peak memory;
  10. remat_L: one bf16 L step at batch 16 with remat and without, from the
     same weights, batch and noise, train_L's model at its 3 blocks (a
     comparison of two runs of one model holds at any depth):
     the losses and every gradient compared (expected identical), each
     way's step time and peak memory;
  11. params_lp_L: five bf16 lamb L steps at batch 16 with the bf16 working
     copy of the parameters and without, at the same cut depth: each loss
     within 5 %, the copy the master's exact cast after every step, all
     launches on afno_hopper_l.cu, each way's step profile and weight-copy
     time;
  12. finetune_S: `python -m dpot_tpu_torch.cli.finetune` from a seeded
     4-channel DPOT-S .pth onto a synthetic 3-channel 128^2 set (40 train,
     8 test) with configs/dpot_finetune.yaml's optimization (load_components
     all) for 2 epochs in bf16 with --viz_dir (as eval_L's): the units
     copied, finite losses, launches all on the Hopper kernel, the final
     epoch's visuals; then cli.evaluate --config_from_ckpt on the
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
     DPOT3D at DPOT-L's widths (embed 1536, 16 AFNO blocks of 96, mlp_ratio
     4, out_layer_dim 128), its depth cut to 3 of L's 24 blocks, on a
     synthetic set of ns3d_pdb_M1_turb's grid, channels and lengths (64^3, 5 channels, 21
     frames, t_test 11; 8 train and 4 test trajectories), patch 8, modes 32
     and temporal_modes 8, bf16, batch 4, 2 epochs, inflated from eval_L's
     seeded L .pth (4 channels, 128^2): the inflated count, finite losses,
     no fused_gn_afno launch, the checkpoint restoring; cli.evaluate
     --metrics --viz_dir on its checkpoint (loss_full = the loop's last
     test metric; the mid-Z plane's and the volume's visuals as eval_L's);
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
The rest of the data layer, after phase 4:
  24. loader_ti: the host preprocessing library (dpot_tpu_torch/native,
     g++ on the card's host; its version, the host CPU and the build
     seconds logged) against its plain numpy versions there: pad_data_2d
     64^2 x 1 -> 128^2 x 4 and 96^2 x 3 -> 128^2 x 4 (and 128^2 x 3 ->
     128^2 x 4, numpy on both paths) and resize_trilinear_3d 48^3 -> 64^3
     within 1e-5, the batch assembly into
     f32 and bf16 slots bit for bit over fields with specials in them, and a
     bf16 plain version by truncation, wrong on purpose, caught; a corpus on
     disk of ns2d_fno_1e-5's shape (64^2, 20 frames, 1 channel) and of
     ns2d_pdb_M1_eta1e-1_zeta1e-1's (128^2, 21 frames, 4 channels,
     time-major), 64 train and 4 test trajectories each, in HDF5 where h5py
     imports, else raw f32 files; the loader's samples/s at B = 20 (a) on
     the plain path with fresh buffers and a pin a batch, (b) native item by
     item on the mixture, into a pinned ring with bf16 x, (c) the
     time-major set in one native call a batch into the same ring; (a)
     against (b) within 1e-5 and (c) against the per-item route bit for bit
     over an epoch; then the train CLI at DPOT-Ti in bf16, 2 epochs, on the
     mixture (profiled: the device's idle share) and on the time-major set
     eagerly and at 2 steps a dispatch (CUDA graphs): steps and launches
     exact, all hopper, and the graphed losses the eager ones bit for bit.
The parallel layer, after phase 23; its ranks are this script
under torchrun (`python3 chip_smoke.py rank <job> <args.json>`). Two
launches: the nccl rank of phase 25, and one of 2 ranks sharing the card
(gloo with CUDA tensors) that runs phase 25's job and then phase 26's.
Both start together; the one-process runs of both phases run while they
start up, the 2-rank jobs once the nccl rank is done (phase_parallel):
  25. ddp_cdpot: configs/cdpot_parallel.yaml's job (full widths, f32, adam,
     global B = 20; data cut as train_cdpot's, one epoch) in one process,
     and through torchrun on the 2 ranks (`--dist_backend gloo --device
     cuda:0`), each in cli.train's main under DDP: per-step losses, test
     metrics and final weights against one process's within 1e-5, each
     rank's launches depth x applications all on afno_hopper_f32.cu, rank
     0 alone writing the checkpoint, in the reference layout, which
     cli.serve then serves; each rank's step wall, global samples/s, busy,
     idle and the collectives' share (torch.profiler) beside one
     process's; every replicated tensor bit for bit over the 2 ranks
     (utils/inspection.py check_replica_consistency), and a control, one
     ulp changed in one rank's copy, caught; and the job on 1 rank on
     torchrun's default nccl, its evaluation cut to the first corpus,
     against one process within 1e-5;
  26. fsdp_l: seeded DPOT-L at full width and depth with
     configs/pretrain_large.yaml's optimization (bf16, lamb, its clip,
     remat, global B = 16) and shard_params fsdp on the 2 ranks, 3 steps,
     against one process's eager steps (losses within 2e-2); at every call
     the bf16 blocks that afno_hopper_l.cu read equal a fresh conversion of
     the weights FSDP2 gathered, bit for bit, each of those weights marked
     uncached, and a control forward through a cache keyed on the weight
     tensor alone (filled in the last step) fails that check; each rank's
     peak memory against one process's, the collectives' time;
  27. tp_l, pp_l, sp_l, tp_serve_l: the same seeded DPOT-L, optimization
     and batches on the same 2 ranks under shard_params tp (model = 2),
     mesh_pipe 2 and mesh_spatial 2 (f32), each rank held
     to one process on its losses, its first prediction, its first step's
     gradient and its parameter change after the steps, with controls
     (faults on purpose: fc2's all-reduce or the copy's backward all-reduce
     left out, the permute's wrong slot, the all-to-alls skipped) above
     their limits; launches exact per rank; and the L model served over
     model = 2 against one process's answers.
  28. the rest of the parallel layer, in the same launch, each rank
     held to one process as phase 27's are, with controls above their
     limits: fsdp_lp_l, tp_lp_l and pp_lp_l, L's widths at 6 blocks with
     the bf16 working copy under FSDP2, TP and the pipeline (fsdp_lp_l also
     writes a checkpoint over gloo, gathered with c10d collectives, rank
     0's write on the asynchronous writer's thread (the seconds in the
     call against the write's), which one process resumes; its control, a
     checkpoint gathered in the wrong shard order, saved synchronously); fsdp_pp_l, FSDP2 with the pipeline (data 1 x pipe 2 on
     the 2 ranks); dpot3d_tp_l, DPOT3D at L's widths (2 blocks, 64^3)
     under TP; cdpot_tp, CDPOT at configs/cdpot_parallel.yaml's widths
     under TP (the fused kernel's route at a rank's channels reported);
     unet_ddp, UNet on 2 DDP ranks with its BatchNorm statistics over the
     ranks and grad_accum 2 (control: each rank's own statistics); and L
     served over pipe = 2 and data = 2 (serve_pp_l, serve_dp_l) against
     one process's answers.
The single-dataset AFNO baseline, after phase 15:
  29. afno_single: `python -m dpot_tpu_torch.cli.sweep --config_file <copy
     of configs/afno_config_single.yaml>` in-process, the copy's data cut
     (its one corpus, ns2d_pdb_M1_eta1e-1_zeta1e-1, stood in for by a
     synthetic set of its grid, channels and length, 96 train and 4 test
     trajectories, one epoch) and every other key the file's: width 512,
     depth 4, 8 AFNO blocks of 64 channels, f32, adam, batch 32. The steps
     exact, launches = depth x (train + eval applications), all on the f32
     pair path, every loss finite, the checkpoint restoring; the first
     train step (AFNO weights redrawn) on the kernel against the plain
     mixer's (loss 1e-5 relative, every gradient 1e-4 relative L2), a
     control with the pairs packed in swapped order above; then cli.evaluate
     --config_from_ckpt --dtype bfloat16 on the checkpoint: launches exact,
     all on the bf16 pair path, and the rollout of the test batch (AFNO
     weights redrawn) within MIXER_TOL["A/bfloat16"] of the plain mixer's,
     faulty plain mixers above it.
DPOT-M at grids other than 128^2, after phase 29:
  30. pretrain_m_grids: `python -m dpot_tpu_torch.cli.sweep --config_file
     <copy of configs/pretrain_medium.yaml>` in-process, the copy's data cut
     as train_L's (twelve synthetic sets, 2 + 2 trajectories, one epoch) and
     its tasks.res [64, 96, 256], so that the sweep makes three jobs (res 96
     a 12^2 latent, whole 64-px tiles of none); every other
     key the file's: DPOT-M, width 1024, depth 12, 8 blocks of 128, bf16,
     lamb, batch 20. In each job the steps exact, launches = depth x (train
     + eval applications), all on the streamed kernel (afno_hopper_stream.cu),
     none on the five-launch one, every loss finite; each job's first train
     step (AFNO weights redrawn) on the kernel against the plain mixer's
     (the loss relative and the worst gradient's relative L2, within
     MIXER_TOL["M/bfloat16"]), with two controls above it: conj_w2 in the
     plain mixer, and the kernel with its last mode chunk left out; at res
     64 and 96 also the f32 step (the f32 Hopper kernel) against the plain
     mixer within AFNO_STEP_TOL.
`python3 chip_smoke.py layouts` builds the kernels and runs phases 27
and 28 alone, printing their rows.
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
float32 matrix products run in full float32 (TF32 off, set below).
Any failure raises, so the script exits non-zero and prints no result. It
needs one CUDA device and exits non-zero without one.
Every process the run starts (nvcc, torchrun, its ranks in their own
sessions, and what those start) inherits RUN_TOKEN in its environment;
before the result lines, and on any failure, the script ends whatever of
them is still alive and reaps its own children (`end_leftovers`), so that
it leaves no process behind; what it had to end is in the `teardown` line.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import io
import json
import math
import os
import re
import shutil
import signal
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
    BF16_WEIGHT_PATHS,
    PATHS,
    fused_gn_afno,
    fused_gn_afno_ref,
    fused_gn_afno_vjp,
    hopper_f32_l_supported,
    hopper_f32_pairs_supported,
    hopper_f32_supported,
    hopper_f32_wide_supported,
    hopper_l_supported,
    hopper_pairs_supported,
    hopper_stream_supported,
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
# a tensor-parallel rank's share of DPOT-L over model = 2 (tp_l, tp_serve_l):
# half the channels, AFNO blocks and norm1 groups
DPOT_L_TP = dict(DPOT_L, C=768, nb=8, groups=4)
# configs/afno_config_single.yaml (width 512, depth 4, 8 blocks, modes 32,
# patch 8 on its dataset's 128^2 grid): AFNO blocks of 64 channels, one
# GroupNorm(8) group each, which the pair paths pack two at a time into the
# kernels for 128-channel blocks (afno_hopper.cu, afno_hopper_f32.cu)
AFNO_SINGLE = dict(H=16, W=16, C=512, nb=8, modes=32, groups=8, depth=4)
# DPOT-M (preset M, configs/pretrain_medium.yaml: embed 1024, 8 AFNO blocks
# of 128, depth 12) at res 64 and 256, patch 8: an 8^2 latent (K 40) and a
# 32^2 latent (K 544), which the streamed bf16 kernel (afno_hopper_stream.cu)
# takes; DPOT-L's blocks at the 32^2 latent too
M_64 = dict(H=8, W=8, C=1024, nb=8, modes=32, groups=8, depth=12)
M_256 = dict(M_64, H=32, W=32)
L_256 = dict(DPOT_L, H=32, W=32)
# ragged latents: DPOT-M at res 96 (12^2, K 84), 72 (9^2, K 45: odd), 160
# (20^2, K 220) and 64 at patch 16 (4^2, K 12), which the streamed kernel
# (bf16) and afno_hopper_f32.cu (f32) take on zero-padded operators; L's and
# H's blocks at 12^2 on their f32 kernels
M_96 = dict(M_64, H=12, W=12)
M_72 = dict(M_64, H=9, W=9)
M_160 = dict(M_64, H=20, W=20)
M_P16 = dict(M_64, H=4, W=4)
L_96 = dict(DPOT_L, H=12, W=12)
H_96 = dict(DPOT_H, H=12, W=12)
RAGGED = {"M96/": M_96, "M72/": M_72, "M160/": M_160, "M4/": M_P16}
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
# and up; the Ti sweep at 41 px kernel 1.1e-3, faults 3.5e-3 and up; the
# served f32 H (phase_serve_h) kernel 2.3e-6, faults 1.5e-2 and up; the
# bf16 evaluation of configs/afno_config_single.yaml (phase_afno_single,
# 11 steps at 128^2, all 144 modes) the pair kernel 2.6e-3 and 3.0e-3, the
# faults 4.6e-2 and up. On that rollout the other bf16 kernels read as
# much: the five-launch kernel forced on 2.6e-3, Ti's model on afno_hopper.cu
# 2.3e-3 (tools/bf16_mixer_readings.py), above the Ti sweep's 2e-3, so that
# configuration has a limit of its own. DPOT-M's first bf16 train step
# (phase_pretrain_m_grids; another reading, see M_CAUGHT) on the stream
# kernel reads 2.4e-3 at res 64 and 1.23e-2 at res 256 (both pos_embed's
# gradient), its controls 6.0e-2 (the dropped chunk at res 256) and up;
# res 96 is held to the same limit
MIXER_SCALE = 0.05
MIXER_TOL = {"L/bfloat16": 1.3e-2, "L/float32": 2e-4, "Ti/bfloat16": 2e-3,
             "H/float32": 2e-4, "A/bfloat16": 1e-2, "M/bfloat16": 3e-2}
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
# the kernel that serves DPOT-H's mixer in each compute type
H_PATH = {"bfloat16": "hopper_wide", "float32": "hopper_f32_wide"}
# the faulty plain mixers the f32 DPOT-H serve check must catch: H's
# GroupNorm groups are its AFNO blocks (8 of 256 channels), so
# "block_groups" computes what the plain mixer computes there
H_F32_CAUGHT = ("conj_w2", "drop_mode")
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
# filtered_lrelu (ops/upfirdn2d.py), bias_act's one caller: x (8, 64, 64,
# 512) up 2 -> lrelu -> down 2 back to 64^2, through a 12-tap separable
# lowpass and a 4x4 (2D) filter, each with the padding that gives 64^2;
# held to the same composition through bias_act_ref at BIAS_ACT_TOL carried
# through the down filter (err <= rtol (|fd| * |mid|) + atol sum|fd|, plus
# in bf16 one rounding of the filtered value, 2^-8 of it); the gradient
# (first order) at FILTERED_LRELU_GRAD_TOL (relative L2). BiasAct's backward
# differentiates bias_act_ref, so the gradient checks the wrapper's plumbing
# (the op stays differentiable, x's and b's gradients routed through both
# filters), not the kernel, which the forward check holds
FILTERED_LRELU_SHAPE = BIAS_ACT_SHAPES[0]
FILTERED_LRELU_FILTERS = {"separable12": (np.hanning(14)[1:-1], (12, 10, 12, 10)),
                          "dense4x4": ([1.0, 3.0, 3.0, 1.0], (3, 2, 3, 2))}
FILTERED_LRELU_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

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
# the environment variable that marks the processes of one run (end_leftovers)
RUN_TOKEN = "DPOT_CHIP_SMOKE_RUN"
# DPOT-L pretraining through the sweep CLI from a copy of
# configs/pretrain_large.yaml with only its data cut: each of the file's
# twelve corpora is stood in for by an in-memory synthetic set with its
# namesake's grid, channels and trajectory and rollout lengths (the port's
# data registry), `ntrain` trajectories to train (ntrain_list) and `ntest`
# to test, for `epochs` epochs; the run's logs go under the smoke's
# directory (log_path). Every other key is the file's: width 1536, depth 24,
# 16 blocks, bf16, lamb, remat, batch 16, noise 5e-4, lr 5e-4, cycle
L_CONFIG = ROOT / "configs" / "pretrain_large.yaml"
# train_l's model (and so dispatch_l's, which trains it on) is cut to 3 of
# L's 24 blocks, CUT_L_DEPTH, to keep the cold smoke within its time with
# the parallel layouts' jobs, the AFNO baseline's phase and DPOT-M's at
# three grids; its widths stay L's
TRAIN_L = dict(epochs=2, ntrain=2, ntest=2, depth=3)
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
# the single-dataset AFNO baseline through the sweep CLI from a copy of
# configs/afno_config_single.yaml with only its data cut as train_L's: its
# one corpus (ns2d_pdb_M1_eta1e-1_zeta1e-1: 128^2, 4 channels, 21 frames)
# stood in for by a synthetic set of that grid, channel count and length,
# `ntrain` trajectories to train and `ntest` to test, one epoch; every other
# key the file's: width 512, depth 4, 8 blocks of 64, f32, adam, batch 32
AFNO_CONFIG = ROOT / "configs" / "afno_config_single.yaml"
AFNO_BATCH = 32
TRAIN_AFNO = dict(epochs=1, ntrain=3 * AFNO_BATCH, ntest=4)
# the kernel that serves its mixer in each compute type
AFNO_PATH = {"bfloat16": "hopper_pairs", "float32": "hopper_f32_pairs"}
# its first train step (f32, batch 32, AFNO weights redrawn from N(0,
# MIXER_SCALE^2) so that the mixer matters) on the pair kernel against the
# same step with the plain mixer: the loss relative and every gradient's
# relative L2; the f32 sums' order differs, as card against CPU for Ti
# (TRAIN_CPU_TOL). A control, the pairs packed in swapped order, must land
# above the limits; DPOT-M's first f32 step at res 64 and 96
# (phase_pretrain_m_grids) is held to the same limits
AFNO_STEP_TOL = dict(loss=1e-5, grad=1e-4)
# the faulty plain mixers its bf16 rollout check must catch: its GroupNorm
# groups are its AFNO blocks (8 of 64 channels), so "block_groups" computes
# what the plain mixer computes there
AFNO_CAUGHT = ("conj_w2", "swap_pairs")
# DPOT-M pretraining (configs/pretrain_medium.yaml: width 1024, depth 12, 8
# blocks of 128, bf16, lamb, batch 20) through the sweep CLI from a copy with
# its data cut as train_L's (twelve synthetic sets of their namesakes' grids,
# `ntrain` + `ntest` trajectories each, one epoch) and its tasks.res the
# three grids [64, 96, 256], so that the sweep makes three jobs; every other
# key the file's, the depth too
M_CONFIG = ROOT / "configs" / "pretrain_medium.yaml"
M_BATCH = 20
TRAIN_M = dict(epochs=1, ntrain=2, ntest=2, res=[64, 96, 256])
# the jobs whose first step is also taken in f32 (afno_hopper_f32.cu: an 8^2
# latent, and a 12^2 one on padded operators)
M_F32_RES = (64, 96)
# the first bf16 step of each job (AFNO weights redrawn from N(0,
# MIXER_SCALE^2)) on the kernel against the same step with the plain mixer:
# the reading is the larger of the loss's relative difference and the worst
# gradient's relative L2, at most MIXER_TOL["M/bfloat16"];
# the controls M_CAUGHT must land above it: the plain mixer with conj_w2,
# and the stream kernel with the modes of its last 32-mode chunk left out
# of o ("drop_chunk": the ragged 8 of K 40 at res 64, 20 of 84 at res 96,
# 32 of 544 at res 256)
M_CAUGHT = ("conj_w2", "drop_chunk")
# remat_L and params_lp_L compare two runs of one model, so they run train_L's
# model cut to its first CUT_L_DEPTH blocks (cut_depth), at L's widths; the
# parallel layouts' jobs at L's widths run LAYOUT_L_DEPTH blocks
CUT_L_DEPTH = 3
LAYOUT_L_DEPTH = 6
# one dispatch (CUDA graphs): graph against eager runs the same kernels on
# the same inputs, so the two are expected to be bitwise equal. Losses are
# held to relative GRAPH_TOL, weights, moments and predictions to relative
# L2 GRAPH_TOL, unless the eager path's own run-to-run spread, measured in
# the same phase and logged, is larger: that spread is then the limit
GRAPH_TOL = 1e-6
# finetune3d_L: DPOT3D at DPOT-L's widths (embed 1536, 16 AFNO blocks of
# 96, groups of 192, mlp_ratio 4, out_layer_dim 128) on a synthetic set of
# ns3d_pdb_M1_turb's grid, channels and lengths (64^3, 5 channels, 21
# frames, t_test 11), 8 train and 4 test trajectories, patch 8 (an 8^3
# latent), T_in 10, modes 32 and temporal_modes 8, bf16, batch 4, 2 epochs,
# inflated from the L .pth that eval_L writes (4 channels, 128^2); its depth
# cut to FT3D_DEPTH of L's 24 blocks (the first 3 inflated) to
# keep the cold smoke within its time with DPOT-M's phase at three grids
FT3D_DEPTH = 3
FT3D_SPEC = dict(name="synthetic_ns3d_l", train_size=8, test_size=4, t_total=21, t_test=11,
                 in_size=(64, 64, 64), n_channels=5)
FT3D = dict(batch=4, epochs=2)
L3D = dict(img_size=64, patch_size=8, in_channels=5, in_timesteps=10, embed_dim=1536,
           n_blocks=16, mlp_ratio=4.0, out_layer_dim=128, modes=32, n_cls=1)
L3D_ARCH = ["--res", "64", "--patch_size", "8", "--width", "1536", "--n_layers", str(FT3D_DEPTH),
            "--n_blocks", "16", "--mlp_ratio", "4", "--out_layer_dim", "128", "--modes", "32",
            "--T_in", "10"]
# the entries the 2D->3D inflation copies from L: 12 a trunk block of the 3D
# model (both norms, the four AFNO tensors, the MLP's two weights and
# biases) and the time aggregator's w and gamma
FT3D_INFLATED = 12 * FT3D_DEPTH + 2
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
# loader_ti: DPOT-Ti pretraining from an on-disk corpus through the native
# host library (dpot_tpu_torch/native, g++ -O3 -march=native, built on the
# card's host). Two sets in the registry's real shapes: ns2d_fno_1e-5's
# (64^2, 20 frames, 1 channel, standard layout; resized to 128^2 and padded
# to 4 channels per item) and ns2d_pdb_M1_eta1e-1_zeta1e-1's (128^2, 21
# frames, 4 channels, time-major: a window is one contiguous copy), "train"
# trajectories each to train and "test" to test, written with the port's
# generation module where h5py imports and as raw f32 files that
# RawF32Reader maps where it does not. Loader rates at configs/
# pretrain_tiny.yaml's batch over "batches" batches after "warmup" ones,
# inline with "workers" threads, each batch copied to the card as the loop
# copies it; then the train CLI (TRAIN_FLAGS, bf16) for "epochs" epochs on
# the mixture and on the time-major set, eagerly and at K steps a dispatch
LOADER_SETS = {
    "loader_fno": dict(in_size=(64, 64), t_total=20, n_channels=1, time_major=False),
    "loader_pdb": dict(in_size=(128, 128), t_total=21, n_channels=4, time_major=True),
}
LOADER = dict(train=64, test=4, batch=TRAIN["batch"], warmup=2, batches=20, epochs=2, K=2,
              workers=4)
# the native resizes against numpy's (tests/test_torch_native.py's limit)
RESIZE_TOL = 1e-5
# ddp_cdpot: configs/cdpot_parallel.yaml (the job the reference ran through
# accelerate on 6 GPUs) at its full widths, its data cut as train_cdpot's,
# for one epoch, through torchrun on 2 ranks that share the one card (gloo
# with CUDA tensors: nccl refuses two ranks on one device), each rank in
# cli.train's main; against the same job in one process: every per-step
# loss and test metric within DDP_TOL relative, the final weights within
# DDP_TOL relative L2 per tensor (cuDNN's deterministic algorithms on every
# side); and the job on one rank through torchrun's default launch (nccl),
# its epoch metrics within DDP_TOL. A rank's profile: PROFILE_STEPS steps
DDP_CDPOT = dict(epochs=1, ntrain=2, ntest=2)
DDP_TOL = 1e-5
PROFILE_STEPS = 5
# fsdp_l: DPOT-L at full width (seeded) with configs/pretrain_large.yaml's
# optimization (bf16, lamb and its clip, remat, noise 5e-4, global batch 16;
# lr a point of the warm-up, as in params_lp_L) and shard_params: fsdp on 2
# ranks for "steps" steps on seeded global batches, against one process's
# eager steps: each loss within "tol" (the bf16 model bar). At every call
# the bf16 blocks that afno_hopper_l.cu read against a fresh conversion of
# the weights FSDP2 gathered, bit for bit, each of them marked uncached;
# then "control" forwards through a cache keyed on the weight tensor alone
# (filled in the last step), stale on purpose, each of which must fail that
# check. Two steps, to keep the cold smoke within its time: every
# layout's controls are forward or first-step readings, which the step
# count does not change
FSDP_L = dict(steps=2, control=1, tol=2e-2, seed=61, lr=PARAMS_LP["lr"])
# tp_l, pp_l, sp_l: fsdp_l's seeded DPOT-L at full width and depth, its
# optimization and its global batches, FSDP_L's steps, in three more layouts
# on the same 2 gloo ranks: shard_params tp over model = 2 (each rank's mixer
# on C = 768, 8 AFNO blocks, 4 groups of 192: afno_hopper_l.cu), mesh_pipe 2
# (12 blocks a stage, "micro" microbatches of 8) and mesh_spatial 2 in f32
# (each rank 8 of the 16 latent rows, the pencil FFT, no kernel). tp_l and
# pp_l against fsdp_l's one process, sp_l against one process on the single-
# device FFT route (norm1, then afno_filter_2d). Each rank is held to one
# process on what it holds, each within LAYOUT_TOL[job]: the losses
# (relative); the first forward's prediction (relative L2; sp_l's rows of it);
# the first step's gradient and the parameter change after the steps, each as
# one relative L2 over the rank's leaves (its TP shards against one process's
# slices, its stage's blocks, the replicated leaves). The loss of seeded
# weights on random targets sits near its ceiling whatever the prediction, so
# the loss alone would pass a wrong layout. Controls, each of which must land
# above its limit: tp_l's forward without fc2's all-reduce (the prediction)
# and its first step's gradient without the all-reduce of the copy's backward;
# pp_l's forward with the permute taking the wrong stage's slot; sp_l's
# forward with the pencil FFT's all-to-alls skipped (the seeded mixer adds
# little to a block's output, so this one moves the prediction least). Each
# limit lies between the largest sound reading on the H100 and the control's
# (prediction / gradient / change: tp_l 7.0e-3 / 7.1e-3 / 1.4e-2, its controls
# 0.46 / 0.50; pp_l 0 / 7.6e-4 / 4.0e-3, its control 0.97; sp_l 2.0e-6 /
# 3.2e-4 / 5.2e-4, its control 7.6e-5; PERF.md §6). tp_serve_l: the L model
# served over model = 2, rank 0 answering a request of each batch of
# "serve_batches" at "serve_steps" steps, within "serve_tol" (relative L2) of
# one process's graphed answers
LAYOUT_L = dict(micro=2, serve_batches=(1, 4), serve_steps=4, serve_tol=3e-2,
                serve_seed=67)
LAYOUT_TOL = {"tp_l": dict(loss=FSDP_L["tol"], pred=2e-2, grad=5e-2, delta=5e-2),
              "pp_l": dict(loss=FSDP_L["tol"], pred=1e-4, grad=5e-3, delta=2e-2),
              "sp_l": dict(loss=1e-4, pred=2e-5, grad=2e-3, delta=3e-3)}
# phase 28's layout jobs, in the same launch after phase 27's, each held to
# one process as those are (a rank's readings, controls above their
# limits). L's widths at LAYOUT_L_DEPTH blocks (bf16, fsdp_l's optimization and
# batches): fsdp_lp_l, tp_lp_l and pp_lp_l with the bf16 working copy under
# FSDP2 (data = 2), TP and the pipeline, against one process's working-copy
# run; fsdp_pp_l, FSDP2 with the pipeline on data 1 x pipe 2 (the 2 ranks
# cannot hold both axes above 1: the composition, not the sharding, which
# the CPU tests hold at data 2 x pipe 2), against one process. fsdp_lp_l
# then writes a checkpoint over gloo (gathered with c10d collectives) and
# one process resumes it: its forward against the ranks' after the steps
# ("resume", relative L2), and one more step's loss against theirs; its
# control, a checkpoint gathered in the wrong shard order, must exceed the
# forward's limit. dpot3d_tp_l: DPOT3D at L's widths (L3D, 2 blocks, 64^3,
# B = 2) under TP; cdpot_tp: CDPOT at configs/cdpot_parallel.yaml's widths
# (f32, B = 20) under TP, the fused kernel's route at a rank's C = 256
# reported; unet_ddp: UNet (width 32, 128^2, f32, B = 8, grad_accum 2) on 2
# DDP ranks, its BatchNorm statistics over them, its running statistics
# held too ("stats"); control: each rank's own statistics. Limits first
# set from a prediction, then between the sound readings and the controls
# of a layouts-only run on the H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# readings / controls, prediction, gradient,
# change: fsdp_lp_l 0 / 2.9e-3 / 4.0e-3, its resume 0 and the wrong-order
# checkpoint 1.09; tp_lp_l 2.9e-3 / 2.1e-3 / 7.1e-3, controls 0.21 /
# 0.26; pp_lp_l 0 / 4.3e-4 / 3.0e-3 and fsdp_pp_l 0 / 3.3e-4 / 3.0e-3,
# controls 0.32; dpot3d_tp_l 1.1e-3 / 1.9e-4 / 3.2e-3, controls 0.029 /
# 0.021; cdpot_tp 3.0e-7 / 1.5e-7 / 6.3e-7, controls 0.29 / 0.79;
# unet_ddp 0 / 3.5e-5 / 1.1e-3, statistics 5.8e-6, control 0.036;
# PERF.md section 6)
MORE_L = dict(cdpot_batch=20, d3_batch=2, unet_batch=8, unet_accum=2)
# job: how it is laid out (cli.train's keys), the model ("L" at the cut
# depth unless named), its compute type, the working copy, its faults,
# the kernel route its launches take (None: reported)
LAYOUT_JOBS = {
    "tp_l": dict(cfg=dict(shard_params="tp", mesh_model=2), faults="tp_l"),
    "pp_l": dict(cfg=dict(mesh_pipe=2, pipe_microbatches=LAYOUT_L["micro"]), faults="pp_l"),
    "sp_l": dict(cfg=dict(mesh_spatial=2), dtype="float32", faults="sp_l", route=None),
    "fsdp_lp_l": dict(cfg=dict(shard_params="fsdp"), depth=LAYOUT_L_DEPTH, lp=True,
                      faults="ckpt"),
    "tp_lp_l": dict(cfg=dict(shard_params="tp", mesh_model=2), depth=LAYOUT_L_DEPTH, lp=True,
                    faults="tp_l"),
    "pp_lp_l": dict(cfg=dict(mesh_pipe=2, pipe_microbatches=LAYOUT_L["micro"]),
                    depth=LAYOUT_L_DEPTH, lp=True, faults="pp_l"),
    "fsdp_pp_l": dict(cfg=dict(shard_params="fsdp", mesh_pipe=2,
                               pipe_microbatches=LAYOUT_L["micro"]),
                      depth=LAYOUT_L_DEPTH, faults="pp_l"),
    "dpot3d_tp_l": dict(cfg=dict(shard_params="tp", mesh_model=2), model="DPOT3D",
                        faults="tp_l", route=None),
    "cdpot_tp": dict(cfg=dict(shard_params="tp", mesh_model=2), model="CDPOT",
                     dtype="float32", faults="tp_l", route=None, remat=False),
    "unet_ddp": dict(cfg=dict(), model="UNet", dtype="float32", faults="bn", route=None,
                     remat=False),
}
LAYOUT_TOL.update({
    "fsdp_lp_l": dict(loss=FSDP_L["tol"], pred=1e-4, grad=5e-2, delta=5e-2, resume=1e-3),
    "tp_lp_l": dict(loss=FSDP_L["tol"], pred=2e-2, grad=5e-2, delta=5e-2),
    "pp_lp_l": dict(loss=FSDP_L["tol"], pred=1e-4, grad=5e-3, delta=2e-2),
    "fsdp_pp_l": dict(loss=FSDP_L["tol"], pred=1e-4, grad=5e-3, delta=2e-2),
    "dpot3d_tp_l": dict(loss=FSDP_L["tol"], pred=1e-2, grad=5e-3, delta=2e-2),
    "cdpot_tp": dict(loss=1e-5, pred=1e-5, grad=1e-4, delta=1e-3),
    "unet_ddp": dict(loss=1e-5, pred=1e-5, grad=1e-3, delta=1e-2, stats=1e-4),
})
# the one-process references of the layout jobs (one_process_steps), by
# (model, compute type, depth, working copy)
LAYOUT_REFS = {"tp_l": RUN_DIR / "ref_l.pt", "sp_l": RUN_DIR / "ref_sp_l.pt"}
LAYOUT_REFS["pp_l"] = LAYOUT_REFS["tp_l"]
LAYOUT_REFS.update({"fsdp_lp_l": RUN_DIR / "ref_lp_l6.pt", "fsdp_pp_l": RUN_DIR / "ref_l6.pt",
                    "dpot3d_tp_l": RUN_DIR / "ref_3d_l.pt", "cdpot_tp": RUN_DIR / "ref_cdpot.pt",
                    "unet_ddp": RUN_DIR / "ref_unet.pt"})
LAYOUT_REFS["tp_lp_l"] = LAYOUT_REFS["pp_lp_l"] = LAYOUT_REFS["fsdp_lp_l"]
# L served over pipe = 2 and data = 2 (tp_serve_l's requests and limit),
# against one process's graphed answers; controls: the pipeline's permute
# taking the wrong slot (serve_pp_l), and on data, where each replica
# computes the batch, a follower that drops the broadcast input: every
# replica's prediction must equal the leader's answer within
# "replica_tol", and the control's must not
SERVE_MESHES = {"serve_pp_l": dict(pipe=2), "serve_dp_l": dict(data=2)}
SERVE_REPLICA_TOL = 1e-6
# a torchrun launch's time limit, and the profiler names of collectives
RANK_TIMEOUT = 600
COLLECTIVE = re.compile(r"gloo|nccl|c10d|all_reduce|allreduce|all_gather|allgather|"
                        r"reduce_scatter|reducescatter|broadcast", re.I)


_START = time.perf_counter()


def log(phase: str, **kv) -> None:
    """One JSON line; t_s: seconds since the script started, so that the
    lines show where the script's time goes."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _START, **kv}), flush=True)


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
# two or three of each Hopper path
GENERAL_KERNELS = ("gn_stats_kernel", "analysis_kernel", "mode_hidden_kernel",
                   "mode_out_kernel", "synthesis_kernel")
HOPPER_KERNELS = ("spectral_kernel", "spectral_wide_kernel", "l_stats_kernel",
                  "spectral_l_kernel", "tma_synthesis_kernel", "stream_stats_kernel",
                  "stream_spectral_kernel", "stream_synthesis_kernel")
HOPPER_F32_KERNELS = ("spectral_f32_kernel", "spectral_f32_l_kernel",
                      "spectral_f32_wide_kernel", "synthesis_f32_kernel")
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


# the kernels whose products are 3xTF32 on the tensor cores (those that read
# the bf16 weight copies: afno_fused.BF16_WEIGHT_PATHS)
TF32_PATHS = ("hopper_f32", "hopper_f32_l", "hopper_f32_wide", "hopper_f32_pairs")


def afno_bound_ms(B: int, dtype: torch.dtype, K: int, path: str,
                  geo: dict = TI) -> tuple[float, str]:
    """Least time for one call on kernel `path` at the block geometry `geo`:
    operations over the peak for the operand type, or bytes (each input
    read once, the output written once) over HBM bandwidth, whichever is
    larger. The bf16 Hopper kernels read the cached bf16 copies of w1 and
    w2, the other kernels the f32 weights. The f32 Hopper kernels do each
    product three times (3xTF32) on the TF32 tensor cores (495 TFLOP/s);
    the general kernel's f32 products run on the FMA pipes (67 TFLOP/s).
    The work is the logical one of blocks of C / nb channels: the pair paths'
    products with the zero blocks of their packed weights are the design's
    own cost, not the function's."""
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


# the entry that the padded-operator control puts in the padded operators:
# 16 against A's entries of 1/sqrt(HW), so that the control moves the
# output well past both bf16 limits through the N(0, 0.05^2) mode MLP
# (rel-L2 0.04 at M's 12^2 latent, B = 8, in the CPU emulation of
# tests/test_torch_afno_ragged.py)
PADDED_CONTROL_ENTRY = 16.0


@contextlib.contextmanager
def padded_with_entry(value: float = PADDED_CONTROL_ENTRY):
    """The kernels read operators padded with a `value` in A's first
    padded pixel column (row 0) and, where K is not a multiple of 4, in
    Ainv's first padded mode column (row 0): a control that shows the
    kernels read the padded entries, so that their zeros are what makes
    the padding exact."""
    real = afno_fused.padded_ops

    def padded(A, Ainv, K):
        Ap, Ainvp = (t.clone() for t in real(A, Ainv, K))
        HW = A.shape[1]
        if Ap.shape[1] > HW:
            Ap[0, HW] = value
        if Ap.shape[0] // 2 > K:
            Ainvp[0, K] = value
        return Ap, Ainvp

    afno_fused.padded_ops = padded
    try:
        yield
    finally:
        afno_fused.padded_ops = real


def check_padded_control(B, dtype, path, geo) -> dict:
    """One call on kernel `path` under `padded_with_entry` against the
    plain version, at N(0, 0.05^2) AFNO weights (the init's scale leaves
    the mode MLP's output near zero, whatever z is): it must miss
    check_afno's limits (either of them)."""
    args, K, groups = afno_case(B, dtype, 0.05, 100 + B, geo)
    approx = dtype == torch.bfloat16
    before = fused_gn_afno.launches_by_path[path]
    with padded_with_entry():
        got = fused_gn_afno(*args, K, groups, approx).float()
    want = fused_gn_afno_ref(*args, K, groups, approx).float()
    torch.cuda.synchronize()
    if fused_gn_afno.launches_by_path[path] != before + 1:
        raise AssertionError(f"padded control {dtype} B={B}: no launch on {path}")
    max_abs = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    tol = TOL[dtype]
    lim = tol.get("max_abs") or tol["max_abs_ulps"] * BF16_EPS * want.abs().max().item()
    if not (max_abs > lim or rel > tol["rel_l2"]):
        raise AssertionError(
            f"padded control {dtype} {path} HW={geo['H'] * geo['W']} K={K}: max_abs {max_abs} "
            f"(limit {lim}), rel_l2 {rel} (limit {tol['rel_l2']}): the kernel does not read "
            "the padded operators")
    return dict(path=path, HW=geo["H"] * geo["W"], K=K, max_abs_err=max_abs, rel_l2=rel,
                max_abs_limit=lim, rel_l2_limit=tol["rel_l2"], caught=True)


@contextlib.contextmanager
def l_dropped_last_chunk():
    """The hopper_l path launches afno_hopper_l.cu's control entry instead
    of the kernel's: the same call with the persistent walk's last mode
    chunk (modes 128-143 of K 144) left out of every block and sample, o's
    rows for them zero, as a walk that missed those tiles would leave
    them."""
    fn = build.load_library("afno_hopper_l").dpot_afno_hopper_l_drop_last_chunk
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    real = afno_fused._kernel_fn
    afno_fused._kernel_fn = lambda path: fn if path == "hopper_l" else real(path)
    try:
        yield
    finally:
        afno_fused._kernel_fn = real


def check_walk_control(B, geo) -> dict:
    """One bf16 call on hopper_l under `l_dropped_last_chunk` against the
    plain version, at N(0, 0.05^2) AFNO weights: it must miss check_afno's
    limits (either of them)."""
    args, K, groups = afno_case(B, torch.bfloat16, 0.05, 100 + B, geo)
    before = fused_gn_afno.launches_by_path["hopper_l"]
    with l_dropped_last_chunk():
        got = fused_gn_afno(*args, K, groups, True).float()
    want = fused_gn_afno_ref(*args, K, groups, True).float()
    torch.cuda.synchronize()
    if fused_gn_afno.launches_by_path["hopper_l"] != before + 1:
        raise AssertionError(f"walk control B={B}: no launch on hopper_l")
    max_abs = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    tol = TOL[torch.bfloat16]
    lim = tol["max_abs_ulps"] * BF16_EPS * want.abs().max().item()
    if not (max_abs > lim or rel > tol["rel_l2"]):
        raise AssertionError(
            f"walk control C={geo['C']} B={B}: max_abs {max_abs} (limit {lim}), rel_l2 {rel} "
            f"(limit {tol['rel_l2']}): the check does not see the walk's last chunk")
    return dict(path="hopper_l", C=geo["C"], K=K, dropped_modes=[(K - 1) // 64 * 64, K - 1],
                max_abs_err=max_abs, rel_l2=rel, max_abs_limit=lim,
                rel_l2_limit=tol["rel_l2"], caught=True)


def check_gate_mirror() -> int:
    """Each Hopper kernel's gate in afno_fused.py (hopper_supported, ...,
    hopper_f32_wide_supported, hopper_stream_supported) against its mirror
    in the CUDA source (dpot_afno_hopper_supported, ...), on the presets
    and on shapes any of them may refuse; and each pair gate (hopper_pairs_supported,
    hopper_f32_pairs_supported) against the source's gate of the kernel it
    launches, asked at the packed shapes (nb/2 blocks of 128), wherever the
    blocks are 64 channels in an even count with groups of at most 64
    channels, and refusing every other shape."""
    gates = []
    for lib, gate, dtype in (("afno_hopper", hopper_supported, torch.bfloat16),
                             ("afno_hopper_wide", hopper_wide_supported, torch.bfloat16),
                             ("afno_hopper_l", hopper_l_supported, torch.bfloat16),
                             ("afno_hopper_f32", hopper_f32_supported, torch.float32),
                             ("afno_hopper_f32_l", hopper_f32_l_supported, torch.float32),
                             ("afno_hopper_f32_wide", hopper_f32_wide_supported,
                              torch.float32),
                             ("afno_hopper_stream", hopper_stream_supported, torch.bfloat16)):
        fn = getattr(build.load_library(lib), f"dpot_{lib}_supported")
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        gates.append((fn, gate, dtype))
    for (fn, _, dtype), gate in zip([gates[0], gates[3]],  # the 128-channel kernels
                                    (hopper_pairs_supported, hopper_f32_pairs_supported)):

        def packed(B, HW, C, K, nb, groups, fn=fn):
            pairs = (nb >= 2 and not nb % 2 and C == 64 * nb and groups >= 1
                     and not C % groups and C // groups <= 64)
            return pairs and fn(B, HW, C, K, nb // 2, groups)

        gates.append((packed, gate, dtype))
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
    # the f32 wide gate's: a TP rank's share of H (C 1024, 4 blocks), latents
    # of 64 and 4096 px and of 96 px, ragged K
    shapes += [(1, 256, 1024, 144, 4, g) for g in (2, 4, 8)]
    shapes += [(2, 64, 2048, 16, 8, 8), (2, 4096, 512, 144, 2, 2), (2, 1024, 1024, 144, 4, 4),
               (2, 96, 2048, 40, 8, 8), (2, 256, 2048, 143, 8, 8), (2, 256, 2048, 2, 8, 8),
               (2, 8192, 2048, 144, 8, 8), (0, 256, 1024, 144, 4, 4)]
    # the pair gates': the config of 64-channel blocks and a TP rank's share
    # of it, an odd block count, groups of 128, 16 and 4 channels, the
    # latents and K each type refuses, the batch's limits
    shapes += [(B, 256, 512, 144, 8, 8) for B in (1, AFNO_BATCH, 65535, 65536, 0)]
    shapes += [(2, 256, 256, 144, 4, g) for g in (2, 4, 8, 16, 64)]
    shapes += [(2, 256, 448, 144, 7, 7), (2, 256, 64, 144, 1, 1), (2, 256, 128, 144, 2, 2),
               (2, 128, 512, 40, 8, 8), (2, 64, 512, 16, 8, 8), (2, 512, 512, 144, 8, 8),
               (2, 4096, 512, 144, 8, 8), (2, 96, 512, 40, 8, 8), (2, 256, 512, 142, 8, 8),
               (2, 256, 512, 143, 8, 8), (2, 256, 512, 160, 8, 8), (2, 256, 512, 164, 8, 8),
               (2, 256, 512, 144, 8, 24), (2, 256, 384, 144, 8, 8)]
    # the stream gate's: DPOT-M, L, H and Ti at 64^2 and 256^2 (patch 8), the
    # block sizes and group layouts it takes, the latents it leaves to the
    # other bf16 kernels, odd K, 160-channel blocks, 144 px, the batch's limits
    shapes += [(B, 64, C, 40, nb, 8) for B in (1, M_BATCH) for C, nb in (
        (1024, 8), (1536, 16), (2048, 8), (512, 4))]
    shapes += [(B, 1024, C, 544, nb, 8) for B in (1, M_BATCH) for C, nb in (
        (1024, 8), (1536, 16), (2048, 8), (512, 4))]
    shapes += [(2, 64, 320, 40, 5, 5), (2, 64, 192, 40, 3, 24), (2, 1024, 768, 544, 8, 4),
               (2, 64, 384, 40, 4, 4), (2, 4096, 256, 144, 2, 8), (2, 512, 512, 144, 4, 8),
               (2, 256, 512, 164, 4, 8), (2, 256, 512, 142, 4, 8), (2, 1024, 128, 2, 1, 1),
               (2, 64, 512, 4, 2, 2), (2, 144, 512, 60, 4, 8), (2, 1024, 1024, 543, 8, 8),
               (2, 1024, 1280, 544, 8, 8), (2, 1024, 1024, 544, 8, 2),
               (2, 1024, 1024, 544, 8, 256), (2, 1024, 480, 544, 5, 5),
               (2, 1024, 384, 544, 4, 1), (2, 8192, 1024, 544, 8, 8), (2, 32, 512, 10, 4, 8),
               (0, 64, 1024, 40, 8, 8), (65535, 64, 1024, 40, 8, 8), (65536, 64, 1024, 40, 8, 8),
               (2, 64, 1024, 40, 16, 8), (2, 64, 1000, 40, 8, 8)]
    # ragged latents and odd K: M, L, H, Ti and the 64-channel blocks at res
    # 96, 72, 80, 160 and 64 at patch 16, a 128-px latent with K odd, the
    # extremes 1 and 4095 px, K 1, and what stays refused (K 0, 4097 px)
    shapes += [(B, HW, C, K, nb, 8) for B in (1, M_BATCH)
               for HW, K in ((144, 84), (81, 45), (100, 60), (400, 220), (16, 12))
               for C, nb in ((1024, 8), (1536, 16), (2048, 8), (512, 4), (512, 8))]
    shapes += [(2, 128, 1024, 45, 8, 8), (2, 256, 512, 45, 8, 8), (2, 1, 256, 1, 2, 8),
               (2, 4095, 256, 144, 2, 8), (2, 4097, 256, 144, 2, 8), (2, 144, 1024, 0, 8, 8),
               (2, 144, 320, 84, 5, 5), (2, 81, 1536, 45, 16, 4), (2, 81, 768, 45, 8, 4),
               (0, 144, 1024, 84, 8, 8), (65536, 81, 1024, 45, 8, 8)]
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
                ("A/", AFNO_SINGLE, torch.bfloat16, ("general", "hopper_pairs")),
                ("A/", AFNO_SINGLE, torch.float32, ("general", "hopper_f32_pairs")),
                ("", TI, torch.float32, ("general", "hopper_f32")),
                ("S/", DPOT_S, torch.bfloat16, ("general", "hopper")),
                ("H/", DPOT_H, torch.bfloat16, ("general", "hopper_wide")),
                ("L/", DPOT_L, torch.bfloat16, ("general", "hopper_l")),
                ("LTP/", DPOT_L_TP, torch.bfloat16, ("general", "hopper_l")),
                ("L/", DPOT_L, torch.float32, ("general", "hopper_f32_l")),
                ("H/", DPOT_H, torch.float32, ("general", "hopper_f32_wide")),
                ("M256/", M_256, torch.bfloat16, ("general", "hopper_stream")),
                ("M64/", M_64, torch.bfloat16, ("general", "hopper_stream")),
                ("L256/", L_256, torch.bfloat16, ("general", "hopper_stream")),
                *((prefix, geo, dtype, ("general", path)) for prefix, geo in RAGGED.items()
                  for dtype, path in ((torch.bfloat16, "hopper_stream"),
                                      (torch.float32, "hopper_f32"))),
                ("L96/", L_96, torch.float32, ("general", "hopper_f32_l")),
                ("H96/", H_96, torch.float32, ("general", "hopper_f32_wide")))
KERNEL_BATCHES = (1, 8, TRAIN["batch"])
# the batches of each case: L in bf16 also at the batch of its pretraining
CASE_BATCHES = {("L/", torch.bfloat16): (1, 8, L_BATCH, TRAIN["batch"]),
                ("LTP/", torch.bfloat16): (1, 4, L_BATCH),
                ("A/", torch.bfloat16): (1, 8, AFNO_BATCH),
                ("A/", torch.float32): (1, 8, AFNO_BATCH),
                ("L256/", torch.bfloat16): (1, 8, L_BATCH),
                ("L96/", torch.float32): (8,), ("H96/", torch.float32): (8,)}


def phase_kernels() -> dict:
    """fused_gn_afno against its plain version on each kernel that serves a
    compute type at the Ti, DPOT-H and DPOT-L shapes and in bf16 at the
    DPOT-S shapes, each beside the five-launch
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
    for prefix in ("M96/", "M72/"):
        for dtype, path in ((torch.bfloat16, "hopper_stream"), (torch.float32, "hopper_f32")):
            key = f"{prefix}{str(dtype).replace('torch.', '')}/padded_control/B8"
            results[key] = check_padded_control(8, dtype, path, RAGGED[prefix])
            log("kernel", name="fused_gn_afno", config=key, **results[key])
    for prefix, geo in (("L/", DPOT_L), ("LTP/", DPOT_L_TP)):  # the L case's walk control
        for B in CASE_BATCHES[(prefix, torch.bfloat16)]:
            key = f"{prefix}bfloat16/walk_control/B{B}"
            results[key] = check_walk_control(B, geo)
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


def bias_act_bound_ms(shape, dtype: torch.dtype, act: str,
                      bias: bool = True) -> tuple[float, str]:
    """Least time for one call: x read and the output written once (and
    the bias's C values, where there is one), or its f32 operations over
    the f32 peak."""
    n, C = math.prod(shape), shape[-1]
    s = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * n + (C if bias else 0)) * s / PEAK_BYTES * 1e3
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
    results["filtered_lrelu"] = check_filtered_lrelu()
    return results


def filtered_lrelu_plain(x, fu, fd, b, pad):
    """filtered_lrelu's composition with bias_act's plain version in the
    middle; also returns that middle (the activation's output)."""
    from dpot_tpu_torch.ops.upfirdn2d import upfirdn2d

    mid = bias_act_ref(upfirdn2d(x + b.reshape(1, 1, 1, -1), fu, up=2, padding=pad, gain=4),
                       None, -1, "lrelu", alpha=0.2, gain=math.sqrt(2))
    return upfirdn2d(mid, fd, down=2), mid


def check_filtered_lrelu() -> dict:
    """filtered_lrelu on the card against its plain composition, f32 and
    bf16, each filter of FILTERED_LRELU_FILTERS: the output (the kernel's
    check), the gradient of x and b (the wrapper's plumbing: both sides'
    backward runs through bias_act_ref), exactly one bias_act launch a call
    (the calls' launches are bias_act's on this path), the times of the
    whole op, the plain composition and the kernel's share, and the
    kernel's bound at the shape it gets here (no bias)."""
    from dpot_tpu_torch.ops.upfirdn2d import filtered_lrelu, setup_filter, upfirdn2d

    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = FILTERED_LRELU_SHAPE
    rows, launches = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        rtol, atol = BIAS_ACT_TOL[dtype]
        x = (2 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
        b = torch.randn(shape[-1], device="cuda", generator=gen).to(dtype)
        for fname, (taps, pad) in FILTERED_LRELU_FILTERS.items():
            f = setup_filter(np.asarray(taps, np.float32), device="cuda")

            def run():
                return filtered_lrelu(x, f, f, b, up=2, down=2, padding=pad)

            calls, before = 0, bias_act.launches
            got = run()
            calls += 1
            want, mid = filtered_lrelu_plain(x, f, f, b, pad)
            bound = upfirdn2d(mid.float().abs(), f.abs(), down=2)
            lim = (rtol + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)) * bound \
                + atol * float(f.abs().sum()) ** (2 if f.dim() == 1 else 1)
            err = (got.float() - want.float()).abs()
            if got.shape != (*shape[:3], shape[3]) or got.dtype != dtype:
                raise AssertionError(f"filtered_lrelu {fname} {dname}: {tuple(got.shape)} "
                                     f"{got.dtype}")
            if not (err <= lim).all():
                raise AssertionError(f"filtered_lrelu {fname} {dname}: max error "
                                     f"{err.max().item()} above its limit")
            g = torch.randn(got.shape, device="cuda", generator=gen).to(dtype)
            xs, bs = x.clone().requires_grad_(), b.clone().requires_grad_()
            grads = torch.autograd.grad(
                filtered_lrelu(xs, f, f, bs, up=2, down=2, padding=pad), [xs, bs], g)
            calls += 1
            plain = torch.autograd.grad(filtered_lrelu_plain(xs, f, f, bs, pad)[0], [xs, bs], g)
            torch.cuda.synchronize()
            if bias_act.launches - before != calls:
                raise AssertionError(f"filtered_lrelu {fname} {dname}: "
                                     f"{bias_act.launches - before} bias_act launches in "
                                     f"{calls} calls, expected one a call")
            launches += calls
            grad_rel = max(rel_l2(a, w) for a, w in zip(grads, plain))
            if not grad_rel <= FILTERED_LRELU_GRAD_TOL[dtype]:
                raise AssertionError(f"filtered_lrelu {fname} {dname}: gradient rel_l2 "
                                     f"{grad_rel}")
            events = [e for e in profile_events(run, 10) if is_kernel(e)]
            total = union_us(events) / 10 / 1e3 if events else None
            bias = (sum(e.time_range.elapsed_us() for e in events
                        if "bias_act_kernel" in e.name) / 10 / 1e3 if events else None)
            row = dict(shape=list(shape), dtype=dname, filter=fname, padding=list(pad),
                       max_abs_err=err.max().item(), limit_min=lim.min().item(),
                       grad_rel_l2=grad_rel, grad_limit=FILTERED_LRELU_GRAD_TOL[dtype],
                       launches=calls, ms=cuda_ms(run, runs=10),
                       plain_ms=cuda_ms(lambda: filtered_lrelu_plain(x, f, f, b, pad), runs=10),
                       device_ms=total if total is not None else "not measured",
                       bias_act_shape=[*mid.shape],
                       bias_act_device_ms=bias if bias is not None else "not measured",
                       bias_act_bound_ms=bias_act_bound_ms(mid.shape, dtype, "lrelu",
                                                           bias=False)[0])
            rows[f"{dname}/{fname}"] = row
            log("filtered_lrelu", **row)
    return dict(rows=rows, launches=launches)


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
    finite values. Returns the requests with their answers and the body's
    type."""
    rng = np.random.default_rng(seed)
    sent = []
    for B in batches:
        for steps in (1, 4):
            x = rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32)
            for kind, body in (("float32", npy(x)), ("bfloat16", bf16_npy(x))):
                pred, ms = post_rollout(port, body, steps)
                if pred.shape != (B, 128, 128, steps, 4):
                    raise AssertionError(f"served shape {pred.shape}")
                if pred.dtype != np.dtype(response_dtype):
                    raise AssertionError(f"served dtype {pred.dtype}")
                if not np.isfinite(pred).all():
                    raise AssertionError("served rollout has non-finite values")
                sent.append(dict(x=x, body=kind, steps=steps, pred=pred, ms=ms))
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
    ("conj_w2"), the last kept mode left out of the synthesis
    ("drop_mode"), or the weights of each block pair (2i, 2i+1) swapped, as
    a wrong packing for the pair paths would swap them ("swap_pairs")."""

    def mix(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups=8, approximate=True,
            act="gelu"):
        if fault == "block_groups":
            groups = w1.shape[1]
        elif fault == "conj_w2":
            w2 = torch.stack([w2[0], -w2[1]])
        elif fault == "swap_pairs":
            w1, w2 = swap_pairs(w1), swap_pairs(w2)
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


def swap_pairs(w: torch.Tensor) -> torch.Tensor:
    """w (2, nb, bs, bs) with blocks 2i and 2i+1 swapped."""
    return torch.stack([w[:, 1::2], w[:, 0::2]], dim=2).flatten(1, 2)


def draw_mixer_weights(model, seed: int) -> None:
    """Every AFNO weight and bias of `model` from N(0, MIXER_SCALE^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            for w in (blk.filter.w1, blk.filter.b1, blk.filter.w2, blk.filter.b2):
                w.copy_(torch.randn(w.shape, generator=g) * MIXER_SCALE)


def mixer_readings(preds, model: str, dtype: str, what: str, caught=None) -> dict:
    """Relative L2 of the predictions `preds()` (B, H, W, T, C) on the
    kernel and with each faulty plain mixer from the plain mixer's, over
    the rollout and per step; the kernel's must be at most
    MIXER_TOL[model/dtype] and each fault of `caught` (by default
    MIXER_CAUGHT[dtype]) above it. The plain runs must launch no kernel."""
    limit = MIXER_TOL[f"{model}/{dtype}"]
    caught = caught or MIXER_CAUGHT[dtype]
    got = preds()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite predictions on the kernel")
    before = fused_gn_afno.launches
    with plain_mixer():
        want = preds()
    runs = {"kernel": got}
    for fault in dict.fromkeys(MIXER_FAULTS + tuple(caught)):
        with plain_mixer(faulty_mixer(fault)):
            runs[fault] = preds()
    check_no_launch(before, f"{what} with the plain mixers")
    norm = functools.partial(torch.linalg.vector_norm, dim=(0, 1, 2, 4))
    readings = {name: dict(rel_l2=rel_l2(p, want), per_step=(
        norm(p.float() - want.float()) / norm(want.float())).tolist())
        for name, p in runs.items()}
    log("mixer_check", what=what, limit=limit, caught=caught, **readings)
    wrong = min(readings[f]["rel_l2"] for f in caught)
    if not readings["kernel"]["rel_l2"] <= limit < wrong:
        raise AssertionError(
            f"{what}: predictions' rel-L2 from the plain mixer's {readings['kernel']['rel_l2']} "
            f"on the kernel, {wrong} at the least with a fault of {caught}: the "
            f"limit {limit} must lie between")
    return {name: r["rel_l2"] for name, r in readings.items()}


def phase_serve_h(dtype: str = "bfloat16") -> tuple[dict, torch.nn.Module]:
    """Serve DPOT-H through the CLI, in bf16 or in f32 (the CLI's default
    compute type: no --dtype flag): every launch on the kernel for AFNO
    blocks of 256 channels of that type (H_PATH), depth x model
    applications of them, and every answer against the same rollout on the
    card in which fused_gn_afno runs its plain version. In bf16 the limit
    is H_SERVE_TOL. In f32 every AFNO weight of the served model is first
    redrawn from N(0, MIXER_SCALE^2), as eval_L's copy is (at the init's
    scale the mixer adds almost nothing to the normed input, and a wrong
    one would pass); the answers must lie within MIXER_TOL["H/float32"]
    and the same rollout of one request with each faulty plain mixer of
    H_F32_CAUGHT above it. Returns the row and the served model, which the
    H step (and, in bf16, train) phases reuse (1.03 B parameters, drawn
    once)."""
    from dpot_tpu_torch.cli.serve import main as serve_main

    path = H_PATH[dtype]
    reset_launch_counts()
    httpd, rs = serve_main(
        H_FLAGS + (["--dtype", dtype] if dtype == "bfloat16" else [])
        + ["--response_dtype", "float32", "--device", "cuda"],
        wait=False,
    )
    try:
        if dtype == "float32":
            # the served graphs read the weights where they lie: redrawn in place
            draw_mixer_weights(rs.model, seed=17)
        sent = send_requests(httpd.server_address[1], (1, 2), "float32", seed=8)
        torch.cuda.synchronize()
        launches, bias_act_launches = fused_gn_afno.launches, bias_act.launches
        applications = warmup_applications(rs) + sum(r["steps"] for r in sent)
        if launches != DPOT_H["depth"] * applications:
            raise AssertionError(
                f"DPOT-H {dtype}: fused_gn_afno launched {launches} times, expected depth x "
                f"applications = {DPOT_H['depth'] * applications}")
        by_path = check_paths(dtype, launches, path)
        wire = torch.bfloat16 if rs.wire_dtype == "bfloat16" else torch.float32
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()

    def rollout(r):
        # the request as the server read it: a bf16 body is x rounded to bf16
        x = r["x"] if r["body"] == "float32" else (
            torch.from_numpy(r["x"]).to(torch.bfloat16).float().numpy())
        return direct_rollout(rs.model, x, r["steps"], wire).cpu()

    before = fused_gn_afno.launches
    with plain_mixer():
        plain = [rollout(r) for r in sent]
    rels = [rel_l2(torch.from_numpy(r["pred"]), p) for r, p in zip(sent, plain)]
    limit = H_SERVE_TOL if dtype == "bfloat16" else MIXER_TOL["H/float32"]
    controls = {}
    if dtype == "float32":
        i = next(i for i, r in enumerate(sent) if r["x"].shape[0] == 2 and r["steps"] == 4)
        for fault in H_F32_CAUGHT:
            with plain_mixer(faulty_mixer(fault)):
                controls[fault] = rel_l2(rollout(sent[i]), plain[i])
    check_no_launch(before, f"DPOT-H {dtype} with the plain mixers")
    if not max(rels) <= limit < min(controls.values(), default=math.inf):
        raise AssertionError(
            f"DPOT-H {dtype} answers against the plain mixer's rollout: rel_l2 {rels}, the "
            f"faulty mixers' {controls}: the limit {limit} must lie between")
    out = dict(dtype=dtype, requests=len(sent), applications=applications,
               launches=launches, launches_by_path=by_path, bias_act_launches=bias_act_launches,
               client_p50_ms=statistics.median(r["ms"] for r in sent),
               client_ms=[r["ms"] for r in sent], plain_mixer_rel_l2=rels,
               plain_mixer_limit=limit, faulty_mixer_rel_l2=controls,
               params_m=rs.n_params / 1e6)
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
        if preset == "Ti" and dtype == "bfloat16" and B == batches[-1]:
            row["trace"] = check_trace(step, "step Ti")
        log("step", **row)
        rows.append(row)
    return rows


def read_metrics(log_dir: str) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    with open(Path(log_dir) / "metrics.jsonl") as f:
        for rec in map(json.loads, f):
            out.setdefault(rec["tag"], []).append(rec["value"])
    return out


@contextlib.contextmanager
def viz_recorded():
    """save_eval_viz's calls in the block (utils/viz.py, which the loop and
    the evaluator call for viz_dir): each call's set and the names of the
    files it returned."""
    from dpot_tpu_torch.utils import viz

    real, calls = viz.save_eval_viz, []

    def record(pred, target, out_dir, dataset, channel=0):
        written = real(pred, target, out_dir, dataset, channel)
        calls.append([dataset, [os.path.basename(p) for p in written]])
        return written

    with patched(viz, "save_eval_viz", record):
        yield calls


def check_viz(calls: list, names: list, volume: bool, what: str) -> dict:
    """One save_eval_viz call per set, in order; where matplotlib imports on
    this host, the JAX package's file names (a 3D set's volume, then the
    rollout's PNG and GIF), else none written ([] returned)."""
    from dpot_tpu_torch.utils.viz import _plt

    have = _plt() is not None
    want = [[n, ([f"{n}_volume.png"] if volume else []) + [f"{n}_rollout.png",
                                                            f"{n}_rollout.gif"]]
            if have else [n, []] for n in names]
    if calls != want:
        raise AssertionError(f"{what} viz_dir: save_eval_viz wrote {calls}, expected {want}")
    return dict(matplotlib=have, written=calls)


@contextlib.contextmanager
def writes_recorded():
    """The checkpoint writes in the block (train/checkpoint.py
    _write_payload): for each, the thread that ran it and its seconds."""
    import threading

    from dpot_tpu_torch.train import checkpoint

    real, writes = checkpoint._write_payload, []

    def timed(*args):
        t0 = time.perf_counter()
        out = real(*args)
        writes.append(dict(thread=threading.current_thread().name,
                           write_s=time.perf_counter() - t0))
        return out

    with patched(checkpoint, "_write_payload", timed):
        yield writes


def same_checkpoint(a: str, b: str) -> int:
    """Two checkpoint files of the same state, tensor for tensor bit-equal
    (weights, moments, count, grad norm, step, generator); returns the
    tensors compared."""
    x, y = (torch.load(p, map_location="cpu", weights_only=False) for p in (a, b))
    pairs = [(f"model.{k}", v, y["model"][k]) for k, v in x["model"].items()]
    pairs += [(f"{m}.{i}", u, v) for m in ("mu", "nu")
              for i, (u, v) in enumerate(zip(x["optimizer"][m], y["optimizer"][m], strict=True))]
    pairs += [("grad_norm", x["optimizer"]["grad_norm"], y["optimizer"]["grad_norm"]),
              ("generator", x["generator"], y["generator"])]
    if list(x["model"]) != list(y["model"]) or x["step"] != y["step"] or \
            x["optimizer"]["count"] != y["optimizer"]["count"]:
        raise AssertionError(f"{a} and {b}: keys, step or count differ")
    for name, u, v in pairs:
        if u.dtype != v.dtype or not torch.equal(u, v):
            raise AssertionError(f"{a} and {b}: {name} differs")
    return len(pairs)


def check_host_snapshot(state, batch, step_fn) -> dict:
    """The loop's rollback snapshots on the card (train/loop.py): a host
    snapshot (pinned, a non_blocking copy) and a device one taken with no
    synchronisation, a train step queued behind them, then each restored
    after a step: both give the state before the steps back, bit for
    bit; and the rule's mode and bytes at these shapes."""
    from dpot_tpu_torch.train import loop

    before = [t.detach().clone() for t in loop._rollback_tensors(state)]
    host, device = loop._host_snapshot(state), loop._snapshot(state)
    restored = {}
    for mode, snap in (("host", host), ("device", device)):
        step_fn(state, batch)
        loop._restore(state, snap)
        restored[mode] = [t.detach().clone() for t in loop._rollback_tensors(state)]
    torch.cuda.synchronize()
    for mode, ts in restored.items():
        if not all(torch.equal(a, b) for a, b in zip(ts, before, strict=True)):
            raise AssertionError(f"a {mode} snapshot restored another state")
    if not all(t.is_pinned() for t in host):
        raise AssertionError("the host snapshot is not pinned")
    return dict(tensors=len(before), bit_equal=True, rule=snapshot_rule(state))


def snapshot_rule(state) -> dict:
    """The rollback snapshots' mode that the loop's rule picks for `state`
    on this card, and the bytes it reckoned (train/loop.py snapshot_mode)."""
    from dpot_tpu_torch.train.loop import snapshot_mode

    mode, per_dev, limit = snapshot_mode(state)
    return dict(mode=mode, state_bytes=per_dev, card_bytes=limit,
                share=2 * per_dev / limit if limit else None)


def check_trace(step, what: str) -> dict:
    """A few calls of `step` inside utils/profiling.py's trace, each under a
    profiled_function range: the Chrome trace's file exists and names that
    range and the bf16 Hopper kernel (afno_hopper.cu's spectral_kernel)."""
    from dpot_tpu_torch.utils.profiling import profiled_function, trace

    def ti_application():
        return step()

    annotated = profiled_function(ti_application)
    with trace(str(RUN_DIR / "trace")) as prof, torch.inference_mode():
        for _ in range(3):
            annotated()
    path = prof.trace_file
    names = {e.get("name") or "" for e in json.load(open(path))["traceEvents"]}
    kernels = sorted(n for n in names if "spectral_kernel" in n)
    if "ti_application" not in names or not kernels:
        raise AssertionError(f"{what}: the trace {path} lacks the range or the kernel")
    return dict(file=os.path.basename(path), bytes=os.path.getsize(path), events=len(names),
                kernels=kernels[:2])


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

    from dpot_tpu_torch.train.checkpoint import save_checkpoint

    make_synthetic_spec(**TRAIN_SPEC)
    argv = TRAIN_FLAGS + ["--dtype", dtype, "--log_path", str(RUN_DIR / f"train_{dtype}")]
    t0 = time.perf_counter()
    reset_launch_counts()
    with writes_recorded() as writes:
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
    # the loop's checkpoints went through the writer's thread; the last one
    # against a synchronous save of the state it holds
    if [w["thread"] for w in writes] != ["checkpoint-writer"] * TRAIN["epochs"]:
        raise AssertionError(f"train checkpoints were written by {writes}")
    sync_path = save_checkpoint(str(RUN_DIR / f"train_{dtype}_sync"), out["state"])
    async_ckpt = dict(writes=writes, tensors=same_checkpoint(
        str(Path(out["log_dir"]) / "model" / "model.pth"), sync_path), bit_equal=True)

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

    snapshots = check_host_snapshot(state, batch, step_fn)
    prof = train_step_profile(state, batch, step_fn)
    row = dict(dtype=dtype, batch=B, steps=steps, train_applications=train_apps,
               eval_applications=eval_apps, launches=launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, run_s=run_s,
               loop_step_s=out["step_seconds"], train_l2_step=out["train_l2_step"],
               test_l2_steps=out["test_l2_steps"], resumed_losses=resumed,
               resume_rel_diff=diff, async_ckpt=async_ckpt, snapshots=snapshots, **prof)
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
               snapshot_rule=snapshot_rule(state),
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


def preset_model(preset: str, dtype: str, seed: int, device: str = "cuda", **kw):
    """A seeded DPOT of a registry preset on the 128^2 grid (patch 8, T_in
    10, 4 channels, one dataset class); kw to build_model (a mesh)."""
    from dpot_tpu_torch.models import build_model

    return build_model("DPOT", preset=preset, img_size=128, patch_size=8, in_channels=4,
                       in_timesteps=10, n_cls=1, dtype=getattr(torch, dtype),
                       device=device, seed=seed, **kw)


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
    if dtype == "bfloat16":
        argv += ["--viz_dir", str(RUN_DIR / "viz_eval_l")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), viz_recorded() as viz_calls:
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
    viz = (check_viz(viz_calls, [name], False, f"eval_L {dtype}") if dtype == "bfloat16"
           else None)
    rule = None
    if dtype == "float32":  # the snapshot rule at L: f32 weights and lamb's moments
        from dpot_tpu_torch.train.optimizers import build_optimizer
        from dpot_tpu_torch.train.state import TrainState

        rule = snapshot_rule(TrainState.create(
            model, build_optimizer("lamb", model.parameters(), 1e-4), seed=0))
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
               bias_act_launches=bias_act_launches, results=vals, viz=viz,
               snapshot_rule=rule,
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
            "--viz_dir", str(RUN_DIR / "viz_finetune_s"), "--device", "cuda"]
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), viz_recorded() as viz_calls:
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
    viz = check_viz(viz_calls, [name], False, "finetune_S")
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
    row = dict(dtype="bfloat16", copied=sorted(out["copied"]), steps=out["state"].step, viz=viz,
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


def sweep_corpora(doc: dict) -> list[str]:
    """The corpora of a sweep file: its top-level train_paths, common to
    every job (pretrain_large.yaml), or the one grid value of train_paths
    under tasks: (afno_config_single.yaml)."""
    if "train_paths" in doc:
        return doc["train_paths"]
    (paths,) = doc["tasks"]["train_paths"]
    return paths


def sweep_file(config: Path, tag: str, cut: dict, run_dir: Path) -> tuple[Path, list]:
    """Write the copy of the sweep file `config` with only its data cut
    (`cut`: ntrain and ntest trajectories of each corpus, epochs; and the
    depth, n_layers, or the grids, res, where `cut` names them) into
    run_dir, its corpora
    (`sweep_corpora`, set where the file sets them) the synthetic sets
    synthetic_{tag}_{corpus} of their namesakes' grids, channels and
    lengths, its logs under run_dir/train_{tag}; returns its path and the
    sets' specs, in the file's order of corpora."""
    import yaml

    from dpot_tpu_torch.data.registry import get_spec, make_synthetic_spec

    doc = yaml.safe_load(config.read_text())
    specs = []
    for name in sweep_corpora(doc):
        real = get_spec(name)
        specs.append(make_synthetic_spec(
            f"synthetic_{tag}_{name}", train_size=cut["ntrain"], test_size=cut["ntest"],
            t_total=real.t_total, t_test=real.t_test, in_size=real.in_size,
            n_channels=real.n_channels))
    names = [spec.name for spec in specs]
    data = dict(train_paths=names, test_paths=names, ntrain_list=[cut["ntrain"]] * len(names))
    if "train_paths" in doc:
        doc.update(data)
    else:  # one grid value under tasks:
        doc["tasks"].update({k: [v] for k, v in data.items()})
    doc["log_path"] = str(run_dir / f"train_{tag.lower()}")
    doc["tasks"]["epochs"] = [cut["epochs"]]
    if "depth" in cut:
        doc["tasks"]["n_layers"] = [cut["depth"]]
    if "res" in cut:
        doc["tasks"]["res"] = list(cut["res"])
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
    want = TRAIN_L["depth"] * (2 * steps + eval_apps)
    if launches != want or len(model.blocks) != TRAIN_L["depth"]:
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
                   n: int, seed: int, res: int | None = None) -> list[dict]:
    """n train batches of the cut corpora that sweep_file registered for
    `config`, as the loop ships them to the card (x in x_dtype, one target
    frame, no mask) at the file's first res or at `res`, each with the
    noise draws of its step."""
    import yaml

    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset

    doc = yaml.safe_load(config.read_text())
    names = [f"synthetic_{tag}_{name}" for name in sweep_corpora(doc)]
    ds = MixedTemporalDataset(names, [cut["ntrain"]] * len(names),
                              res=res or doc["tasks"]["res"][0], t_in=10, t_ar=1,
                              train=True, data_weights=doc.get("data_weights"))
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


@contextlib.contextmanager
def swapped_packing():
    """The pair paths pack each pair of blocks in swapped order: a control
    that the step check must catch."""
    real = afno_fused.pack_pairs
    afno_fused.pack_pairs = lambda w: real(swap_pairs(w))
    try:
        yield
    finally:
        afno_fused.pack_pairs = real


def first_step_runs(base, b: dict, noise_scale: float, path: str, runs: dict) -> dict:
    """One train step of a copy of `base` on batch b under each context of
    `runs` (name -> (context, the launches it must make on kernel `path`)):
    name -> (its loss, its gradients by parameter name)."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    step_fn = make_train_step(noise_scale=noise_scale, ones_mask=True)
    out = {}
    for name, (ctx, want) in runs.items():
        m = copy.deepcopy(base)
        state = TrainState.create(m, build_optimizer("adam", m.parameters(), 0.0), seed=0)
        before = fused_gn_afno.launches_by_path[path]
        with ctx:
            loss = step_fn(state, b)[1]["loss_step"].item()
        launched = fused_gn_afno.launches_by_path[path] - before
        if launched != want:
            raise AssertionError(f"first step {name}: {launched} launches on {path}, "
                                 f"expected {want}")
        out[name] = (loss, {n: p.grad for n, p in m.named_parameters() if p.grad is not None})
        del m, state
    return out


def step_readings(runs: dict, ref: str = "plain") -> dict:
    """Each run of `first_step_runs` but `ref` against `ref`: the loss's
    relative difference, the worst gradient's relative L2 and the relative
    L2 of all gradients together."""
    want_loss, want = runs[ref]
    flat_want = torch.cat([g.float().flatten() for g in want.values()])
    readings = {}
    for name, (loss, grads) in runs.items():
        if name == ref:
            continue
        if grads.keys() != want.keys():
            raise AssertionError(f"first step {name}: gradients of other parameters")
        g = {n: rel_l2(grads[n], want[n]) for n in want}
        worst = max(g, key=g.get)
        flat = torch.cat([grads[n].float().flatten() for n in want])
        readings[name] = dict(loss=loss, loss_rel=abs(loss - want_loss) / abs(want_loss),
                              worst_grad=worst, worst_grad_rel_l2=g[worst],
                              grad_rel_l2=rel_l2(flat, flat_want))
    return readings


def afno_single_step_check(model, job: dict) -> dict:
    """The first train step of configs/afno_config_single.yaml's model (a
    copy of `model`, its AFNO weights redrawn from N(0, MIXER_SCALE^2) so
    that the mixer matters) on a batch of the cut corpus, on the pair
    kernel, with the plain mixer, and with the pairs packed in swapped
    order (the control): the loss relative and the worst gradient's
    relative L2 against the plain mixer's, within AFNO_STEP_TOL on the
    kernel and not within it for the control."""
    base = copy.deepcopy(model)
    draw_mixer_weights(base, seed=7)
    (b,) = corpus_batches(AFNO_CONFIG, "A", TRAIN_AFNO, job["batch_size"], torch.float32, 1,
                          seed=3)
    depth = job["n_layers"]
    runs = first_step_runs(base, b, job["noise_scale"], "hopper_f32_pairs", {
        "kernel": (contextlib.nullcontext(), depth), "plain": (plain_mixer(), 0),
        "swapped_pairs": (swapped_packing(), depth)})
    readings = step_readings(runs)
    tol = AFNO_STEP_TOL

    def within(r):
        return r["loss_rel"] <= tol["loss"] and r["worst_grad_rel_l2"] <= tol["grad"]

    if not within(readings["kernel"]) or within(readings["swapped_pairs"]):
        raise AssertionError(f"afno_single first step against the plain mixer: {readings} "
                             f"(limits {tol}): the kernel must be within, the control not")
    return dict(plain_loss=runs["plain"][0], limits=tol, n_grads=len(runs["plain"][1]),
                **readings)


def phase_afno_single() -> tuple[dict, dict]:
    """configs/afno_config_single.yaml (AFNO blocks of 64 channels) on the
    pair paths. Pretrained through the sweep CLI (in-process) from a copy
    with only its data cut (`sweep_file`): f32 (the file sets no dtype),
    adam, batch 32, width 512, depth 4, 8 blocks; the steps and launches
    exact (depth x (train + eval applications), all on hopper_f32_pairs),
    every loss finite, the checkpoint restoring to the state's weights; the
    first step against the plain mixer's (`afno_single_step_check`). Then
    the run's checkpoint through cli.evaluate --config_from_ckpt --dtype
    bfloat16: launches exact, all on hopper_pairs, every number finite; and
    the evaluation's rollout of the test batch, its AFNO weights redrawn,
    against the plain mixer's on the card within MIXER_TOL["A/bfloat16"],
    with faulty plain mixers (AFNO_CAUGHT) above it. Returns the f32 and
    the bf16 rows."""
    import yaml

    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.cli.sweep import main as sweep_main
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.checkpoint import restore_params
    from dpot_tpu_torch.train.step import make_eval_rollout
    from dpot_tpu_torch.utils.config import expand_tasks

    cfg_path, specs = sweep_file(AFNO_CONFIG, "A", TRAIN_AFNO, RUN_DIR)
    (job,) = expand_tasks(yaml.safe_load(cfg_path.read_text()))
    batch, depth = job["batch_size"], job["n_layers"]
    if (job["model"], job["opt"], job.get("dtype", "float32"), batch, job["width"], depth,
            job["n_blocks"]) != ("AFNO", "adam", "float32", AFNO_BATCH, AFNO_SINGLE["C"],
                                 AFNO_SINGLE["depth"], AFNO_SINGLE["nb"]):
        raise AssertionError(f"{AFNO_CONFIG.name} no longer trains the model this phase "
                             "expects")
    names = [sp.name for sp in specs]
    steps, eval_apps = sweep_applications(specs, [1] * len(specs), batch, TRAIN_AFNO["epochs"])
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        (out,) = sweep_main(["--config_file", str(cfg_path), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    bias_act_launches = bias_act.launches
    state, model = out["state"], out["model"]
    if state.step != steps or tuple(model.blocks[0].filter.w1.shape) != (2, 8, 64, 64):
        raise AssertionError(f"afno_single: {state.step} steps, expected {steps}; w1 "
                             f"{tuple(model.blocks[0].filter.w1.shape)}")
    if launches != depth * (steps + eval_apps):
        raise AssertionError(f"afno_single: fused_gn_afno launched {launches} times, expected "
                             f"depth x (train + eval applications) = "
                             f"{depth * (steps + eval_apps)}")
    by_path = check_paths("float32", launches, AFNO_PATH["float32"])
    metrics = read_metrics(out["log_dir"])
    losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
    losses += [out["train_l2_step"], out["train_l2_full"], *out["test_l2_steps"],
               *out["test_l2_fulls"]]
    if len(metrics.get("train_loss_step", [])) != steps or not finite(losses):
        raise AssertionError(f"afno_single losses missing or not finite: {metrics}")
    ckpt = str(Path(out["log_dir"]) / "model")
    saved, mine = restore_params(ckpt), state.params_state_dict()
    if saved.keys() != mine.keys() or not all(torch.equal(saved[k], mine[k].cpu())
                                               for k in saved):
        raise AssertionError("afno_single: the checkpoint does not restore to the state's "
                             "weights")
    step = afno_single_step_check(model, job)
    row = dict(dtype="float32", batch=batch, steps=steps, train_applications=steps,
               eval_applications=eval_apps, launches=launches, launches_by_path=by_path,
               bias_act_launches=bias_act_launches, run_s=run_s,
               loop_step_s=out["step_seconds"], train_l2_step=out["train_l2_step"],
               test_l2_fulls=out["test_l2_fulls"], first_step=step,
               params_m=sum(p.numel() for p in model.parameters()) / 1e6,
               corpora={sp.name: dict(channels=sp.n_channels, in_size=sp.in_size,
                                      t_total=sp.t_total, t_test=sp.t_test) for sp in specs})
    log("train_afno_single", **row)
    del out, state, model, saved, mine

    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path", ckpt,
                             "--test_paths", *names, "--batch_size", str(batch),
                             "--dtype", "bfloat16", "--num_workers", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    eval_launches = fused_gn_afno.launches
    bf16_apps = eval_apps // TRAIN_AFNO["epochs"]
    if eval_launches != depth * bf16_apps:
        raise AssertionError(f"afno_single evaluate bf16: {eval_launches} launches, expected "
                             f"{depth * bf16_apps}")
    eval_by_path = check_paths("bfloat16", eval_launches, AFNO_PATH["bfloat16"])
    if not finite(v for n in names for v in got[n].values()):
        raise AssertionError(f"afno_single evaluate bf16: {got}")
    eval_bias_act = bias_act.launches

    bf16 = build_model(job["model"], img_size=job["res"], patch_size=job["patch_size"],
                       in_channels=specs[0].n_channels, in_timesteps=10,
                       embed_dim=job["width"], modes=job["modes"], depth=depth,
                       n_blocks=job["n_blocks"], mlp_ratio=job["mlp_ratio"], act=job["act"],
                       n_cls=len(names), dtype=torch.bfloat16, device="cuda", seed=0)
    bf16.load_state_dict(restore_params(ckpt), strict=True)
    draw_mixer_weights(bf16, seed=8)
    ds = MixedTemporalDataset(names, res=job["res"], t_in=10, t_ar=-1,
                              n_channels=specs[0].n_channels, train=False)
    x, y, msk, _ = next(iter(DataLoader(ds, batch, shuffle=False, num_workers=0)))
    b = {k: torch.from_numpy(v).to("cuda") for k, v in (("x", x), ("y", y), ("msk", msk))}

    def graphed_preds() -> torch.Tensor:
        # a fresh rollout each time, as eval_L's: eager, then captured and
        # replayed under the mixer in force
        roll = make_eval_rollout()
        roll(bf16, b)
        return roll(bf16, b)["pred"]

    rels = mixer_readings(graphed_preds, "A", "bfloat16", "afno_single evaluate bf16",
                          caught=AFNO_CAUGHT)
    eval_row = dict(dtype="bfloat16", batch=batch, applications=bf16_apps,
                    launches=eval_launches, launches_by_path=eval_by_path,
                    bias_act_launches=eval_bias_act,
                    results={n: got[n] for n in names}, avg_step_time_s=got["avg_step_time"],
                    plain_mixer_rel_l2=rels, plain_mixer_limit=MIXER_TOL["A/bfloat16"],
                    caught=AFNO_CAUGHT)
    log("eval_afno_single", **eval_row)
    del bf16, b
    torch.cuda.empty_cache()
    return row, eval_row


@contextlib.contextmanager
def dropped_last_chunk():
    """The stream path launches afno_hopper_stream.cu's control entry
    instead of the kernel's: the same call with the modes of the last
    32-mode chunk left out of o (their rows zero), a fault in the chunk
    arithmetic that the step check must catch."""
    fn = build.load_library("afno_hopper_stream").dpot_afno_hopper_stream_drop_last_chunk
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    real = afno_fused._kernel_fn
    afno_fused._kernel_fn = lambda path: fn if path == "hopper_stream" else real(path)
    try:
        yield
    finally:
        afno_fused._kernel_fn = real


def m_step_check(model, job: dict) -> dict:
    """The first train step of a DPOT-M job of pretrain_m_grids (a copy of
    its trained `model`, AFNO weights redrawn from N(0, MIXER_SCALE^2)) on a
    batch of its cut corpora at its res: bf16 on the stream kernel, with the
    plain mixer and with the controls of M_CAUGHT; each run's reading (the
    larger of the loss's relative difference and the worst gradient's
    relative L2 against the plain mixer's) within MIXER_TOL["M/bfloat16"] on
    the kernel and above it for every control. At the res of M_F32_RES also
    the step in f32 (the f32 Hopper kernel) against the plain mixer within
    AFNO_STEP_TOL, its launches kept as the row's f32 launches by path."""
    from dpot_tpu_torch.cli.sweep import job_to_argv
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.utils.config import load_config

    res, depth, noise = job["res"], job["n_layers"], job["noise_scale"]
    base = copy.deepcopy(model)
    draw_mixer_weights(base, seed=9)
    (b,) = corpus_batches(M_CONFIG, "M", TRAIN_M, M_BATCH, torch.bfloat16, 1, seed=3, res=res)
    runs = first_step_runs(base, b, noise, "hopper_stream", {
        "kernel": (contextlib.nullcontext(), depth), "plain": (plain_mixer(), 0),
        "conj_w2": (plain_mixer(faulty_mixer("conj_w2")), 0),
        "drop_chunk": (dropped_last_chunk(), depth)})
    readings = step_readings(runs)
    for r in readings.values():
        r["reading"] = max(r["loss_rel"], r["worst_grad_rel_l2"])
    limit = MIXER_TOL["M/bfloat16"]
    log("mixer_check", what=f"pretrain_m_grids res {res}: the first bf16 step", limit=limit,
        caught=M_CAUGHT, **readings)
    wrong = min(readings[f]["reading"] for f in M_CAUGHT)
    if not readings["kernel"]["reading"] <= limit < wrong:
        raise AssertionError(
            f"pretrain_m_grids res {res}: the first bf16 step reads "
            f"{readings['kernel']['reading']} on the kernel, {wrong} at the least with a "
            f"control of {M_CAUGHT}: the limit {limit} must lie between")
    out = dict(plain_loss=runs["plain"][0], limit=limit, bf16=readings)
    del runs, b
    if res not in M_F32_RES:
        return out
    # the same step in f32, on the f32 Hopper kernel
    cfg = load_config(job_to_argv(job))
    f32 = build_model(
        cfg.model, img_size=res, patch_size=cfg.patch_size, in_channels=model.in_channels,
        in_timesteps=cfg.T_in, out_timesteps=cfg.T_bundle, embed_dim=cfg.width,
        modes=cfg.modes, depth=cfg.n_layers, n_blocks=cfg.n_blocks, mlp_ratio=cfg.mlp_ratio,
        out_layer_dim=cfg.out_layer_dim, act=cfg.act, n_cls=len(cfg.train_paths),
        normalize=cfg.normalize, use_ln=cfg.use_ln, dtype=torch.float32, device="cuda", seed=0)
    f32.load_state_dict(base.state_dict(), strict=True)
    (b,) = corpus_batches(M_CONFIG, "M", TRAIN_M, M_BATCH, torch.float32, 1, seed=3, res=res)
    before = dict(fused_gn_afno.launches_by_path)
    runs = first_step_runs(f32, b, noise, "hopper_f32", {
        "kernel": (contextlib.nullcontext(), depth), "plain": (plain_mixer(), 0)})
    launched = {p: n - before[p] for p, n in fused_gn_afno.launches_by_path.items()}
    if launched["hopper_f32"] != depth or sum(launched.values()) != depth:
        raise AssertionError(f"pretrain_m_grids res {res}: the f32 steps launched {launched}, "
                             f"expected {depth} on hopper_f32")
    r32 = step_readings(runs)["kernel"]
    tol = AFNO_STEP_TOL
    if not (r32["loss_rel"] <= tol["loss"] and r32["worst_grad_rel_l2"] <= tol["grad"]):
        raise AssertionError(f"pretrain_m_grids res {res}: the first f32 step against the "
                             f"plain mixer {r32} (limits {tol})")
    out["f32"] = dict(plain_loss=runs["plain"][0], limits=tol, launches_by_path=launched, **r32)
    return out


def phase_pretrain_m_grids() -> dict:
    """configs/pretrain_medium.yaml (DPOT-M: width 1024, depth 12, 8 blocks
    of 128, bf16, lamb, batch 20) at res 64, 96 and 256 on the stream
    kernel. Pretrained through the sweep CLI (in-process) from a copy with
    its data cut and its tasks.res [64, 96, 256] (`sweep_file`, TRAIN_M),
    three jobs: in
    each the steps exact and the launches exact (depth x (train + eval
    applications), every one on hopper_stream, none on general), every loss
    finite; then each job's first step against the plain mixer
    (`m_step_check`). Returns the row."""
    import yaml

    import dpot_tpu_torch.cli.train as train_cli
    from dpot_tpu_torch.cli.sweep import main as sweep_main
    from dpot_tpu_torch.utils.config import expand_tasks

    cfg_path, specs = sweep_file(M_CONFIG, "M", TRAIN_M, RUN_DIR)
    doc = yaml.safe_load(cfg_path.read_text())
    jobs = expand_tasks(doc)
    depth = M_64["depth"]
    if ([j["res"] for j in jobs] != TRAIN_M["res"] or (doc["opt"], doc["dtype"]) != (
            "lamb", "bfloat16") or any(
            (j["batch_size"], j["width"], j["n_layers"], j["n_blocks"], j["patch_size"])
            != (M_BATCH, M_64["C"], depth, M_64["nb"], 8) for j in jobs)):
        raise AssertionError(f"{M_CONFIG.name} no longer pretrains M as this phase expects")
    steps, eval_apps = sweep_applications(specs, doc["data_weights"], M_BATCH,
                                          TRAIN_M["epochs"])
    per_job = []
    real_main = train_cli.main

    def counted(argv):
        # each job's own launches and wall, read around its run
        before = dict(fused_gn_afno.launches_by_path)
        t0 = time.perf_counter()
        out = real_main(argv)
        torch.cuda.synchronize()
        per_job.append(dict(run_s=time.perf_counter() - t0, launches_by_path={
            p: n - before[p] for p, n in fused_gn_afno.launches_by_path.items()}))
        return out

    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(train_cli, "main", counted), contextlib.redirect_stdout(io.StringIO()):
        outs = sweep_main(["--config_file", str(cfg_path), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, run_s = fused_gn_afno.launches, time.perf_counter() - t0
    want = depth * (steps + eval_apps)
    if launches != len(jobs) * want:
        raise AssertionError(f"pretrain_m_grids: fused_gn_afno launched {launches} times, "
                             f"expected jobs x depth x (train + eval applications) = "
                             f"{len(jobs) * want}")
    by_path = check_paths("bfloat16", launches, "hopper_stream")
    bias_act_launches = bias_act.launches
    rows = {}
    for job, out, counts in zip(jobs, outs, per_job):
        res = job["res"]
        state, model = out["state"], out["model"]
        mine = counts["launches_by_path"]
        if state.step != steps or len(model.blocks) != depth or model.img_size != res:
            raise AssertionError(f"pretrain_m_grids res {res}: {state.step} steps, "
                                 f"{len(model.blocks)} blocks, img {model.img_size}")
        if mine["hopper_stream"] != want or sum(mine.values()) != want:
            raise AssertionError(f"pretrain_m_grids res {res}: launches by path {mine}, "
                                 f"expected all {want} on hopper_stream")
        metrics = read_metrics(out["log_dir"])
        losses = [v for k, vs in metrics.items() if "loss" in k for v in vs]
        losses += [out["train_l2_step"], out["train_l2_full"], *out["test_l2_steps"],
                   *out["test_l2_fulls"]]
        if len(metrics.get("train_loss_step", [])) != steps or not finite(losses):
            raise AssertionError(f"pretrain_m_grids res {res} losses missing or not finite: "
                                 f"{metrics}")
        rows[f"res{res}"] = dict(
            latent=res // 8, K=(res // 8) * (res // 16 + 1), run_s=counts["run_s"],
            launches_by_path=mine, loop_step_s=out["step_seconds"],
            train_l2_step=out["train_l2_step"], test_l2_fulls=out["test_l2_fulls"],
            first_step=m_step_check(model, job))
        del out, state, model
        torch.cuda.empty_cache()
    f32_steps = {p: sum(r["first_step"].get("f32", {}).get("launches_by_path", {}).get(p, 0)
                        for r in rows.values()) for p in PATHS}
    row = dict(dtype="bfloat16", batch=M_BATCH, depth=depth, steps=steps,
               train_applications=steps, eval_applications=eval_apps, launches=launches,
               launches_by_path=by_path, bias_act_launches=bias_act_launches, run_s=run_s,
               f32_first_steps=dict(res=list(M_F32_RES), launches_by_path=f32_steps),
               corpora={s.name: dict(channels=s.n_channels, in_size=s.in_size,
                                     t_total=s.t_total, t_test=s.t_test) for s in specs},
               **rows)
    log("pretrain_m_grids", **row)
    del outs
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def cut_depth(model, depth: int):
    """The model with only its first `depth` trunk blocks, put back after."""
    full = model.blocks
    model.blocks = full[:depth]
    try:
        yield model
    finally:
        model.blocks = full


def phase_remat_l(model) -> dict:
    """One bf16 step of the trained DPOT-L, cut to CUT_L_DEPTH blocks, at
    batch 16 with remat and without, from the same weights (lr 0 keeps
    them), batch (of the cut corpora) and noise: the losses within
    REMAT_TOL["loss"] and every gradient within REMAT_TOL["grad"] relative
    L2 (expected identical); where each way's step time goes, as for Ti,
    with its peak memory, and its launches: depth x (2 or 1) a step. The
    gradients are compared on the host, so that no copy of them weighs on
    the card's peak."""
    from dpot_tpu_torch.train.step import make_train_step

    (batch,) = l_corpus_batches(1, seed=31)
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    with cut_depth(model, CUT_L_DEPTH):
        row = remat_runs(model, batch, step_fn)
    log("remat_l", **row)
    model.remat = True
    return row


def remat_runs(model, batch, step_fn) -> dict:
    """phase_remat_l's two runs and their comparison."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState

    runs, row = {}, {}
    for remat in (False, True):
        model.remat = remat
        state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 0.0), 0)
        reset_launch_counts()
        loss = step_fn(state, batch)[1]["loss_step"].item()
        per_step = CUT_L_DEPTH * (2 if remat else 1)
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
    row.update(batch=L_BATCH, depth=CUT_L_DEPTH, loss_rel=loss_rel, worst_grad=worst,
               worst_grad_rel_l2=rels[worst], grads=len(rels),
               grads_bitwise_equal=len(identical), limits=REMAT_TOL,
               launches_by_path={p: sum(row[k]["launches_by_path"][p]
                                        for k in ("remat_false", "remat_true"))
                                 for p in afno_fused.PATHS})
    return row


def phase_params_lp_l(model) -> dict:
    """Five bf16 lamb steps of DPOT-L, cut to CUT_L_DEPTH blocks, at batch
    16 (remat on, as the file says) from the same weights, batches (of the cut corpora) and noise
    with the bf16 working copy of the parameters and without: each loss
    within PARAMS_LP's 5 %, after every step the copy exactly the master
    cast to bf16, every launch on afno_hopper_l.cu; then where a step's
    time goes each way, with the dense layers' f32->bf16 weight copies.
    The model's weights are left as the working copy's bf16."""
    batches = l_corpus_batches(PARAMS_LP["steps"], seed=40)
    with cut_depth(model, CUT_L_DEPTH):
        row = params_lp_runs(model, batches)
    log("params_lp_l", **row)
    return row


def params_lp_runs(model, batches) -> dict:
    """phase_params_lp_l's two runs and their comparison."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step

    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    row: dict = dict(batch=L_BATCH, depth=CUT_L_DEPTH, steps=PARAMS_LP["steps"],
                     limit=PARAMS_LP["loss_rel"])
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
        if launches != 2 * CUT_L_DEPTH * PARAMS_LP["steps"]:
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


def check_loop_host_rollback(flags: list[str]) -> dict:
    """The loop's own rollback with host snapshots, on the card: the Ti
    dispatch run at K = DISPATCH_K with a snapshot after every dispatch and
    the first K-step dispatch's second loss read back as NaN, once with
    DPOT_SNAPSHOT_MODE=host and once =device. The host snapshot the loop
    restores is a pinned non_blocking copy with the next K-step graph's
    in-place update queued behind it: the restore gives back the state of
    the snapshot's time (a device clone queued beside it), bit for bit, and
    the two runs end in the same state, bit for bit."""
    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.train import loop

    real_rows, real_host, real_restore = loop._fetch_rows, loop._host_snapshot, loop._restore
    finals, result = {}, {}
    for mode in ("host", "device"):
        calls, latest, restores = {"n": 0}, [], []

        def nan_rows(*ts):
            calls["n"] += 1
            rows = real_rows(*ts)
            if calls["n"] == 1:
                rows[0][1] = float("nan")
            return rows

        def host_snapshot(state):
            snap = real_host(state)
            latest[:] = [(snap, [t.detach().clone() for t in loop._rollback_tensors(state)])]
            return snap

        def restore(state, snap):
            real_restore(state, snap)
            if mode == "host":
                held, ref = latest[0]
                torch.cuda.synchronize()
                restores.append(held is snap and all(
                    torch.equal(a, b)
                    for a, b in zip(loop._rollback_tensors(state), ref, strict=True)))
            else:
                restores.append(True)

        argv = flags + ["--dtype", "bfloat16", "--steps_per_dispatch", str(DISPATCH_K),
                        "--rollback_snapshot_steps", "1", "--log_path",
                        str(RUN_DIR / f"dispatch_rollback_{mode}"), "--device", "cuda"]
        old = os.environ.get("DPOT_SNAPSHOT_MODE")
        os.environ["DPOT_SNAPSHOT_MODE"] = mode
        reset_launch_counts()
        try:
            with patched(loop, "_fetch_rows", nan_rows), \
                    patched(loop, "_host_snapshot", host_snapshot), \
                    patched(loop, "_restore", restore), \
                    contextlib.redirect_stdout(io.StringIO()):
                out = train_main(argv)
        finally:
            if old is None:
                os.environ.pop("DPOT_SNAPSHOT_MODE")
            else:
                os.environ["DPOT_SNAPSHOT_MODE"] = old
        torch.cuda.synchronize()
        logs = (Path(out["log_dir"]) / "logs.txt").read_text()
        if f"rollback snapshots on {mode.upper()}" not in logs or restores != [True] \
                or logs.count("restoring previous good state") != 1:
            raise AssertionError(f"dispatch_ti rollback {mode}: restores {restores}; the log "
                                 "lacks the mode or one rollback")
        finals[mode] = [t.detach().clone() for t in loop._rollback_tensors(out["state"])]
        result[mode] = dict(restores=len(restores), fetches=calls["n"],
                            dispatch_units=out["dispatch_steps"],
                            bias_act_launches=bias_act.launches)
    if not all(torch.equal(a, b) for a, b in zip(finals["host"], finals["device"], strict=True)):
        raise AssertionError("dispatch_ti rollback: host mode ends in another state than "
                             "device mode")
    return dict(result, tensors=len(finals["host"]), restored_bit_equal=True,
                final_bit_equal=True)


def phase_dispatch_ti() -> dict:
    """DPOT-Ti pretrained through the train CLI at 4 steps a dispatch (one
    CUDA graph of 4 steps, tails as single eager steps) against the same
    run at 1 step a dispatch, twice (the eager path's own spread), from the
    same seed: every per-step loss, the optimizer steps and dispatch units
    and the launches exact; the loop's rollback from host snapshots against
    device ones (check_loop_host_rollback); then where a step's time goes
    at K = 1 and at K = 4 on the run's state and one loader batch of 4 x 20
    samples."""
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

    rollback = check_loop_host_rollback(flags)

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
               bias_act_launches=sum(r["bias_act_launches"] for r in (
                   *runs.values(), rollback["host"], rollback["device"])),
               loss_rel_diff=dev, test_loss_rel_diff=test_dev, eager_spread=spread,
               limit=limit, runs=runs, loop_host_rollback=rollback, profile_k1=eager,
               profile_k4=graphed)
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
    if launches != 4 * K * 2 * len(model.blocks):
        raise AssertionError(f"dispatch_l: {launches} launches, expected "
                             f"{4 * K * 2 * len(model.blocks)}")
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

    with contextlib.redirect_stdout(io.StringIO()), viz_recorded() as viz_calls:
        got = evaluate_main(["--config_from_ckpt", "true", "--resume_path", str(log_path),
                             "--test_paths", name, "--batch_size", str(FT3D["batch"]),
                             "--dtype", "bfloat16", "--num_workers", "8", "--metrics",
                             "--viz_dir", str(RUN_DIR / "viz_finetune3d_l"),
                             "--device", "cuda"])
    torch.cuda.synchronize()
    check_no_launch(0, "finetune3d_L's evaluation")
    viz = check_viz(viz_calls, [name], True, "finetune3d_L's evaluation")
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
               evaluate=vals, evaluate_rel=rel, evaluate_limit=FT_EVAL_TOL, viz=viz,
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


@contextlib.contextmanager
def plain_host():
    """The host library's plain numpy versions (DPOT_DISABLE_NATIVE=1)."""
    old = os.environ.get("DPOT_DISABLE_NATIVE")
    os.environ["DPOT_DISABLE_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DPOT_DISABLE_NATIVE"]
        else:
            os.environ["DPOT_DISABLE_NATIVE"] = old


def special_field(n: int, seed: int) -> np.ndarray:
    """Random f32 over a wide range of exponents, with +-0, +-inf, NaNs
    (quiet, signalling, with payloads), subnormals and rounding ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))).astype(np.float32)
    u = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
                  0x7F800001, 0x7FA00000, 0x00000001, 0x807FFFFF, 0x00400000, 0x7F7FFFFF,
                  0x3F808000, 0x3F818000, 0x3F807FFF], np.uint32)
    x.view(np.uint32)[rng.choice(n, size=len(u), replace=False)] = u
    return x


def host_ms(fn, runs: int = 5) -> float:
    """Median host ms of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def native_build_info(seconds: float) -> dict:
    """The host library's build: g++'s version, the host CPU and the key."""
    from dpot_tpu_torch.native import build as native_build

    gxx = subprocess.run([native_build.CXX, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    return dict(seconds=seconds, gxx=gxx, digest=native_build.digest(),
                library=native_build.library_path().name,
                cpu=native_build.cpu_identity().split("|")[0], cpu_count=os.cpu_count(),
                threads_per_call=torch.get_num_threads(),
                flags=" ".join(native_build.GXX_FLAGS))


def check_native_host() -> dict:
    """Each function of the host library against its plain version on this
    host, at the shapes of the Ti mixture: the resizes within RESIZE_TOL,
    the batch assembly (f32 and bf16 slots) bit for bit over fields with
    specials in them, and a bf16 plain version that truncates (wrong on
    purpose) disagreeing with the library."""
    from dpot_tpu_torch.native import preprocess as pre

    rng = np.random.default_rng(17)
    out: dict = {}
    # (call, input shape, whether the call reaches the library): at 128^2 in
    # and out pad_data_2d pads in numpy on both paths, so that case times
    # nothing
    cases = {
        "pad_data_2d[64^2x1->128^2x4]": (
            lambda x: pre.pad_data_2d(x, 128, 4), (64, 64, 11, 1), True),
        "pad_data_2d[96^2x3->128^2x4]": (
            lambda x: pre.pad_data_2d(x, 128, 4), (96, 96, 11, 3), True),
        "pad_data_2d[128^2x3->128^2x4]": (
            lambda x: pre.pad_data_2d(x, 128, 4), (128, 128, 11, 3), False),
        "resize_trilinear_3d[48^3->64^3]": (
            lambda x: pre.resize_trilinear_3d(x, (64, 64, 64)), (48, 48, 48, 2, 5), True),
    }
    for name, (fn, shape, library) in cases.items():
        x = rng.standard_normal(shape).astype(np.float32)
        got = fn(x)
        with plain_host():
            want = fn(x)
            plain = host_ms(lambda: fn(x)) if library else None
        err = float(np.abs(got - want).max())
        out[name] = dict(max_abs_err=err, limit=RESIZE_TOL, library=library,
                         native_ms=host_ms(lambda: fn(x)) if library else None,
                         plain_ms=plain)
        if got.shape != want.shape or not err <= RESIZE_TOL:
            raise AssertionError(f"native {name}: {got.shape} vs {want.shape}, max abs "
                                 f"error {err} (limit {RESIZE_TOL})")
    B, T, r, c = LOADER["batch"], 11, 128, 4
    srcs = [special_field(T * r * r * c, 100 + j) for j in range(B)]
    x_shape, y_shape = (B, T - 1, r, r, c), (B, 1, r, r, c)

    def assemble(dtype):
        if dtype == "float32":
            xs, ys = np.empty(x_shape, np.float32), np.empty(y_shape, np.float32)
            pre.assemble_windows(srcs, xs, ys)
            return xs.view(np.uint32), ys.view(np.uint32)
        xt, yt = torch.empty(x_shape, dtype=torch.bfloat16), torch.empty(y_shape,
                                                                          dtype=torch.bfloat16)
        xs, ys = pre.bf16_words(xt), pre.bf16_words(yt)
        pre.assemble_windows(srcs, xs, ys)
        return xs, ys

    for dtype in ("float32", "bfloat16"):
        got = assemble(dtype)
        with plain_host():
            want = assemble(dtype)
            plain = host_ms(lambda: assemble(dtype), runs=3)
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        out[f"assemble_windows_{dtype}"] = dict(
            mismatched=bad, elements=int(sum(g.size for g in got)),
            native_ms=host_ms(lambda: assemble(dtype), runs=3), plain_ms=plain)
        if bad:
            raise AssertionError(f"native assemble_windows ({dtype}): {bad} elements differ "
                                 "from the plain version")
    flat = np.stack(srcs)[:, : int(np.prod(x_shape[1:]))]
    truncated = (flat.view(np.uint32) >> 16).astype(np.uint16)
    caught = int((got[0].reshape(B, -1) != truncated).sum())
    out["bf16_truncation_control"] = dict(mismatched=caught)
    if not caught:
        raise AssertionError("a bf16 conversion by truncation agrees with the library: the "
                             "bit-for-bit check cannot see a rounding fault")
    return out


class RawF32Reader:
    """Windows of time-major float32 trajectories stored raw, one
    (T, H, W, C) file a trajectory (<root>/data_{i}.f32), memory-mapped: the
    smoke's stand-in for the HDF5 reader on a host where h5py does not
    import. Returns memmap views with copy=False, as raw_hdf5's readers do."""

    time_major = True

    def __init__(self, root: Path, shape: tuple):
        self.root, self.shape = Path(root), tuple(shape)
        self._maps: dict = {}

    def read(self, idx: int, tsel=None, copy: bool = True) -> np.ndarray:
        m = self._maps.get(idx)
        if m is None:
            m = self._maps[idx] = np.memmap(self.root / f"data_{idx}.f32", np.float32, "r",
                                            shape=self.shape)
        w = m if tsel is None else m[tsel]
        return np.array(w) if copy else w


@contextlib.contextmanager
def loader_corpus(root: Path):
    """The two sets of LOADER_SETS on disk under root, registered in the
    port's registry (DPOT_DATA_ROOT = root while the context is open);
    yields the storage used, "hdf5" or "raw_f32"."""
    from dpot_tpu_torch.data import generation, grid_dataset
    from dpot_tpu_torch.data.registry import DatasetSpec, register_dataset

    has_h5py = subprocess.run([sys.executable, "-c", "import h5py"], capture_output=True,
                              timeout=120).returncode == 0
    old_root = os.environ.get("DPOT_DATA_ROOT")
    os.environ["DPOT_DATA_ROOT"] = str(root)
    opener = grid_dataset._open_sample_reader
    try:
        if has_h5py:
            for name, kw in LOADER_SETS.items():
                generation.generate_synthetic_corpus(str(root), name=name,
                                                     n_train=LOADER["train"],
                                                     n_test=LOADER["test"], **kw)
        else:
            shapes = {}
            for name, kw in LOADER_SETS.items():
                kw = {k: v for k, v in kw.items() if k != "time_major"}
                spec = dict(name=name, train_path=f"{name}/train", test_path=f"{name}/test",
                            train_size=LOADER["train"], test_size=LOADER["test"],
                            scatter_storage=True, t_test=max(kw["t_total"] - 11, 1), t_in=10,
                            downsample=(1, 1), **kw)
                synth = DatasetSpec(**spec, synthetic=True)
                for split, n in (("train", LOADER["train"]), ("test", LOADER["test"])):
                    (root / name / split).mkdir(parents=True)
                    for i in range(n):
                        traj = grid_dataset._synthetic_sample(synth, split == "train", i)
                        np.ascontiguousarray(np.moveaxis(traj, -2, 0)).tofile(
                            root / name / split / f"data_{i}.f32")
                register_dataset(DatasetSpec(**spec))
                shapes[name] = (kw["t_total"], *kw["in_size"], kw["n_channels"])

            def open_reader(spec, train):
                if spec.name in shapes:
                    return RawF32Reader(Path(spec.resolve(train)), shapes[spec.name]).read
                return opener(spec, train)

            grid_dataset._open_sample_reader = open_reader
        yield "hdf5" if has_h5py else "raw_f32"
    finally:
        grid_dataset._open_sample_reader = opener
        if old_root is None:
            os.environ.pop("DPOT_DATA_ROOT", None)
        else:
            os.environ["DPOT_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


def epochs_of(loader):
    """The loader's batches, epoch after epoch."""
    ep = 0
    while True:
        loader.set_epoch(ep)
        yield from loader
        ep += 1


def loader_rate(ds, **kw) -> float:
    """samples/s of the train loader on ds: LOADER["batches"] batches of
    LOADER["batch"] after LOADER["warmup"], each copied to the card as the
    train loop copies it (x in bf16) and synchronised, inline with
    LOADER["workers"] threads."""
    from dpot_tpu_torch.data import DataLoader
    from dpot_tpu_torch.train.loop import _to_device

    dl = DataLoader(ds, LOADER["batch"], num_workers=LOADER["workers"], seed=1, prefetch=0,
                    **kw)
    it = epochs_of(dl)
    for i in range(LOADER["warmup"] + LOADER["batches"]):
        if i == LOADER["warmup"]:
            t0 = time.perf_counter()
        x, y, _, _ = next(it)
        _to_device(x, torch.device("cuda"), torch.bfloat16)
        _to_device(y, torch.device("cuda"))
        torch.cuda.synchronize()
    return LOADER["batch"] * LOADER["batches"] / (time.perf_counter() - t0)


def compare_loaders(a, b, exact: bool) -> float:
    """One epoch of two loaders in lockstep: the worst difference of x and y
    (bf16 columns as their rounded values), masks and classes equal."""
    from dpot_tpu_torch.native.preprocess import bf16_words

    def host(v):
        if isinstance(v, torch.Tensor):
            return bf16_words(v)
        return v

    worst, n = 0.0, 0
    for ba, bb in zip(a, b, strict=True):
        for k, (u, v) in enumerate(zip(ba, bb)):
            u, v = host(u), host(v)
            if u.shape != v.shape or u.dtype != v.dtype:
                raise AssertionError(f"loader batches differ in column {k}: {u.dtype}{u.shape} "
                                     f"vs {v.dtype}{v.shape}")
            if exact or k >= 2:
                if not np.array_equal(u.view(np.uint8), v.view(np.uint8)):
                    raise AssertionError(f"loader batches differ in column {k} (bit for bit)")
            else:
                worst = max(worst, float(np.abs(u - v).max()))
        n += 1
    if not n:
        raise AssertionError("compare_loaders: no batch")
    return worst


def loader_train_run(tag: str, paths: list, k: int, profile: bool = False) -> dict:
    """The train CLI in bf16 on `paths` at k steps a dispatch: steps,
    launches (all hopper, exact), per-step losses, the loop's time per
    optimizer step (train and loader wait, from its log, per epoch) and,
    under `profile`, the device's busy time and idle share over the last
    epoch (its train steps, evaluation and checkpoint; torch.profiler,
    started when the loop logs the first epoch's line)."""
    from unittest import mock

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data.registry import get_spec
    from dpot_tpu_torch.utils.metrics_logging import MetricWriter

    flags = list(TRAIN_FLAGS)
    i = flags.index("--train_paths")
    flags[i + 1: i + 2] = paths
    flags[flags.index("--epochs") + 1] = str(LOADER["epochs"])
    flags[flags.index("--batch_size") + 1] = str(LOADER["batch"])
    argv = flags + ["--dtype", "bfloat16", "--steps_per_dispatch", str(k), "--log_path",
                    str(RUN_DIR / f"loader_{tag}"), "--device", "cuda"]
    B, epochs = LOADER["batch"], LOADER["epochs"]
    n = LOADER["train"] * len(paths)
    steps = epochs * math.ceil(n / B)
    eval_apps = epochs * sum(math.ceil(LOADER["test"] / B) * get_spec(p).t_test
                             for p in paths)
    want = TI["depth"] * (steps + eval_apps)
    prof = torch_profile(activities=[ProfilerActivity.CUDA])
    window = []  # host clock at the profiler's start and stop
    text = MetricWriter.text

    def epoch_text(writer, msg):
        text(writer, msg)
        if profile and msg.startswith(f"epoch {epochs - 2},"):
            torch.cuda.synchronize()
            prof.start()
            window.append(time.perf_counter())

    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(MetricWriter, "text", epoch_text), \
            contextlib.redirect_stdout(io.StringIO()):
        out = train_main(argv)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if window:
        prof.stop()
        window.append(time.perf_counter())
    launches, ba = fused_gn_afno.launches, bias_act.launches
    if out["state"].step != steps or launches != want:
        raise AssertionError(f"loader_ti {tag}: {out['state'].step} steps (expected {steps}), "
                             f"{launches} launches (expected depth x (train + eval "
                             f"applications) = {want})")
    by_path = check_paths("bfloat16", launches)
    losses = read_metrics(out["log_dir"])["train_loss_step"]
    if len(losses) != steps or not finite(losses + out["test_l2_fulls"]):
        raise AssertionError(f"loader_ti {tag}: losses {losses}")
    logs = (Path(out["log_dir"]) / "logs.txt").read_text()
    # the log's averages are per loader batch, of k steps but for the tail
    per_step = math.ceil(n / (B * k)) / math.ceil(n / B)
    train_ms = [float(v) * 1e3 * per_step
                for v in re.findall(r"time train avg ([-0-9.e]+)", logs)]
    wait_ms = [float(v) * 1e3 * per_step for v in re.findall(r"load avg ([-0-9.e]+)", logs)]
    row = dict(paths=paths, steps_per_dispatch=k, steps=steps, run_s=run_s, launches=launches,
               launches_by_path=by_path, bias_act_launches=ba, losses=losses,
               test_l2_fulls=out["test_l2_fulls"], dispatch_units=out["dispatch_steps"],
               train_ms_per_step=train_ms, loader_wait_ms_per_step=wait_ms,
               wall_ms_per_step=[a + b for a, b in zip(train_ms, wait_ms)])
    if profile:
        kernels = [e for e in prof.events() if is_kernel(e)] if window else []
        wall = (window[1] - window[0]) * 1e3 if window else None
        busy = union_us(kernels) / 1e3 if kernels else None
        row.update(last_epoch_wall_ms=wall, last_epoch_busy_ms=busy,
                   last_epoch_idle_share=None if busy is None else 1 - busy / wall)
    return row


def phase_loader_ti() -> dict:
    """The native host library built and held against its plain versions on
    the card's host; a corpus on disk in the registry's shapes; the
    loader's rates (a) plain, (b) native per item on the mixture, (c) the
    whole-batch native assembly of the time-major set with a pinned ring and
    bf16 x; then DPOT-Ti pretrained through the train CLI on the mixture
    and on the time-major set, eager and at K steps a dispatch (bitwise the
    eager losses: the ring's slots are fenced)."""
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    native_build.build_library()
    build_info = native_build_info(time.perf_counter() - t0)
    log("native_build", **build_info)
    checks = check_native_host()
    mix, tm = list(LOADER_SETS), ["loader_pdb"]
    kw = dict(res=128, t_in=10, t_ar=1, train=True)
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with loader_corpus(RUN_DIR / "loader_corpus") as storage:
        corpus_s = time.perf_counter() - t0
        ds_mix, ds_tm = MixedTemporalDataset(mix, **kw), MixedTemporalDataset(tm, **kw)
        per_item = MixedTemporalDataset(tm, **kw)
        per_item.fetch_many_into = None  # the loader then fills item by item
        if ds_mix.time_major_batches or not ds_tm.time_major_batches:
            raise AssertionError("loader_ti: the mixture must ship standard-layout batches "
                                 "and the 128^2 set time-major ones")
        ring = dict(slot_ring=2)
        with plain_host():
            rate_a = loader_rate(ds_mix)
        rate_b = loader_rate(ds_mix, x_dtype=torch.bfloat16, **ring)
        rate_c = loader_rate(ds_tm, x_dtype=torch.bfloat16, **ring)
        lkw = dict(batch_size=LOADER["batch"], num_workers=LOADER["workers"], seed=3, prefetch=0)
        with plain_host():
            plain_batches = list(DataLoader(ds_mix, **lkw))
        ab_err = compare_loaders(plain_batches, DataLoader(ds_mix, **lkw, **ring), exact=False)
        del plain_batches
        if not ab_err <= RESIZE_TOL:
            raise AssertionError(f"loader_ti: native batches {ab_err} from the plain path's")
        compare_loaders(DataLoader(ds_tm, x_dtype=torch.bfloat16, **lkw, **ring),
                        DataLoader(per_item, x_dtype=torch.bfloat16, **lkw, **ring), exact=True)
        runs = {"mixture": loader_train_run("mixture", mix, 1, profile=True),
                "time_major": loader_train_run("time_major", tm, 1),
                f"time_major_k{LOADER['K']}": loader_train_run("time_major_k", tm, LOADER["K"])}
    eager, graphed = runs["time_major"], runs[f"time_major_k{LOADER['K']}"]
    if graphed["losses"] != eager["losses"] or graphed["test_l2_fulls"] != eager["test_l2_fulls"]:
        raise AssertionError(f"loader_ti: K = {LOADER['K']} losses {graphed['losses']} differ "
                             f"from the eager run's {eager['losses']}")
    by_path = {p: sum(r["launches_by_path"][p] for r in runs.values())
               for p in afno_fused.PATHS}
    row = dict(storage=storage, corpus_s=corpus_s, native_build=build_info, native=checks,
               rates_samples_per_s={"a_plain": rate_a, "b_native_per_item": rate_b,
                                    "c_native_batch_ring_bf16": rate_c},
               ab_max_abs_err=ab_err, ab_limit=RESIZE_TOL, c_equals_per_item=True,
               graphed_equals_eager=True, launches=sum(by_path.values()),
               launches_by_path=by_path,
               bias_act_launches=sum(r["bias_act_launches"] for r in runs.values()),
               runs=runs)
    log("loader_ti", **row)
    return row


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_processes(token: str) -> dict[int, str]:
    """The processes other than this one that carry RUN_TOKEN=token in
    their environment or descend from this one, by pid, with their command
    lines (a zombie's is empty)."""
    mark, me = f"{RUN_TOKEN}={token}".encode(), os.getpid()
    parents, found = {}, {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit() or int(entry.name) == me:
            continue
        pid = int(entry.name)
        with contextlib.suppress(OSError, ValueError, IndexError):
            # the fields after the command's closing parenthesis: state, ppid
            parents[pid] = int((entry / "stat").read_text().rsplit(")", 1)[1].split()[1])
            if mark in (entry / "environ").read_bytes().split(b"\0"):
                found[pid] = ""
    for pid in parents:
        up, seen = parents.get(pid), set()
        while up and up not in seen and pid not in found:
            if up == me:
                found[pid] = ""
            seen.add(up)
            up = parents.get(up)
    for pid in found:
        with contextlib.suppress(OSError):
            found[pid] = (Path("/proc") / str(pid) / "cmdline").read_bytes().replace(
                b"\0", b" ").decode(errors="replace").strip()
    return found


def reap_children() -> None:
    """Wait for every child of this process that has ended."""
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass


def end_leftovers(token: str) -> dict:
    """End every process of this run that is still alive (`run_processes`):
    SIGTERM, then SIGKILL after 10 s to what is left; reap this process's
    children. Returns what it found, by pid, and how long it took."""
    t0 = time.perf_counter()
    reap_children()
    found = run_processes(token)
    for pid in found:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.kill(pid, signal.SIGTERM)
    while run_processes(token) and time.perf_counter() - t0 < 10:
        time.sleep(0.1)
        reap_children()
    killed = []
    for pid in run_processes(token):
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)
    if killed:
        time.sleep(0.1)
        reap_children()
    return dict(found={str(p): c for p, c in found.items()}, sigkilled=killed,
                still_alive=sorted(run_processes(token)), seconds=time.perf_counter() - t0)


class Launch:
    """RANK_JOBS[job] on `nproc` ranks through torchrun (`python -m
    torch.distributed.run`, this script as the rank program), started in
    the background. With `hold`, each rank waits after its start-up until
    `go()`, so that the start-up overlaps the caller's work and the job
    runs on a card the caller has left. `finish()` waits for the launch
    within RANK_TIMEOUT of its start, killing its whole process group if it
    runs over, and returns the ranks' results in rank order; `kill()` ends
    it whatever its state. The ranks' output goes to a log file under
    RUN_DIR, whose end a failure shows."""

    def __init__(self, nproc: int, job: str, args: dict, tag: str, hold: bool = False):
        self.nproc, self.tag = nproc, tag
        self.work = RUN_DIR / tag
        self.work.mkdir(parents=True, exist_ok=True)
        self.go_path = self.work / "go" if hold else None
        if hold:
            self.go_path.unlink(missing_ok=True)  # a go left by an earlier launch
        (self.work / "args.json").write_text(json.dumps(
            {**args, "out": str(self.work), "go": self.go_path and str(self.go_path)}))
        self.log_path = self.work / "torchrun.log"
        self.t_launch = time.time()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
               str(Path(__file__).resolve()), "rank", job, str(self.work / "args.json")]
        self.out = open(self.log_path, "wb")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=self.out, stderr=subprocess.STDOUT,
                                     start_new_session=True,
                                     env={**os.environ, "OMP_NUM_THREADS": "4"})

    def go(self) -> None:
        self.go_path.touch()

    def kill(self) -> None:
        if self.proc.poll() is None:
            # torchrun ends its ranks, which run in sessions of their own,
            # on SIGTERM; then its own group, and any rank still alive
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, 9)
            self.proc.wait()
            for pid_file in self.work.glob("pid*"):
                with contextlib.suppress(ProcessLookupError, ValueError):
                    os.kill(int(pid_file.read_text()), 9)
        self.out.close()

    def finish(self) -> list[dict]:
        try:
            self.proc.wait(timeout=max(RANK_TIMEOUT - (time.time() - self.t_launch), 1.0))
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"{self.tag}: torchrun ran over {RANK_TIMEOUT} s:\n"
                                 f"{self.log_path.read_text(errors='replace')[-4000:]}")
        self.out.close()
        t_end = time.time()
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.tag}: torchrun exited {self.proc.returncode}:\n"
                                 f"{self.log_path.read_text(errors='replace')[-6000:]}")
        rows = [torch.load(self.work / f"rank{r}.pt", weights_only=False)
                for r in range(self.nproc)]
        for row in rows:
            # where a launch's seconds go: start-up (torchrun, the
            # interpreter, imports), the hold, the job (the card included),
            # and the teardown
            entered, started, done = row.pop("clock")
            row["launch_s"] = dict(start=entered - self.t_launch, held=started - entered,
                                   job=done - started, teardown=t_end - done)
        self.seconds = t_end - self.t_launch
        return rows


def collective_ms(events, runs: int) -> dict:
    """Per step: the host time in collectives (the union of the CPU events
    that name one, on any thread) and the device time of collective kernels
    (nccl's; gloo's run on the host), in ms."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU and COLLECTIVE.search(e.name)]
    dev = [e for e in events if is_kernel(e) and COLLECTIVE.search(e.name)]
    names: dict[str, float] = {}
    for e in host + dev:
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us() / runs / 1e3
    return dict(collective_host_ms=union_us(host) / runs / 1e3,
                collective_device_ms=union_us(dev) / runs / 1e3,
                collective_events_ms=dict(sorted(names.items(), key=lambda kv: -kv[1])[:8]))


def rank_profile(step, runs: int, global_rows: int) -> dict:
    """A rank's step over `runs` steps after a warm-up (every rank runs the
    same steps, whose collectives pair up): median wall on the host clock,
    global samples/s, then one profiled window of `runs` steps (the
    profiler asked once: every rank must step alike) for this rank's device
    busy time and idle share and the collectives' time and share of the
    wall, and the peak memory of the timed steps."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    row = dict(wall_ms=wall, wall_ms_each=walls, global_samples_per_s=global_rows / wall * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if is_kernel(e)]
    if not kernels:
        row.update(device_busy_ms="not measured")
        return row
    busy = union_us(kernels) / runs / 1e3
    coll = collective_ms(events, runs)
    row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
               collective_share=coll["collective_host_ms"] / wall, **coll)
    return row


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous rows of a global batch."""
    n = batch["x"].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def rank_train(args: dict) -> dict:
    """A ddp_cdpot rank: the cut corpora registered, cli.train's main on
    args["argv"], then what the parent checks (step, launches, epoch
    metrics, the final weights) and, with args["profile"], the rank's step
    profile on a batch of the cut corpora; cuDNN's deterministic algorithms
    as args["cudnn_deterministic"] says."""
    import torch.distributed as dist

    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.parallel import rank_world
    from dpot_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.deterministic = bool(args.get("cudnn_deterministic"))
    for kw in args["specs"]:
        make_synthetic_spec(**kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_main(args["argv"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rank, world = rank_world()
    state = out["state"]
    row = dict(rank=rank, world=world, backend=dist.get_backend(),
               device=str(next(state.model.parameters()).device),
               wrapper=type(state.forward_module).__name__, step=state.step,
               launches=fused_gn_afno.launches,
               launches_by_path=dict(fused_gn_afno.launches_by_path),
               bias_act_launches=bias_act.launches, run_s=time.perf_counter() - t0,
               loop_step_s=out["step_seconds"], log_dir=out["log_dir"],
               history={k: out[k] for k in ("train_l2_step", "train_l2_full", "test_l2_steps",
                                            "test_l2_fulls")},
               params={k: v.detach().cpu() for k, v in state.params_state_dict().items()},
               replicas=replica_check(state.model))
    if args.get("profile"):
        (b,) = corpus_batches(CDPOT_CONFIG, args["tag"], DDP_CDPOT, args["batch"],
                              torch.float32, 1, seed=1)
        del b["noise"]  # drawn from the state's generator, for the global batch
        b = rank_rows(b, rank, world)
        step_fn = make_train_step(noise_scale=args["noise_scale"], ones_mask=True)
        row["profile"] = rank_profile(lambda: step_fn(state, b), PROFILE_STEPS, args["batch"])
    row["job_s"] = dict(train=train_s, after=time.perf_counter() - t0 - train_s)
    return row


def replica_check(model) -> dict:
    """utils/inspection.py check_replica_consistency over the ranks (a
    collective): the tensors it compared, bit for bit, and the error it
    raised for a control in which rank 1's copy of the first parameter is
    one ulp off in one element (one rank: nothing to compare)."""
    import torch.distributed as dist

    from dpot_tpu_torch.utils.inspection import check_replica_consistency

    compared = check_replica_consistency(model)
    if dist.get_world_size() < 2:
        return dict(compared=compared, control=None)
    p = next(model.parameters())
    saved = p.detach().clone()
    control = None
    with torch.no_grad():
        if dist.get_rank() == 1:
            flat = p.view(-1)
            flat[:1] = torch.nextafter(flat[:1], torch.full_like(flat[:1], math.inf))
        try:
            check_replica_consistency(model)
        except AssertionError as e:
            control = str(e)
        p.copy_(saved)
    if control is None:
        raise AssertionError("check_replica_consistency missed a rank's changed copy")
    return dict(compared=compared, control=control)


def fsdp_l_batch(i: int) -> dict:
    """fsdp_l's i-th global batch of 16, drawn on the host from a seed (the
    same in every process): x (bf16, the L wire) and one target frame."""
    g = torch.Generator().manual_seed(FSDP_L["seed"] + i)
    x = torch.randn((L_BATCH, 128, 128, 10, 4), generator=g)
    y = torch.randn((L_BATCH, 128, 128, 1, 4), generator=g)
    return {"x": x.to("cuda", torch.bfloat16), "y": y.cuda(),
            "cls": torch.zeros(L_BATCH, dtype=torch.long, device="cuda")}


def fsdp_l_state(model, lp: bool = False):
    """fsdp_l's train state: lamb with configs/pretrain_large.yaml's clip;
    `lp`, the bf16 working copy."""
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.utils.config import TrainConfig

    clip = TrainConfig(train_paths=["synthetic"]).grad_clip  # the file sets none
    return TrainState.create(model, build_optimizer("lamb", model.parameters(), FSDP_L["lr"],
                                                    grad_clip=clip), 0,
                             param_working_dtype=torch.bfloat16 if lp else None)


def rank_fsdp(args: dict) -> dict:
    """An fsdp_l rank: seeded DPOT-L under FSDP2, FSDP_L's steps on this
    rank's rows, in each every bf16 block that the kernel read against a
    fresh conversion of the weight FSDP2 gathered for that call (the
    weight the kernel was handed), and whether that weight was marked
    uncached, the last main step profiled; then the control, forwards
    through a cache keyed on the weight tensor alone."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    import torch.distributed as dist

    from dpot_tpu_torch.models.dpot import AFNO2D
    from dpot_tpu_torch.parallel import rank_world
    from dpot_tpu_torch.parallel.fsdp import check_fsdp_shardings, shard_state_fsdp
    from dpot_tpu_torch.parallel.mesh import make_mesh
    from dpot_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.deterministic = False  # as in the one-process run
    gc.collect()
    torch.cuda.empty_cache()
    carried_gb = torch.cuda.memory_allocated() / 1e9  # left by an earlier job
    rank, world = rank_world()
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    model = preset_model("L", "bfloat16", FSDP_L["seed"], device=str(device))
    model.remat = True
    state = fsdp_l_state(model)
    torch.cuda.reset_peak_memory_stats()
    build_s = time.perf_counter() - t0
    shard_state_fsdp(state, make_mesh(device=device))
    shard_s = time.perf_counter() - t0 - build_s
    step_s = []
    unsharded = check_fsdp_shardings(state)
    afnos = [m for m in model.modules() if isinstance(m, AFNO2D)]
    step_fn = make_train_step(noise_scale=5e-4, ones_mask=True)
    real = afno_fused._bf16_blocks
    # per call: (blocks read == a fresh conversion, the cache key, the
    # weight left to the cache)
    calls: list = []
    stale: dict = {}

    def check(w, out, pairs=False):
        fresh = afno_fused._convert_blocks(w.detach(), pairs)
        calls.append((torch.equal(out, fresh), (w.data_ptr(), w._version),
                      getattr(w, "_dpot_block_cache", True)))
        return out

    def spy(w, pairs=False):
        out = check(w, real(w, pairs), pairs)
        stale[id(w)] = out  # what the control serves in the next step
        return out

    def stale_spy(w, pairs=False):
        # the control: a cache keyed on the tensor alone
        return check(w, stale[id(w)] if id(w) in stale else real(w, pairs), pairs)

    reset_launch_counts()
    steps = []
    prof_row: dict = {}
    prev_keys: list = []
    n_weights = 2 * len(afnos)
    for i in range(FSDP_L["steps"] + FSDP_L["control"]):
        control = i >= FSDP_L["steps"]
        calls.clear()
        b = rank_rows(fsdp_l_batch(i), rank, world)
        afno_fused._bf16_blocks = stale_spy if control else spy
        try:
            if control:
                # a forward reads every weight once; the stale cache is
                # then caught, or not, as in a whole step
                with torch.no_grad():
                    state.forward_module(b["x"])
                torch.cuda.synchronize()
                aux = dict(loss_step=float("nan"), grad_norm=float("nan"))
            elif i == FSDP_L["steps"] - 1:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    aux = step_fn(state, b)[1]
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                coll = collective_ms(prof.events(), 1)
                kernels = [e for e in prof.events() if is_kernel(e)]
                busy = union_us(kernels) / 1e3 if kernels else "not measured"
                prof_row = dict(wall_ms=wall, device_busy_ms=busy, **coll)
            else:
                t1 = time.perf_counter()
                aux = step_fn(state, b)[1]
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
        finally:
            afno_fused._bf16_blocks = real
        # the forward's calls (remat's recomputations follow them); how many
        # weights the real cache's key (address, version) would have found
        # unchanged since the last step: served stale, had the cache been on
        keys = [k for _, k, _ in calls[:n_weights]]
        repeats = sum(k == p for k, p in zip(keys, prev_keys))
        prev_keys = keys
        steps.append(dict(control=control, loss=float(aux["loss_step"]),
                          grad_norm=float(aux["grad_norm"]), calls=len(calls),
                          checked=len(keys), mismatched=sum(not ok for ok, _, _ in calls),
                          left_to_cache=sum(c for _, _, c in calls),
                          cache_key_repeats=repeats))
    torch.cuda.synchronize()
    return dict(rank=rank, world=world, backend=dist.get_backend(), device=str(device),
                unsharded=unsharded, afno_modules=len(afnos), carried_gb=carried_gb,
                steps=steps, launches=fused_gn_afno.launches,
                launches_by_path=dict(fused_gn_afno.launches_by_path),
                bias_act_launches=bias_act.launches,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, profile=prof_row,
                job_s=dict(build=build_s, shard=shard_s, steps=step_s))


@contextlib.contextmanager
def fft_route():
    """Every trunk block's norm1 and mixer as the single-device FFT route,
    the JAX package's non-fused path: GroupNorm, then afno_filter_2d (no
    kernel): sp_l's one-process reference."""
    from dpot_tpu_torch.models.dpot import AFNO2D
    from dpot_tpu_torch.ops.activations import get_activation
    from dpot_tpu_torch.ops.norms import group_norm
    from dpot_tpu_torch.ops.spectral import afno_filter_2d

    def forward(self, x, norm):
        xn = group_norm(x, norm.weight, norm.bias, norm.num_groups)
        return afno_filter_2d(xn, self.w1, self.b1, self.w2, self.b2, self.modes,
                              get_activation(self.act), x.dtype)

    real = AFNO2D.forward
    AFNO2D.forward = forward
    try:
        yield
    finally:
        AFNO2D.forward = real


@contextlib.contextmanager
def patched(module, name: str, fn):
    """module.name replaced by fn inside the block: a control's fault."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def layout_controls(faults: str, model) -> dict:
    """Each job's faults on purpose, which its checks must catch: the name
    of the check each must fail, and the fault."""
    from dpot_tpu_torch.models.unet import local_batch_stats
    from dpot_tpu_torch.parallel import dist_fft, pipeline, tensor

    wrong_slot = pipeline.permute
    return {
        "tp_l": {"without_fc2_reduce": ("pred", lambda: patched(
                     tensor, "reduce", lambda z, axis: z)),
                 "without_copy_backward_reduce": ("grad", lambda: patched(
                     tensor, "copy", lambda h, axis: h))},
        # the permute taking the stage's own slot (a shift of 0 at P = 2)
        "pp_l": {"wrong_permute_shift": ("pred", lambda: patched(
                     pipeline, "permute", lambda t, axis, shift: wrong_slot(t, axis, shift + 1)))},
        "sp_l": {"all_to_all_skipped": ("pred", lambda: patched(
                     dist_fft, "all_to_all", lambda z, axis: z))},
        # each rank's BatchNorm statistics of its own rows
        "bn": {"local_batch_stats": ("grad", lambda: local_batch_stats(model))},
        "ckpt": {},
    }[faults]


def full(named: dict) -> dict:
    """name -> tensor with FSDP2's shards gathered (a collective every rank
    calls, in the same order)."""
    from dpot_tpu_torch.parallel.fsdp import gathered

    return {n: gathered(t) for n, t in named.items()}


def held_to(ref: dict, named: dict, tp_dims: dict, axis) -> dict:
    """A rank's tensors (name -> its part: a TP shard, a stage's block, a
    replicated leaf, FSDP2's gathered) against one process's full ones
    (`ref`, on the host): one relative L2 over all of them, and the worst
    leaf's."""
    from dpot_tpu_torch.parallel.tensor import local_shard

    named = full(named)
    if not set(named) <= set(ref):
        raise AssertionError(f"leaves that one process has not: {sorted(set(named) - set(ref))[:4]}")
    num = den = 0.0
    per = {}
    for n, t in named.items():
        r = ref[n]
        if n in tp_dims:
            r = local_shard(r, tp_dims[n], axis)
        r = r.to(t.device, torch.float32)
        d = (t.detach().float() - r).square().sum().item()
        q = r.square().sum().item()
        per[n] = math.sqrt(d / q) if q > 0 else (0.0 if d == 0 else math.inf)
        num, den = num + d, den + q
    worst = max(per, key=per.get)
    return dict(rel_l2=math.sqrt(num / den), leaves=len(per), worst=worst,
                worst_rel_l2=per[worst])


def master_of(state) -> dict:
    """The weights the optimizer updates, by the model's parameter names:
    the f32 master of a working copy, else the parameters themselves."""
    return {n: m.detach() for (n, _), m in zip(state.model.named_parameters(),
                                                state.optimizer.params, strict=True)}


def grads_of(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def stats_of(model) -> dict:
    """A model's float buffers (UNet's running statistics)."""
    return {n: b for n, b in model.named_buffers() if b.is_floating_point()}


def job_spec(job: str) -> dict:
    spec = dict(model="L", dtype="bfloat16", depth=None, lp=False, route="hopper_l",
                remat=True)
    spec.update(LAYOUT_JOBS[job])
    return spec


def job_model(job: str, device, **kw):
    """A layout job's seeded model on `device` (kw: a mesh)."""
    from dpot_tpu_torch.models import build_model

    spec = job_spec(job)
    dtype = getattr(torch, spec["dtype"])
    seed = FSDP_L["seed"]
    if spec["model"] == "L":
        depth = {} if spec["depth"] is None else dict(depth=spec["depth"])
        model = preset_model("L", spec["dtype"], seed, device=str(device), **depth, **kw)
    elif spec["model"] == "DPOT3D":
        model = build_model("DPOT3D", depth=2, dtype=dtype, device=str(device), seed=seed, **L3D)
    elif spec["model"] == "CDPOT":
        model = build_model("CDPOT", dtype=dtype, device=str(device), seed=seed,
                            **cdpot_sweep_model_kw())
    else:
        model = build_model("UNet", img_size=128, in_channels=4, out_channels=4,
                            in_timesteps=10, out_layer_dim=32, n_cls=1, dtype=dtype,
                            device=str(device), seed=seed)
    model.remat = spec["remat"]
    return model


def job_batch(job: str, i: int) -> dict:
    """A layout job's i-th global batch, drawn on the host from a seed (the
    same in every process): fsdp_l's for L, else one of the model's grid."""
    spec = job_spec(job)
    if spec["model"] == "L":
        return fsdp_l_batch(i)
    g = torch.Generator().manual_seed(FSDP_L["seed"] + 100 + i)
    if spec["model"] == "DPOT3D":
        B, grid, c = MORE_L["d3_batch"], (64, 64, 64), 5
    else:
        B, grid, c = (MORE_L["cdpot_batch"] if spec["model"] == "CDPOT"
                      else MORE_L["unet_batch"]), (128, 128), 4
    x = torch.randn((B, *grid, 10, c), generator=g)
    y = torch.randn((B, *grid, 1, c), generator=g)
    return {"x": x.to("cuda", getattr(torch, spec["dtype"])), "y": y.cuda(),
            "cls": torch.zeros(B, dtype=torch.long, device="cuda")}


def job_step(job: str):
    from dpot_tpu_torch.train.step import make_train_step

    accum = MORE_L["unet_accum"] if job_spec(job)["model"] == "UNet" else 1
    return make_train_step(noise_scale=5e-4, ones_mask=True, grad_accum=accum)


def layout_rows(b: dict, mesh, model) -> dict:
    """A layout rank's part of a global batch: all of its rows under a data
    axis of one rank, its share over 'data', its H rows where the model
    splits the grid over 'spatial'."""
    sp = getattr(model, "spatial", None)
    data = mesh.axis("data")
    if data.size > 1:
        n = b["x"].shape[0] // data.size
        b = {k: v[data.rank * n:(data.rank + 1) * n] for k, v in b.items()}
    if sp is None:
        return b
    n = b["x"].shape[1] // sp.size
    return {k: v if k == "cls" else v[:, sp.rank * n:(sp.rank + 1) * n] for k, v in b.items()}


def rank_layout(job: str, device: torch.device, args: dict) -> dict:
    """A layout job's rank (LAYOUT_JOBS): the seeded model laid out as
    cli.train lays it out (train/loop.py place_state); the first forward's
    prediction and the controls' (layout_controls); FSDP_L's steps on this
    rank's part of the job's batches, the last one profiled (the
    collectives' share); the first step's gradient, the parameter change
    after the steps and a model's running statistics held to one
    process's (`held_to`, args["refs"][job]); launches, peak memory; for
    fsdp_lp_l the checkpoint and its control (`ckpt_job`)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from dpot_tpu_torch.ops.spectral import separable_gn_afno
    from dpot_tpu_torch.parallel.mesh import make_mesh
    from dpot_tpu_torch.train.loop import model_mesh_kw, place_state
    from dpot_tpu_torch.utils.config import TrainConfig

    gc.collect()
    torch.cuda.empty_cache()
    spec = job_spec(job)
    cfg = TrainConfig(train_paths=["synthetic"], model=spec["model"].replace("L", "DPOT"),
                      **spec["cfg"])
    mesh = make_mesh(None, cfg.mesh_spatial, cfg.mesh_model, cfg.mesh_pipe, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = job_model(job, device, **model_mesh_kw(cfg, mesh))
    state = fsdp_l_state(model, spec["lp"])
    state.mesh = mesh
    place_state(state, cfg, device)
    tp_dims = getattr(model, "tp_dims", {})
    axis = mesh.axis("model")
    w1 = [m.w1 for m in model.modules() if hasattr(m, "w1") and hasattr(m, "b2")]
    row = dict(job=job, dtype=spec["dtype"], mesh=mesh.sizes, coords=mesh.coords,
               blocks=len(getattr(model, "blocks", ())), tp_leaves=len(tp_dims),
               local_w1=list(w1[0].to_local().shape if hasattr(w1[0], "to_local")
                             else w1[0].shape) if w1 else None,
               sharded=state.sharded, working_copy=state.params_lp is not None,
               build_s=time.perf_counter() - t0)
    ref = torch.load(args["refs"][job], mmap=True, weights_only=True)
    step_fn = job_step(job)
    b0 = layout_rows(job_batch(job, 0), mesh, model)

    def predict(x):
        model.eval()
        with torch.no_grad():
            out = model(x)
        if state.sharded:
            model.reshard()  # FSDP2 keeps the root gathered after a forward alone
        return (out[0] if isinstance(out, tuple) else out).float().cpu()

    row["pred"] = predict(b0["x"])
    # the controls, before the steps: a forward's prediction, or a step's
    # gradient with the update left out, the noise stream and the buffers
    # put back
    row["controls"] = {}
    for name, (check, fault) in layout_controls(spec["faults"], model).items():
        with fault():
            if check == "pred":
                row["controls"][name] = (check, predict(b0["x"]))
                continue
            gen = state.generator.get_state()
            bufs = [b.clone() for b in model.buffers()]
            state.apply_gradients = lambda *a, **k: None
            try:
                step_fn(state, b0)
            finally:
                del state.apply_gradients
                state.generator.set_state(gen)
                with torch.no_grad():
                    for b, c in zip(model.buffers(), bufs):
                        b.copy_(c)
        row["controls"][name] = (check, held_to(ref["grad"], grads_of(model), tp_dims, axis))
    before = {n: t.to("cpu", torch.float32, copy=True)
              for n, t in full(master_of(state)).items()}
    reset_launch_counts()
    losses, walls, prof_row = [], [], {}
    for i in range(FSDP_L["steps"]):
        b = layout_rows(job_batch(job, i), mesh, model)
        torch.cuda.synchronize()
        if i == FSDP_L["steps"] - 1:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                aux = step_fn(state, b)[1]
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
            coll = collective_ms(prof.events(), 1)
            kernels = [e for e in prof.events() if is_kernel(e)]
            prof_row = dict(wall_ms=wall, collective_share=coll["collective_host_ms"] / wall,
                            device_busy_ms=union_us(kernels) / 1e3 if kernels
                            else "not measured", **coll)
        else:
            t1 = time.perf_counter()
            aux = step_fn(state, b)[1]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(aux["loss_step"]))
        if i == 0:
            row["grad"] = held_to(ref["grad"], grads_of(model), tp_dims, axis)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(launches=fused_gn_afno.launches,
                    launches_by_path=dict(fused_gn_afno.launches_by_path),
                    bias_act_launches=bias_act.launches, separable_calls=separable_gn_afno.calls)
    with torch.no_grad():
        now = full(master_of(state))
        row["delta"] = held_to(ref["delta"], {n: p.float().cpu() - before[n]
                                              for n, p in now.items()}, tp_dims, axis)
        if "stats" in ref:
            row["stats"] = held_to(ref["stats"], stats_of(model), {}, axis)
    if spec["faults"] == "ckpt":
        row.update(ckpt_job(job, state, b0, predict))
    row.update(losses=losses, wall_ms_each=walls, profile=prof_row, peak_memory_gb=peak,
               job_s=time.perf_counter() - t0, **launches)
    return row


def ckpt_job(job: str, state, b0: dict, predict) -> dict:
    """fsdp_lp_l after its steps: the control checkpoint, gathered with the
    shards in the wrong order, written synchronously (its seconds); then
    the checkpoint over gloo (every rank gathers, rank 0 hands the write to
    an AsyncCheckpointWriter, as the loop does): rank 0's seconds inside
    the save call against the write's own on the thread, which runs while
    the forward of the first batch and one more step go on; one process,
    resuming the checkpoint, is held to those (`resume_checks`)."""
    from dpot_tpu_torch.parallel import fsdp, rank_world
    from dpot_tpu_torch.train.checkpoint import AsyncCheckpointWriter, save_checkpoint

    good, bad = RUN_DIR / f"{job}_ckpt", RUN_DIR / f"{job}_ckpt_control"
    t0 = time.perf_counter()
    real = fsdp.gather_stacked
    with patched(fsdp, "gather_stacked", lambda t, axis: real(t, axis).flip(0)):
        save_checkpoint(str(bad), state)
    sync_s = time.perf_counter() - t0
    writer = AsyncCheckpointWriter() if rank_world()[0] == 0 else None
    with writes_recorded() as writes:
        t0 = time.perf_counter()
        save_checkpoint(str(good), state, writer=writer)
        call_s = time.perf_counter() - t0
        pred = predict(b0["x"])
        b = layout_rows(job_batch(job, FSDP_L["steps"]), state.mesh, state.model)
        loss = float(job_step(job)(state, b)[1]["loss_step"])
        t0 = time.perf_counter()
        if writer is not None:
            writer.close()
        wait_s = time.perf_counter() - t0
    return dict(ckpt=dict(good=str(good), bad=str(bad), pred_after=pred, next_loss=loss,
                          save_s=sync_s, async_call_s=call_s, async_wait_s=wait_s,
                          writes=writes))


def serve_l_inputs() -> list[np.ndarray]:
    """tp_serve_l's requests: one seeded input of each batch size."""
    rng = np.random.default_rng(LAYOUT_L["serve_seed"])
    return [rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32)
            for B in LAYOUT_L["serve_batches"]]


def serve_l_requests(rs) -> dict:
    """serve_l_inputs through a started server: the answers and each
    request's wall (ms)."""
    answers, ms = [], []
    for x in serve_l_inputs():
        t0 = time.perf_counter()
        answers.append(rs.submit(x, LAYOUT_L["serve_steps"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(answers=answers, request_ms=ms)


def rank_tp_serve(device: torch.device) -> dict:
    """A tp_serve_l rank: seeded DPOT-L (bf16) served over model = 2; rank 0
    answers the requests, rank 1 follows until rank 0 stops. Launches on
    each rank, the requests' walls on rank 0."""
    import gc

    from dpot_tpu_torch.parallel.mesh import make_mesh
    from dpot_tpu_torch.serve.server import RolloutServer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = preset_model("L", "bfloat16", FSDP_L["seed"], device=str(device))
    rs = RolloutServer(model, mesh=make_mesh(model=2, device=device), device=device,
                       batch_buckets=LAYOUT_L["serve_batches"], max_wait_ms=1.0,
                       warmup_steps=(LAYOUT_L["serve_steps"],))
    reset_launch_counts()
    rs.start()  # rank 1: the follower loop, until rank 0 stops
    row = dict(job="tp_serve_l", leader=rs.leader, tp_leaves=len(model.tp_dims),
               local_w1=list(model.blocks[0].filter.w1.shape),
               warmup_applications=sum(rs._warmup_steps))
    if rs.leader:
        row.update(serve_l_requests(rs))
        rs.stop(drain=True)
    torch.cuda.synchronize()
    row.update(launches=fused_gn_afno.launches,
               launches_by_path=dict(fused_gn_afno.launches_by_path),
               bias_act_launches=bias_act.launches, job_s=time.perf_counter() - t0)
    return row


def rank_mesh_serve(job: str, device: torch.device) -> dict:
    """A serve_pp_l or serve_dp_l rank: seeded DPOT-L (bf16) built over the
    job's mesh (SERVE_MESHES) and served; rank 0 answers tp_serve_l's
    requests and then the control's (the first input again), rank 1
    follows. Each rank keeps what its rollouts computed; launches are
    counted over the requests. The control: pipe's permute taking the
    wrong slot on both ranks; data's follower dropping the broadcast input
    (zeros) for the control's rollout."""
    import gc

    from dpot_tpu_torch.parallel import pipeline
    from dpot_tpu_torch.parallel.mesh import make_mesh
    from dpot_tpu_torch.serve.server import RolloutServer
    from dpot_tpu_torch.train.loop import model_mesh_kw
    from dpot_tpu_torch.utils.config import TrainConfig

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    axes = SERVE_MESHES[job]
    mesh = make_mesh(device=device, **axes)
    cfg = TrainConfig(train_paths=["synthetic"], mesh_pipe=axes.get("pipe", 1))
    model = preset_model("L", "bfloat16", FSDP_L["seed"], device=str(device),
                         **model_mesh_kw(cfg, mesh))
    rs = RolloutServer(model, mesh=mesh, device=device, batch_buckets=LAYOUT_L["serve_batches"],
                       max_wait_ms=1.0, warmup_steps=(LAYOUT_L["serve_steps"],))
    computed = []
    eager = rs._eager_rollout
    control_rollout = 2 + len(LAYOUT_L["serve_batches"])  # after the warm-up and requests
    wrong_slot = pipeline.permute

    def rollout(x, n_steps):
        if len(computed) + 1 == control_rollout:
            if "pipe" in axes:
                with patched(pipeline, "permute",
                             lambda t, axis, shift: wrong_slot(t, axis, shift + 1)):
                    out = eager(x, n_steps)
            else:
                out = eager(torch.zeros_like(x) if not rs.leader else x, n_steps)
        else:
            out = eager(x, n_steps)
        computed.append(out.float().cpu())
        if len(computed) + 1 == control_rollout:
            launches.update(launches=fused_gn_afno.launches,
                            launches_by_path=dict(fused_gn_afno.launches_by_path),
                            bias_act_launches=bias_act.launches)
        return out

    launches: dict = {}
    rs._eager_rollout = rollout
    reset_launch_counts()
    rs.start()  # rank 1: the follower loop, until rank 0 stops
    row = dict(job=job, leader=rs.leader, mesh=mesh.sizes, blocks=len(model.blocks),
               warmup_applications=sum(rs._warmup_steps))
    if rs.leader:
        row.update(serve_l_requests(rs))
        row["control_answer"] = rs.submit(serve_l_inputs()[0], LAYOUT_L["serve_steps"])
        rs.stop(drain=True)
    torch.cuda.synchronize()
    row.update(computed=computed, job_s=time.perf_counter() - t0, **launches)
    return row


def rank_pair(args: dict) -> dict:
    """A rank of the parallel phases' 2-rank launch: ddp_cdpot's job
    (args["train"]), then fsdp_l's (args["fsdp"]), and the layout jobs
    (rank_layouts) in the process group that cli.train started, one
    launch's start-up for all."""
    ddp = rank_train(args["train"])
    fsdp = rank_fsdp(args["fsdp"])
    return dict(rank_layouts(args), train=ddp, fsdp=fsdp)


def rank_layouts(args: dict) -> dict:
    """A rank's layout jobs (LAYOUT_JOBS, args["layouts"]), tp_serve_l and
    the mesh serving jobs (also a launch of its own, args["init"] set, to
    run them alone)."""
    import torch.distributed as dist

    device = torch.device("cuda", torch.cuda.current_device())
    row = {job: rank_layout(job, device, args["layouts"]) for job in LAYOUT_JOBS}
    row.update({job: rank_mesh_serve(job, device) for job in SERVE_MESHES})
    return dict(row, rank=dist.get_rank(), tp_serve_l=rank_tp_serve(device))


def layout_args() -> dict:
    """The layout jobs' arguments for their ranks."""
    return dict(refs={job: str(p) for job, p in LAYOUT_REFS.items()})


RANK_JOBS = {"train": rank_train, "pair": rank_pair, "layouts": rank_layouts}


def rank_main(job: str, args_path: str) -> int:
    """The rank program of a multi-process phase, started by torchrun: the
    hold until the parent's go (a held launch), the default process group
    where args["init"] asks for it (the launch's backend, a time limit),
    the job, its result saved for the parent."""
    import torch.distributed as dist

    from dpot_tpu_torch.parallel import maybe_initialize
    from dpot_tpu_torch.utils.device import resolve_device

    entered = time.time()
    args = json.loads(Path(args_path).read_text())
    (Path(args["out"]) / f"pid{os.environ['RANK']}").write_text(str(os.getpid()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    while args.get("go") and not Path(args["go"]).exists():
        if time.time() - entered > RANK_TIMEOUT:
            raise TimeoutError(f"rank: no go within {RANK_TIMEOUT} s")
        time.sleep(0.05)
    started = time.time()
    device = resolve_device(args.get("device", "cuda"))
    if args.get("init"):
        maybe_initialize(args.get("backend"), device, timeout=RANK_TIMEOUT)
    row = RANK_JOBS[job](args)
    row["clock"] = (entered, started, time.time())
    torch.save(row, Path(args["out"]) / f"rank{row['rank']}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def cut_specs(specs) -> list[dict]:
    """make_synthetic_spec's arguments of sweep_file's corpora, for the ranks."""
    return [dict(name=s.name, train_size=s.train_size, test_size=s.test_size,
                 t_total=s.t_total, t_test=s.t_test, in_size=list(s.in_size),
                 n_channels=s.n_channels) for s in specs]


def phase_parallel() -> tuple[dict, dict]:
    """ddp_cdpot and fsdp_l, their runs arranged for time: one process's
    CDPOT run and step profile alone on the card; then the nccl launch and
    the 2-rank launch (held) start, and while they start up, one process's
    L steps (fsdp_l_single); the nccl launch finishes; then the 2-rank
    launch's jobs, alone on the card; last, the checks and cli.serve of
    rank 0's checkpoint. Each launch is ended on the way out, whatever
    happened."""
    import yaml

    from dpot_tpu_torch.cli.sweep import job_to_argv
    from dpot_tpu_torch.train.step import make_train_step
    from dpot_tpu_torch.utils.config import expand_tasks

    cfg_path, specs = sweep_file(CDPOT_CONFIG, "DDP", DDP_CDPOT, RUN_DIR)
    doc = yaml.safe_load(cfg_path.read_text())
    (job,) = expand_tasks(doc)
    argv = job_to_argv(job)
    names = [sp.name for sp in specs]
    common = dict(specs=cut_specs(specs), batch=job["batch_size"], tag="DDP",
                  noise_scale=job["noise_scale"], cudnn_deterministic=True)
    # CDPOT's convolutions: cuDNN's default backward is not deterministic,
    # and 8 adam steps (b2 0.9) carry its run-to-run differences past
    # DDP_TOL (one smoke run: 2.1e-4), so every CDPOT run takes its
    # deterministic algorithms
    deterministic = torch.backends.cudnn.deterministic
    launches: list[Launch] = []
    clock: dict = {}
    t0 = time.perf_counter()
    try:
        # one process's CDPOT run and its step profile first, alone on the
        # card (the run it is held to, and the profile, want it to itself)
        torch.backends.cudnn.deterministic = True
        single, one = ddp_cdpot_single(argv)
        (b,) = corpus_batches(CDPOT_CONFIG, "DDP", DDP_CDPOT, job["batch_size"],
                              torch.float32, 1, seed=1)
        del b["noise"]  # drawn from the state's generator
        step_fn = make_train_step(noise_scale=job["noise_scale"], ones_mask=True)
        one["profile"] = rank_profile(lambda: step_fn(single["state"], b), PROFILE_STEPS,
                                      job["batch_size"])
        torch.backends.cudnn.deterministic = deterministic
        clock["one_process_cdpot"] = time.perf_counter() - t0
        # the default launch line (nccl), its evaluation cut to the first corpus
        launches.append(Launch(1, "train", dict(
            common, argv=argv + ["--log_path", str(RUN_DIR / "ddp_nccl"), "--device", "cuda",
                                 "--test_paths", names[0]]), "ddp_nccl"))
        # two ranks sharing the card (gloo with CUDA tensors), held until
        # the nccl rank is done
        launches.append(Launch(2, "pair", dict(
            device="cuda:0", fsdp={}, layouts=layout_args(),
            train=dict(common, profile=True, argv=argv + [
                "--log_path", str(RUN_DIR / "ddp_2"), "--dist_backend", "gloo",
                "--device", "cuda:0"])), "pair_2", hold=True))
        nccl_launch, pair_launch = launches
        t1 = time.perf_counter()
        ones, serve_one = layout_references()  # while the launches start up
        clock["one_process_layouts"] = time.perf_counter() - t1
        (nccl,) = nccl_launch.finish()
        clock["nccl_launch"] = nccl_launch.seconds
        pair_launch.go()
        t1 = time.perf_counter()
        pair = pair_launch.finish()
        clock["pair_launch_after_go"] = time.perf_counter() - t1
        clock["pair_launch"] = pair_launch.seconds
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for launch in launches:
            launch.kill()
    ddp = ddp_cdpot_checks(job, specs, doc, single, one,
                           [{**r["train"], "launch_s": r["launch_s"]} for r in pair], nccl)
    del single
    torch.cuda.empty_cache()
    fsdp = fsdp_l_checks({k: v for k, v in ones["tp_l"].items() if k != "pred0"},
                         [r["fsdp"] for r in pair])
    layouts = layout_checks(ones, serve_one, pair)
    clock["total"] = time.perf_counter() - t0
    log("ddp_cdpot", **ddp, parallel_s=clock)
    log("fsdp_l", **fsdp, parallel_s=clock)
    return ddp, fsdp, layouts


def ddp_cdpot_single(argv: list) -> tuple[dict, dict]:
    """configs/cdpot_parallel.yaml's job in one process, through cli.train's
    main: its result and its row (steps, launches, seconds)."""
    from dpot_tpu_torch.cli.train import main as train_main

    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_main(argv + ["--log_path", str(RUN_DIR / "ddp_single"), "--device", "cuda"])
    torch.cuda.synchronize()
    return out, dict(step=out["state"].step, launches=fused_gn_afno.launches,
                     launches_by_path=dict(fused_gn_afno.launches_by_path),
                     bias_act_launches=bias_act.launches, run_s=time.perf_counter() - t0)


def ddp_cdpot_checks(job: dict, specs, doc: dict, single: dict, one: dict, ranks: list,
                     nccl: dict) -> dict:
    """ddp_cdpot: steps exact, each run's launches depth x (train + eval
    applications) all on afno_hopper_f32.cu; the 2 ranks' per-step losses
    (rank 0's log), test metrics and final weights within DDP_TOL of one
    process's, rank 0's alone the checkpoint, in the reference layout,
    which cli.serve serves; the nccl rank's epoch metrics within DDP_TOL;
    each rank's step profile (wall, global samples/s, busy and idle, the
    collectives' share) beside one process's. Returns the row."""
    from dpot_tpu_torch.cli.serve import main as serve_main

    batch, depth = job["batch_size"], job["n_layers"]
    steps, eval_apps = sweep_applications(specs, doc["data_weights"], batch,
                                          DDP_CDPOT["epochs"])
    want = depth * (steps + eval_apps)
    names = [sp.name for sp in specs]

    def check_run(what, r, want=want):
        if r["step"] != steps or r["launches"] != want:
            raise AssertionError(f"ddp_cdpot {what}: {r['step']} steps, {r['launches']} "
                                 f"launches; expected {steps} and depth x (train + eval "
                                 f"applications) = {want}")
        if r["launches_by_path"]["hopper_f32"] != want:
            raise AssertionError(f"ddp_cdpot {what}: launches {r['launches_by_path']}, "
                                 "expected all on hopper_f32")

    check_run("one process", one)
    s_params = {k: v.detach().cpu() for k, v in single["state"].params_state_dict().items()}
    s_losses = read_metrics(single["log_dir"])["train_loss_step"]
    s_hist = {k: single[k] for k in ("train_l2_step", "train_l2_full", "test_l2_steps",
                                     "test_l2_fulls")}
    s_keys = list(torch.load(Path(single["log_dir"]) / "model" / "model.pth",
                             weights_only=False)["model"])
    worst: dict = {}
    for r in ranks:
        if (r["world"], r["backend"], r["wrapper"]) != (2, "gloo", "DistributedDataParallel"):
            raise AssertionError(f"ddp_cdpot rank {r['rank']}: {r['world']} ranks, "
                                 f"{r['backend']}, {r['wrapper']}")
        check_run(f"rank {r['rank']}", r)
        # every rank's own metrics and weights; rank 0's log for the per-step losses
        rels = [abs(r["history"][k] - s_hist[k]) / abs(s_hist[k])
                for k in ("train_l2_step", "train_l2_full")]
        rels += [abs(a - c) / abs(c) for k in ("test_l2_steps", "test_l2_fulls")
                 for a, c in zip(r["history"][k], s_hist[k], strict=True)]
        w = {k: rel_l2(r["params"][k].cpu(), v) for k, v in s_params.items()}
        d = dict(metric_rel=max(rels),
                 step_loss_rel=max_rel(read_metrics(ranks[0]["log_dir"])["train_loss_step"],
                                       s_losses),
                 weight=max(w, key=w.get), weight_rel_l2=max(w.values()))
        worst[r["rank"]] = d
    nccl_rel = max(abs(nccl["history"][k] - s_hist[k]) / abs(s_hist[k])
                   for k in ("train_l2_step", "train_l2_full"))
    # the replicas bit for bit over the 2 ranks, and the control caught
    replicas = [r["replicas"] for r in ranks]
    if any(not rep["compared"] or not rep["control"] for rep in replicas):
        raise AssertionError(f"ddp_cdpot replica check: {replicas}")
    log("ddp_cdpot_against_one_process", ranks=worst, nccl_rel=nccl_rel, limit=DDP_TOL,
        replicas=replicas)
    for r in ranks:
        d = worst[r["rank"]]
        if list(r["params"]) != list(s_params) or not all(
                d[k] <= DDP_TOL for k in ("metric_rel", "step_loss_rel", "weight_rel_l2")):
            raise AssertionError(f"ddp_cdpot rank {r['rank']} against one process: {d} "
                                 f"(limit {DDP_TOL})")
    runs_written = sorted(p.name for p in (RUN_DIR / "ddp_2").iterdir() if p.is_dir())
    ckpt = Path(ranks[0]["log_dir"]) / "model"
    keys = list(torch.load(ckpt / "model.pth", weights_only=False)["model"])
    if ranks[1]["log_dir"] is not None or len(runs_written) != 1 or keys != s_keys:
        raise AssertionError(f"ddp_cdpot checkpoint: rank 1 log {ranks[1]['log_dir']}, runs "
                             f"{runs_written}, keys like one process's: {keys == s_keys}")

    first_evals = sweep_applications(specs[:1], doc["data_weights"][:1], batch,
                                     DDP_CDPOT["epochs"])[1]
    check_run("nccl rank", nccl, depth * (steps + first_evals))
    if nccl["backend"] != "nccl" or not nccl_rel <= DDP_TOL:
        raise AssertionError(f"ddp_cdpot nccl rank: backend {nccl['backend']}, rel "
                             f"{nccl_rel} against one process")

    reset_launch_counts()
    httpd, rs = serve_main(["--config_from_ckpt", "true", "--resume_path", str(ckpt),
                            "--train_paths", *names, "--n_channels", "4", "--dtype", "float32",
                            "--port", "0", "--device", "cuda"], wait=False)
    try:
        sent = send_requests(httpd.server_address[1], (1,), "float32", seed=11)
        applications = warmup_applications(rs) + sum(r["steps"] for r in sent)
        torch.cuda.synchronize()
        serve = dict(launches=fused_gn_afno.launches,
                     launches_by_path=dict(fused_gn_afno.launches_by_path),
                     bias_act_launches=bias_act.launches, applications=applications)
        if serve["launches"] != depth * applications:
            raise AssertionError(f"ddp_cdpot serve: {serve['launches']} launches, expected "
                                 f"depth x applications = {depth * applications}")
        check_paths("float32", serve["launches"], "hopper_f32")
        if not all(np.isfinite(r["pred"]).all() for r in sent):
            raise AssertionError("ddp_cdpot serve: answers not finite")
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()

    runs = [one, *ranks, nccl, serve]
    return dict(dtype="float32", global_batch=batch, steps=steps, train_applications=steps,
                eval_applications=eval_apps, launches_per_rank=[r["launches"] for r in ranks],
                launches=sum(r["launches"] for r in runs),
                launches_by_path={p: sum(r["launches_by_path"][p] for r in runs)
                                  for p in afno_fused.PATHS},
                bias_act_launches=sum(r["bias_act_launches"] for r in runs),
                limit=DDP_TOL, against_one_process=worst, nccl_rel=nccl_rel,
                one_process_run_s=one["run_s"], rank_run_s=[r["run_s"] for r in ranks],
                rank_loop_step_s=[statistics.median(r["loop_step_s"]) for r in ranks],
                one_process_profile=one["profile"],
                rank_profiles={r["rank"]: r["profile"] for r in ranks},
                launch_s={"2 ranks": [r["launch_s"] for r in ranks], "nccl": nccl["launch_s"]},
                job_s={"2 ranks": [r["job_s"] for r in ranks], "nccl": nccl["job_s"]},
                checkpoint_keys=len(keys), runs_written=runs_written,
                served_requests=len(sent))


def one_process_steps(job: str, model, path: Path) -> dict:
    """FSDP_L's steps of a layout job's model (seeded, on the card) in one
    process, eagerly, on the job's global batches (with the job's working
    copy): the first forward's prediction, the losses, walls, launches and
    peak memory; the first step's gradient, the parameter change after the
    steps and a model's running statistics saved to `path` (on the host,
    f32), which the layout ranks are held to."""
    spec = job_spec(job)
    model.remat = spec["remat"]
    state = fsdp_l_state(model, spec["lp"])
    step_fn = job_step(job)
    model.eval()
    with torch.no_grad():  # the layouts' first predictions are held to it
        out = model(job_batch(job, 0)["x"])
        pred0 = (out[0] if isinstance(out, tuple) else out).float().cpu()
    before = {n: p.detach().to("cpu", torch.float32, copy=True)
              for n, p in master_of(state).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, walls = [], []
    for i in range(FSDP_L["steps"]):
        b = job_batch(job, i)
        t0 = time.perf_counter()
        losses.append(float(step_fn(state, b)[1]["loss_step"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grad = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                    if p.grad is not None}
    torch.cuda.synchronize()
    one = dict(losses=losses, wall_ms_each=walls, launches=fused_gn_afno.launches,
               launches_by_path=dict(fused_gn_afno.launches_by_path),
               bias_act_launches=bias_act.launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, pred0=pred0,
               blocks=len(getattr(model, "blocks", ())))
    delta = {n: p.detach().float().cpu() - before[n] for n, p in master_of(state).items()}
    ref = {"grad": grad, "delta": delta}
    if any(True for _ in model.buffers()):
        ref["stats"] = {n: b.float().cpu() for n, b in stats_of(model).items()}
    torch.save(ref, path)
    del model, state, b
    torch.cuda.empty_cache()
    return one


def fsdp_l_single() -> dict:
    """FSDP_L's steps of seeded DPOT-L (bf16) in one process
    (`one_process_steps`): fsdp_l's, tp_l's and pp_l's reference."""
    return one_process_steps("tp_l", preset_model("L", "bfloat16", FSDP_L["seed"]),
                             LAYOUT_REFS["tp_l"])


def sp_l_single() -> dict:
    """FSDP_L's steps of the seeded DPOT-L in f32 in one process on the
    single-device FFT route (`fft_route`): sp_l's reference; no kernel
    launches."""
    model = preset_model("L", "float32", FSDP_L["seed"])
    with fft_route():
        return one_process_steps("sp_l", model, LAYOUT_REFS["sp_l"])


def ref_job(job: str) -> str:
    """The job whose one-process run is `job`'s reference: the first with
    its reference file (LAYOUT_REFS)."""
    return next(j for j, path in LAYOUT_REFS.items() if path == LAYOUT_REFS[job])


def more_layouts_single() -> dict:
    """The one-process references of phase 28's layout jobs (LAYOUT_JOBS after
    sp_l), one run for each reference file."""
    return {job: one_process_steps(job, job_model(job, "cuda"), LAYOUT_REFS[job])
            for job in LAYOUT_JOBS if ref_job(job) == job and job not in ("tp_l", "sp_l")}


def tp_serve_l_single() -> dict:
    """tp_serve_l's requests to the seeded DPOT-L (bf16) served in one
    process, graphed and eager (`_graphed` off): answers, walls, launches."""
    from dpot_tpu_torch.serve.server import RolloutServer

    model = preset_model("L", "bfloat16", FSDP_L["seed"])
    out = {}
    for graphed in (True, False):
        rs = RolloutServer(model, device="cuda", batch_buckets=LAYOUT_L["serve_batches"],
                           max_wait_ms=1.0, warmup_steps=(LAYOUT_L["serve_steps"],))
        rs._graphed = graphed
        reset_launch_counts()
        rs.start()
        try:
            out["graphed" if graphed else "eager"] = dict(
                serve_l_requests(rs), launches=fused_gn_afno.launches,
                launches_by_path=dict(fused_gn_afno.launches_by_path),
                bias_act_launches=bias_act.launches)
        finally:
            rs.stop(drain=True)
    del model
    torch.cuda.empty_cache()
    return out


def expected_launches(job: str) -> int:
    """A layout rank's fused-kernel launches over FSDP_L's steps: depth x
    applications (twice under remat; a stage's blocks, each microbatch);
    none on the spatial route, for DPOT3D or UNet."""
    spec, steps = job_spec(job), FSDP_L["steps"]
    if spec["model"] == "CDPOT":
        return steps * cdpot_sweep_model_kw()["depth"]
    if spec["model"] != "L" or spec["cfg"].get("mesh_spatial", 1) > 1:
        return 0
    depth = spec["depth"] or DPOT_L["depth"]
    pipe = spec["cfg"].get("mesh_pipe", 1)
    micro = LAYOUT_L["micro"] if pipe > 1 else 1
    return 2 * steps * micro * depth // pipe


def rank_part(want: torch.Tensor, got: torch.Tensor, coords: dict, mesh: dict) -> torch.Tensor:
    """The rows of one process's prediction that a rank's covers: its part
    of the batch over 'data', its H rows over 'spatial'."""
    B, H = got.shape[0], got.shape[1]
    if mesh.get("data", 1) > 1:
        want = want[coords["data"] * B:(coords["data"] + 1) * B]
    if mesh.get("spatial", 1) > 1:
        want = want[:, coords["spatial"] * H:(coords["spatial"] + 1) * H]
    return want


def resume_checks(job: str, ranks: list) -> dict:
    """fsdp_lp_l's checkpoint, written by the 2 FSDP2 ranks over gloo,
    resumed by one process: its forward of the first batch against the
    ranks' after the steps (relative L2), one more step's loss against
    theirs; the control checkpoint's forward (its shards gathered in the
    wrong order). The files are removed."""
    from dpot_tpu_torch.train.checkpoint import restore_checkpoint

    spec = job_spec(job)
    ck = ranks[0]["ckpt"]
    out = {}
    for tag in ("good", "bad"):
        model = job_model(job, "cuda")
        state = fsdp_l_state(model, spec["lp"])
        restore_checkpoint(ck[tag], state)
        model.eval()
        with torch.no_grad():
            pred = model(job_batch(job, 0)["x"])[0].float().cpu()
        rel = rel_l2(rank_part(pred, ck["pred_after"], ranks[0]["coords"], ranks[0]["mesh"]),
                     ck["pred_after"]) if tag == "good" else None
        if tag == "good":
            out["resume"] = rel
            out["step"] = state.step
            loss = float(job_step(job)(state, job_batch(job, FSDP_L["steps"]))[1]["loss_step"])
            out["next_loss_rel"] = abs(loss - ck["next_loss"]) / abs(ck["next_loss"])
        else:
            out["control"] = rel_l2(rank_part(pred, ck["pred_after"], ranks[0]["coords"],
                                              ranks[0]["mesh"]), ck["pred_after"])
        del model, state
        torch.cuda.empty_cache()
        shutil.rmtree(ck[tag], ignore_errors=True)
    out["save_s"] = [r["ckpt"]["save_s"] for r in ranks]
    # the asynchronous save: rank 0's stall in the call against the write
    ck0 = ranks[0]["ckpt"]
    if [w["thread"] for w in ck0["writes"]] != ["checkpoint-writer"] or any(
            r["ckpt"]["writes"] for r in ranks[1:]):
        raise AssertionError(f"{job}: the checkpoint writes {[r['ckpt']['writes'] for r in ranks]}")
    out["async"] = dict(call_s=[r["ckpt"]["async_call_s"] for r in ranks],
                        write_s=ck0["writes"][0]["write_s"], wait_s=ck0["async_wait_s"])
    return out


def layout_checks(ones: dict, serve_one: dict, pair: list) -> dict:
    """The layout jobs (LAYOUT_JOBS) and the served ones on 2 ranks sharing
    the card (gloo with CUDA tensors) against one process (`ones`, by the
    job whose reference each shares, `ref_job`; their first predictions
    under "pred0"): each rank's readings within LAYOUT_TOL[job] (the
    losses, the first prediction, the first step's gradient, the parameter
    change and a model's running statistics) and each control above the
    limit of the reading it spoils; each rank's launches exact
    (`expected_launches`), on the job's route (afno_hopper_l.cu for L; the
    route CDPOT's TP rank takes is reported); fsdp_lp_l's checkpoint
    resumed by one process (`resume_checks`); tp_serve_l's, serve_pp_l's
    and serve_dp_l's answers within "serve_tol" of one process's graphed
    answers, their controls above it, each rank's launches depth x
    applications on hopper_l (a stage's blocks x each application's
    microbatches), and serve_dp_l's replicas
    computing what the leader computes. Logs a row per job, then raises if
    any check failed; returns the rows."""
    depth = DPOT_L["depth"]
    rows, bad = {}, []
    for job in LAYOUT_JOBS:
        spec = job_spec(job)
        one = ones[ref_job(job)]
        ranks = [r[job] for r in pair]
        tol = LAYOUT_TOL[job]
        want = expected_launches(job)
        for r in ranks:
            ref = rank_part(one["pred0"], r["pred"], r["coords"], r["mesh"])
            r["readings"] = dict(
                loss=max(abs(a - c) / abs(c) for a, c in zip(r["losses"], one["losses"],
                                                            strict=True)),
                pred=rel_l2(r.pop("pred"), ref), grad=r["grad"]["rel_l2"],
                delta=r["delta"]["rel_l2"])
            if "stats" in r:
                r["readings"]["stats"] = r["stats"]["rel_l2"]
            r["controls"] = {name: dict(check=check, limit=tol[check],
                                        rel_l2=rel_l2(v, ref) if check == "pred"
                                        else v["rel_l2"])
                             for name, (check, v) in r["controls"].items()}
            over = {k: v for k, v in r["readings"].items() if not v <= tol[k]}
            if over:
                bad.append(f"{job} {r['coords']}: {over} over {tol}")
            caught = [c for c in r["controls"].values() if not c["rel_l2"] > c["limit"]]
            if caught:
                bad.append(f"{job} {r['coords']}: controls not above their limit: {caught}")
            route = spec["route"]
            if (r["launches"] != want or r["separable_calls"]
                    or route and r["launches_by_path"].get(route, 0) != want):
                bad.append(f"{job} {r['coords']}: launches {r['launches_by_path']}, separable "
                           f"{r['separable_calls']}, expected {want} on {route or 'any route'}")
            blocks = (spec["depth"] or depth) // spec["cfg"].get("mesh_pipe", 1)
            if spec["model"] == "L" and r["blocks"] != blocks:
                bad.append(f"{job} {r['coords']}: {r['blocks']} blocks, expected {blocks}")
            if spec["cfg"].get("shard_params") == "tp" and spec["model"] != "UNet" and (
                    not r["tp_leaves"] or r["local_w1"][1] * 2 != (
                        16 if spec["model"] in ("L", "DPOT3D")
                        else cdpot_sweep_model_kw()["n_blocks"])):
                bad.append(f"{job} {r['coords']}: TP leaves {r['tp_leaves']}, w1 {r['local_w1']}")
        rows[job] = layout_row(ranks, one, tol)
        if spec["faults"] == "ckpt":
            res = resume_checks(job, ranks)
            rows[job]["resume"] = res
            if not (res["resume"] <= tol["resume"] and res["control"] > tol["resume"]
                    and res["next_loss_rel"] <= tol["loss"] and res["step"] == FSDP_L["steps"]):
                bad.append(f"{job}: the checkpoint resumed by one process {res} against "
                           f"{tol}")
    from dpot_tpu_torch.parallel.pipeline import micro_count

    graphed = serve_one["graphed"]
    # applications: the warm-up at the largest bucket, then a request of
    # each bucket; under the pipeline each runs micro_count microbatches
    buckets = LAYOUT_L["serve_batches"][-1:] + LAYOUT_L["serve_batches"]
    apps = LAYOUT_L["serve_steps"] * len(buckets)
    micro = LAYOUT_L["serve_steps"] * sum(micro_count(B, 2) for B in buckets)
    for job, blocks in (("tp_serve_l", depth * apps), ("serve_pp_l", depth // 2 * micro),
                        ("serve_dp_l", depth * apps)):
        ranks = [r[job] for r in pair]
        leader = next(r for r in ranks if r["leader"])
        errs = [rel_l2(torch.from_numpy(a), torch.from_numpy(b))
                for a, b in zip(leader["answers"], graphed["answers"], strict=True)]
        row = dict(dtype="bfloat16", world=2, batches=LAYOUT_L["serve_batches"],
                   steps=LAYOUT_L["serve_steps"], limit=LAYOUT_L["serve_tol"], rel_l2=errs,
                   applications=apps, launches_per_rank=[r["launches"] for r in ranks],
                   launches=sum(r["launches"] for r in ranks),
                   launches_by_path={p: sum(r["launches_by_path"][p] for r in ranks)
                                     for p in afno_fused.PATHS},
                   bias_act_launches=sum(r["bias_act_launches"] for r in ranks),
                   job_s=[r["job_s"] for r in ranks],
                   ms_per_application=[ms / LAYOUT_L["serve_steps"]
                                       for ms in leader["request_ms"]])
        for r in ranks:
            want = blocks
            if r["launches"] != want or r["launches_by_path"]["hopper_l"] != want:
                bad.append(f"{job} launches {r['launches_by_path']}, expected {want} on "
                           "hopper_l")
        if not max(errs) <= LAYOUT_L["serve_tol"] or not all(
                np.isfinite(a).all() for a in leader["answers"]):
            bad.append(f"{job} answers against one process's: rel {errs}")
        if job == "serve_pp_l":
            row["control"] = rel_l2(torch.from_numpy(leader["control_answer"]),
                                    torch.from_numpy(graphed["answers"][0]))
            if not row["control"] > LAYOUT_L["serve_tol"]:
                bad.append(f"{job}: the wrong permute's answer {row['control']} not above "
                           f"{LAYOUT_L['serve_tol']}")
        if job == "serve_dp_l":
            follower = next(r for r in ranks if not r["leader"])
            n = len(leader["computed"])
            row["replicas"] = [rel_l2(follower["computed"][i], leader["computed"][i])
                               for i in range(n - 1)]
            row["control"] = rel_l2(follower["computed"][-1], leader["computed"][-1])
            row["replica_limit"] = SERVE_REPLICA_TOL
            if not (max(row["replicas"]) <= SERVE_REPLICA_TOL
                    and row["control"] > SERVE_REPLICA_TOL):
                bad.append(f"{job}: replicas {row['replicas']}, control {row['control']} "
                           f"against {SERVE_REPLICA_TOL}")
        if job == "tp_serve_l":
            row["ms_per_application"] = {
                k: [ms / LAYOUT_L["serve_steps"] for ms in v["request_ms"]]
                for k, v in (("tp", leader), ("one_process_graphed", graphed),
                             ("one_process_eager", serve_one["eager"]))}
            row["launches"] += sum(v["launches"] for v in serve_one.values())
            for p in afno_fused.PATHS:
                row["launches_by_path"][p] += sum(v["launches_by_path"][p]
                                                  for v in serve_one.values())
        rows[job] = row
    for job, row in rows.items():
        log(job, **row)
    if bad:
        raise AssertionError("parallel layouts: " + "; ".join(bad))
    return rows


def layout_row(ranks: list, one: dict, limits: dict) -> dict:
    """A layout job's row: each rank's readings against one process and its
    controls', the step walls, the collectives' share and the peak memory
    per rank beside one process's."""
    return dict(
        dtype=ranks[0]["dtype"], world=2, mesh=ranks[0]["mesh"],
        steps=FSDP_L["steps"], limits=limits, one_process_losses=one["losses"],
        rank_losses=[r["losses"] for r in ranks],
        readings=[r["readings"] for r in ranks], controls=[r["controls"] for r in ranks],
        worst_leaf={k: [dict(leaf=r[k]["worst"], rel_l2=r[k]["worst_rel_l2"],
                             leaves=r[k]["leaves"]) for r in ranks] for k in ("grad", "delta")},
        step_wall_ms=[r["wall_ms_each"] for r in ranks],
        one_process_wall_ms=one["wall_ms_each"],
        rank_profiles=[r["profile"] for r in ranks],
        rank_peak_memory_gb=[r["peak_memory_gb"] for r in ranks],
        one_process_peak_memory_gb=one["peak_memory_gb"],
        launches_per_rank=[r["launches"] for r in ranks],
        launches=sum(r["launches"] for r in ranks),
        launches_by_path={p: sum(r["launches_by_path"][p] for r in ranks)
                          for p in afno_fused.PATHS},
        bias_act_launches=sum(r["bias_act_launches"] for r in ranks),
        local_w1=ranks[0]["local_w1"], blocks_per_rank=ranks[0]["blocks"],
        sharded=ranks[0]["sharded"], working_copy=ranks[0]["working_copy"],
        tp_leaves=ranks[0]["tp_leaves"], build_s=[r["build_s"] for r in ranks],
        job_s=[r["job_s"] for r in ranks])


def layout_references() -> tuple[dict, dict]:
    """One process's references of every layout job (by `ref_job`) and
    tp_serve_l's one-process answers."""
    ones = {"tp_l": fsdp_l_single(), "sp_l": sp_l_single(), **more_layouts_single()}
    return ones, tp_serve_l_single()


def phase_layouts_alone() -> dict:
    """The layout jobs alone (`python3 chip_smoke.py layouts`): the kernels
    built, one process's references, then one 2-rank gloo launch of the
    layout and serving jobs, and layout_checks."""
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    launch = Launch(2, "layouts", dict(device="cuda:0", init=True, backend="gloo",
                                       layouts=layout_args()), "layouts_2", hold=True)
    try:
        t0 = time.perf_counter()
        ones, serve_one = layout_references()
        log("layout_references", seconds=time.perf_counter() - t0,
            ones={k: {n: v for n, v in o.items() if n != "pred0"} for k, o in ones.items()})
        launch.go()
        t0 = time.perf_counter()
        pair = launch.finish()
        log("layout_launch", seconds=time.perf_counter() - t0,
            launch_s=[r["launch_s"] for r in pair])
    finally:
        launch.kill()
    return layout_checks(ones, serve_one, pair)


def fsdp_l_checks(one: dict, ranks: list) -> dict:
    """fsdp_l on 2 ranks under FSDP2 (gloo with CUDA tensors, the one card)
    against one process: every parameter and moment sharded, each loss
    within FSDP_L["tol"] of one process's, the blocks that the kernel read
    equal to a fresh conversion of the gathered weights bit for bit, each
    of those weights marked uncached, at every call of every step, and not
    equal in the control's forwards; each rank's launches 2 x depth a step
    (remat) and depth a control forward, all on afno_hopper_l.cu; each
    rank's peak memory against one process's, and the collectives' time.
    Two ranks share the one card only through gloo, whose CUDA collectives
    carry FSDP2's all-gathers and reduce-scatters (not DTensor's
    full_tensor: tools/gloo_cuda_collectives.py), so the check reads the
    weights FSDP2 gathered inside the call. Returns the row."""
    depth = DPOT_L["depth"]
    want = 2 * depth * FSDP_L["steps"] + depth * FSDP_L["control"]
    for r in ranks:
        main_steps = r["steps"][:FSDP_L["steps"]]
        control = r["steps"][FSDP_L["steps"]:]
        rels = [abs(s["loss"] - c) / abs(c) for s, c in zip(main_steps, one["losses"])]
        bad = [s for s in main_steps
               if s["mismatched"] or s["left_to_cache"] or s["checked"] != 2 * depth]
        if r["unsharded"] or r["afno_modules"] != depth or bad:
            raise AssertionError(f"fsdp_l rank {r['rank']}: unsharded {r['unsharded'][:4]}, "
                                 f"{r['afno_modules']} AFNO modules, steps whose blocks differ "
                                 f"from the gathered weights or were left to the cache {bad}")
        if not max(rels) <= FSDP_L["tol"]:
            raise AssertionError(f"fsdp_l rank {r['rank']} losses {main_steps} against one "
                                 f"process's {one['losses']}: rel {rels}")
        if not all(s["mismatched"] for s in control):
            raise AssertionError(f"fsdp_l rank {r['rank']}: the stale control was not "
                                 f"caught: {control}")
        if r["launches"] != want or r["launches_by_path"]["hopper_l"] != r["launches"]:
            raise AssertionError(f"fsdp_l rank {r['rank']}: launches {r['launches_by_path']},"
                                 f" expected {want} on hopper_l")
    return dict(dtype="bfloat16", world=2, backend="gloo", global_batch=L_BATCH,
                steps=FSDP_L["steps"], control_forwards=FSDP_L["control"],
                limit=FSDP_L["tol"], one_process=one,
                loss_rel=[abs(s["loss"] - c) / abs(c)
                          for s, c in zip(ranks[0]["steps"], one["losses"])],
                rank_steps={r["rank"]: r["steps"] for r in ranks},
                rank_peak_memory_gb=[r["peak_memory_gb"] for r in ranks],
                rank_carried_gb=[r["carried_gb"] for r in ranks],
                one_process_peak_memory_gb=one["peak_memory_gb"],
                rank_profiles={r["rank"]: r["profile"] for r in ranks},
                job_s=[r["job_s"] for r in ranks],
                launches_per_rank=[r["launches"] for r in ranks],
                launches=one["launches"] + sum(r["launches"] for r in ranks),
                launches_by_path={p: one["launches_by_path"][p]
                                  + sum(r["launches_by_path"][p] for r in ranks)
                                  for p in afno_fused.PATHS},
                bias_act_launches=one["bias_act_launches"]
                + sum(r["bias_act_launches"] for r in ranks))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["rank"]:  # a rank of a multi-process phase, under torchrun
        return rank_main(*sys.argv[2:4])
    token = f"{os.getpid()}-{time.time_ns()}"
    os.environ[RUN_TOKEN] = token
    try:
        kernels = smoke()
    except BaseException:
        left = end_leftovers(token)
        if left["found"]:
            print(f"chip_smoke: ended the run's processes {left}", file=sys.stderr, flush=True)
        raise
    left = end_leftovers(token)
    log("teardown", **left)
    if left["still_alive"]:
        raise AssertionError(f"processes of this run outlived SIGKILL: {left}")
    if kernels is None:  # the layout jobs alone
        return 0
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def smoke() -> list | None:
    """Every phase; the kernels line's rows (None for `layouts`)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    log("build", seconds=time.perf_counter() - t0, nvcc_s=dict(build.build_seconds),
        libraries=[p.name for p in build.library_paths().values()],
        torch=torch.__version__, cuda=torch.version.cuda)
    if sys.argv[1:2] == ["layouts"]:  # this slice's layout jobs alone
        phase_layouts_alone()
        return None

    k = phase_kernels()
    vjp = phase_vjp()
    ba = phase_bias_act()
    serve_bf16 = phase_serve("bfloat16", "float32")
    serve_f32 = phase_serve("float32", "float16")
    for dtype in ("bfloat16", "float32"):
        phase_step(dtype)
    loader = phase_loader_ti()
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    train = {dtype: phase_train(dtype) for dtype in ("float32", "bfloat16")}
    dispatch_ti = phase_dispatch_ti()
    train_afno, eval_afno = phase_afno_single()
    m_grids = phase_pretrain_m_grids()
    shutil.rmtree(RUN_DIR)
    phase_train_card_vs_cpu()
    serve_h, model_h = phase_serve_h()
    phase_step("bfloat16", model=model_h, preset="H")
    train_h = phase_train_h(model_h)
    del model_h
    torch.cuda.empty_cache()
    # f32 DPOT-H, the serve CLI's default, drawn once the bf16 model is freed
    serve_h32, model_h = phase_serve_h("float32")
    phase_step("float32", model=model_h, preset="H")
    del model_h
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    ddp, fsdp, layouts = phase_parallel()
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
    bf16_runs = {"serve[bfloat16]": serve_bf16, "loader_ti": loader,
                 "train[bfloat16]": train["bfloat16"],
                 "dispatch_ti": dispatch_ti, "rollouts": rollouts, "stale_weights": stale,
                 "finetune_s": finetune_s, "varyres_ti": varyres,
                 "convert_resume_serve": convert, "finetune3d_l": finetune3d,
                 "separable_ti[bfloat16]": separable["bfloat16"], "serve_cdpot": serve_cdpot}
    f32_runs = {"serve[float32]": serve_f32, "train[float32]": train["float32"],
                "card_vs_cpu_3d": cpu_3d, "separable_ti[float32]": separable["float32"],
                "train_cdpot": train_cdpot, "card_vs_cpu_families": families,
                "ddp_cdpot": ddp, "cdpot_tp": layouts["cdpot_tp"]}
    l_runs = {"eval_l[bfloat16]": eval_l["bfloat16"], "rollouts": rollouts,
              "train_l": train_l, "remat_l": remat_l, "dispatch_l": dispatch_l,
              "params_lp_l": params_lp_l, "fsdp_l": fsdp,
              **{job: layouts[job] for job in ("tp_l", "pp_l", "tp_serve_l", "fsdp_lp_l",
                                               "tp_lp_l", "pp_lp_l", "fsdp_pp_l", "serve_pp_l",
                                               "serve_dp_l")}}
    # (name, kernel-phase key prefixes of the shapes its main path gives it,
    # the first the one whose times the row carries, dtype, path, source,
    # the runs whose launches count)
    rows = (("fused_gn_afno[bf16,hopper]", ("", "S/"), "bfloat16", "hopper", "afno_hopper.cu",
             bf16_runs),
            ("fused_gn_afno[bf16,hopper_wide]", ("H/",), "bfloat16", "hopper_wide",
             "afno_hopper_wide.cu", {"serve_h": serve_h, "train_h": train_h}),
            ("fused_gn_afno[bf16,hopper_l]", ("L/", "LTP/"), "bfloat16", "hopper_l",
             "afno_hopper_l.cu", l_runs),
            ("fused_gn_afno[bf16,hopper_pairs]", ("A/",), "bfloat16", "hopper_pairs",
             "afno_hopper.cu", {"eval_afno_single[bfloat16]": eval_afno}),
            ("fused_gn_afno[bf16,hopper_stream]", ("M256/", "M64/", "L256/", *RAGGED),
             "bfloat16", "hopper_stream", "afno_hopper_stream.cu",
             {"pretrain_m_grids": m_grids}),
            ("fused_gn_afno[bf16,general]", ("L/",), "bfloat16", "general", "afno_fused.cu",
             {**l_runs, **bf16_runs, "eval_afno_single[bfloat16]": eval_afno,
              "pretrain_m_grids": m_grids}),
            ("fused_gn_afno[f32,hopper]", ("", *RAGGED), "float32", "hopper_f32",
             "afno_hopper_f32.cu",
             {**f32_runs, "pretrain_m_grids[f32 first steps]": m_grids["f32_first_steps"]}),
            ("fused_gn_afno[f32,hopper_l]", ("L/", "L96/"), "float32", "hopper_f32_l",
             "afno_hopper_f32_l.cu", {"eval_l[float32]": eval_l["float32"]}),
            ("fused_gn_afno[f32,hopper_f32_wide]", ("H/", "H96/"), "float32", "hopper_f32_wide",
             "afno_hopper_f32_wide.cu", {"serve_h[float32]": serve_h32}),
            ("fused_gn_afno[f32,hopper_pairs]", ("A/",), "float32", "hopper_f32_pairs",
             "afno_hopper_f32.cu", {"train_afno_single": train_afno}),
            ("fused_gn_afno[f32,general]", ("L/",), "float32", "general", "afno_fused.cu",
             {"eval_l[float32]": eval_l["float32"], "serve_h[float32]": serve_h32,
              "train_afno_single": train_afno, **f32_runs}))
    for name, prefixes, dtype, path, src, runs in rows:
        prefix = prefixes[0]
        # the row's times at the batch of the shapes' main path: L's
        # pretraining in bf16, the AFNO baseline's and M's batch, else 8
        B_row = {"A/": AFNO_BATCH, "M256/": M_BATCH}.get(
            prefix, L_BATCH if L_BATCH in batches(prefix, dtype) else 8)
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
        if "LTP/" in prefixes:  # a TP rank's shapes: C = 768, 8 blocks, 4 groups
            kernels[-1]["by_batch_at_l_tp"] = by_batch("LTP/", dtype, path)
        if "M64/" in prefixes or path == "general" and dtype == "bfloat16":
            # M's 8^2 and L's 32^2 latents beside M's 32^2
            kernels[-1]["by_batch_at_m64"] = by_batch("M64/", dtype, path)
            kernels[-1]["by_batch_at_m256"] = by_batch("M256/", dtype, path)
            kernels[-1]["by_batch_at_l256"] = by_batch("L256/", dtype, path)
        if "M96/" in prefixes or path == "general":
            # the ragged latents: M's 12^2, 9^2, 20^2 and 4^2
            for prefix in RAGGED:
                kernels[-1][f"by_batch_at_{prefix[:-1].lower()}"] = by_batch(prefix, dtype, path)
        controls = {key: v for key, v in k.items() if "padded_control" in key
                    and v["path"] == path}
        if controls:  # an entry in the padded operators, which the checks caught
            kernels[-1]["padded_control"] = controls
        if path == "hopper_l":  # the walk's last chunk left out, which the checks caught
            kernels[-1]["walk_control"] = {key: v for key, v in k.items()
                                           if "/walk_control/" in key}
        for prefix in ("L96/", "H96/"):  # L's and H's blocks at 12^2, f32
            if prefix in prefixes or path == "general" and dtype == "float32":
                kernels[-1][f"by_batch_at_{prefix[:-1].lower()}"] = by_batch(prefix, dtype, path)
        if path == "general":  # forced on at the L, Ti, S, H and 64-channel shapes
            kernels[-1]["by_batch_at_ti"] = by_batch("", dtype, path)
            kernels[-1]["by_batch_at_h"] = by_batch("H/", dtype, path)
            kernels[-1]["by_batch_at_afno_single"] = by_batch("A/", dtype, path)
            if dtype == "bfloat16":
                kernels[-1]["by_batch_at_s"] = by_batch("S/", dtype, path)
    # bias_act's one caller is filtered_lrelu (the kernel phase's check); no
    # model path calls it, which the count over the other runs shows
    other_launches = sum(r["bias_act_launches"] for r in (
        serve_bf16, serve_f32, loader, *train.values(), dispatch_ti, train_afno, eval_afno,
        m_grids,
        serve_h, train_h, serve_h32,
        *eval_l.values(), rollouts, stale, train_l, dispatch_l, finetune_s, finetune3d,
        cpu_3d, *separable.values(), train_cdpot, serve_cdpot, families, ddp, fsdp,
        *layouts.values()))
    flr = ba["filtered_lrelu"]["rows"]
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        r = ba[f"{dtype}/lrelu"]
        path_rows = {k: v for k, v in flr.items() if k.startswith(dtype)}
        launches = sum(v["launches"] for v in path_rows.values())
        if not launches:
            raise AssertionError(f"bias_act {dtype}: no launch on filtered_lrelu's path")
        kernels.append(dict(
            name=f"bias_act[{short},lrelu]", route="cuda",
            source="dpot_tpu_torch/csrc/bias_act.cu",
            replaces="dpot_tpu/ops/pallas/bias_act_kernel.py:47",
            launches=launches,
            max_abs_err=max(v["max_abs_err"] for key, v in ba.items()
                            if key.startswith(dtype)),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            phase="filtered_lrelu (ops/upfirdn2d.py), in the kernel phase", shapes=r["shape"],
            check="pass", device_ms=r["device_ms"], other_phases_launches=other_launches,
            filtered_lrelu={k.split("/")[1]: {key: v[key] for key in (
                "launches", "ms", "plain_ms", "device_ms", "bias_act_shape",
                "bias_act_device_ms", "bias_act_bound_ms", "max_abs_err", "grad_rel_l2")}
                for k, v in path_rows.items()},
        ))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
