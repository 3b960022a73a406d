#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build the hand-written kernels of ``upflow_pytorch_tpu_torch/csrc/``
   (nvcc, sm_90a) and print the build time and ptxas' register counts.
2. Hold every kernel against its plain PyTorch version on the card, at the
   shapes of the main path (B=4, 384x1280: every decode level, the SGU
   stages and the occlusion warp), and time kernel, plain version and,
   where one exists, the PyTorch library call that computes the same
   function.  The SGU kernels are held at inter-flows of every TPU tier's
   magnitude and beyond, the image warp also at the magnitudes of the
   TPU's windowed planar warp.  The bf16 path's kernels are held at bf16:
   ``conv3x3_seg`` at every distinct conv shape of a bf16 forward (and the
   ragged shapes of the B=1 375x1242 requests, UPFlow's and RAFT's, each
   also bit for bit against the TMA route on its input zero-extended to
   the pitched width, and timed beside it with the pitched copy's device
   ms), the correlations and the feature warp at bf16 inputs.  The plain
   correlation is held at every decode level of both request sizes (B=4
   384x1280, B=1 375x1242), must give the same bits on a second call, and
   prints its grid and its device ms beside
   ``corr_norm``'s at the same shape; the final SGU stage is held at both
   sizes.  The feature warp is timed at all 18 of its calls in an
   SGU forward (the 8 cost-volume warps and the SGU's 10 warps of the
   32-channel features) and must equal its plain version bit for bit,
   values and mask bits; ``corr_norm`` must also give the same bits on a
   second call.  Both are held at the ragged level shapes of 375x1242
   (B=1) too.  A device time the profiler misses is retried, up to three
   windows, and each reading prints its attempt.  ``conv3x3_seg`` is
   timed as the model calls it (weights packed once) and packing on
   every call, and each shape prints its
   staging route (TMA or pitched), device ms, cuDNN's device ms, its
   bound and the host's share of a call (CUDA-event time beyond device
   time); the image warp prints the same beside ``grid_sample``.  The SGU
   blend runs both directions of a level in one launch from raw heads
   (fp32 and bf16) at decode levels 1-4 of both sizes and three
   inter-flow magnitudes, bit for bit against its plain version, and
   prints device ms, bound and wrapper-inclusive ms per level and per
   forward.  ``python3 chip_smoke.py --kernels`` runs phases 1 and 2
   alone and prints ``conv3x3_seg``'s rows as one JSON line.
3. Serve requests through ``build_model`` / ``forward`` with the
   checkpoint ``assets/synthetic_trained.npz``, on three paths: the eval
   recipe without SGU (slice 1), with SGU (the served configuration), and
   with SGU at bf16.  For each path: count the kernel launches of each
   forward inside ``entry.eager_entry()`` (``conv3x3_seg`` by staging
   route, and its weight packs: none after a model's first forward), then
   hold the kernel path (a request's second and later forwards replay its
   CUDA graph) against the plain path on the card and time both.  Then
   one SGU request under ``torch.set_float32_matmul_precision("high")``
   keeps the SGU bars, and the caller's setting reads the same
   afterwards.  (Phases 5-11 count launches with the entry eager.)
4. Profile one forward of each path at B=4, 384x1280, split its device
   time by kind and count its device kernels.
5. Evaluate against ground truth: ``EvaluationBench`` with the port's
   ``NetEvalModel`` over synthetic pairs with exact flow (B=4 384x1280;
   B=1 375x1242 at native size and padded to multiples of 64), on the
   fp32 and bf16 SGU paths, through the kernels and the plain versions;
   the interior EPE of the kernel paths must be within 0.02 px of the JAX
   package's (``upflow_pytorch_tpu_torch/eval/jax_reference_epe.json``).
6. Train: ``create_train_state`` from the checkpoint with the training
   recipe of the JAX package's ``bench.py`` (photometric, census,
   smoothness, 'upup' distillation, SGU, boundary-dilated warp) and
   ``make_train_step`` on B=4 256x832 crops of 320x896 synthetic pairs,
   at fp32 (one warm-up step and 5 timed) and bf16 (one and 3), each
   under the package's deterministic algorithms.  Every
   step's forward launches every kernel of the path (at bf16 ``conv3x3_
   seg`` included, with one weight pack per kernel-route conv a step, as
   the optimizer's update changes the weights), no plain version runs on
   a CUDA tensor, every loss term is finite and every parameter gets a
   nonzero gradient.  One step's gradient through the kernels is held
   against the same step through the plain versions on the card (mask
   threshold 0.9999; cosine >= 0.9999 at fp32, >= 0.999 at bf16).  It
   prints the step's ms (median and range), one profiled step's device
   time split by kind (forward kernels, backward rules, convolutions,
   optimizer, copies, other) and each kernel op's backward rule, and the
   peak memory.  Then 25 fp32 steps from seeded weights (lr 2e-4) on one
   pair must lower the total loss.
7. The Trainer (``train/trainer.py``), at fp32.  (a) Phase 6's recipe
   from the checkpoint with the equivariance pass (weight 0.1,
   occlusion-masked), B=4 256x832 crops of 8 pairs, two steps an epoch,
   evaluating phase 5's two B=1 375x1242 pairs padded to multiples of 64:
   run A trains to step 2 (one eval line, one checkpoint), run B resumes
   it in a fresh ``Trainer`` (step 2, loader cursor (1, 0)) and trains to
   step 4, run C trains 0 -> 4 in another directory.  B's step 3 must
   equal A's uninterrupted step 3 bit for bit, B's parameters and
   optimizer state after step 4 C's, and A's and B's losses C's at every
   step (the step is deterministic; the cosine of B's parameters with
   C's is printed); every step launches
   the teacher forward's kernels and the student forward's (no occlusion
   warp), every term is finite and the equivariance loss positive, no
   plain version runs on a CUDA tensor.  It prints the step's ms, run C's
   peak memory, the eval line and one profiled step split by kind
   (teacher forward, student forward, backward rules, convolutions, ...).
   (b) C's model exported as a zip and a legacy ``.pth``, each loaded by
   ``Trainer.load_pretrained`` into a fresh model (every key loaded, none
   skipped), serves a B=1 375x1242 request with C's flow; at bf16 the
   first forward after the load packs all 19 kernel-route convs and gives
   the flow of a bf16 model built from C's weights.  (c) The JAX package's
   ``tests/test_synthetic_learning.py`` recipe from seeded weights through
   ``make_train_step``: each kernel of its path is first held against its
   plain version at every call of a forward at the run's shapes (B=4
   64x160, levels 1x3 .. 16x40); then 60 steps must take the EPE against
   the exact flow from above 3x the mean flow to below 1.2 px and below
   0.25x its start.
8. The KITTI and Sintel data path (``scripts/torch_synthetic_trees.py``
   writes KITTI 2015, KITTI 2012, multiview and Sintel trees from seed 0;
   their frames and flows are exact).  (a) Every kernel of the CLI path
   against its plain version under phase 2's bars at the decode-level
   shapes of B=1 376x1241, 370x1224, 374x1238 and 436x1024 and B=4
   384x768 (the three cost-volume kernels also at bf16); ``conv3x3_seg``
   at every bf16 conv shape of those pyramids on its own staging route
   and, where that is TMA, on the pitched route too, each shape's route
   printed, and a bf16 forward at each size launching it as the shapes
   say.  (b) The native PNG decoder's state (``native: built`` and its
   path, or its build error); built, it decodes every PNG of the trees
   as the Python codec does, bit for bit, and both are timed on a
   375x1242 PNG whose rows use filters 1-4.  (c)
   ``scripts/torch_kitti_eval.py`` with a ``.pth`` of the checkpoint on
   the KITTI 2015 tree at native size and padded to multiples of 64
   (EPE-all and EPE-noc within 0.02 px of the JAX package's,
   ``upflow_pytorch_tpu_torch/eval/jax_dataset_reference.json``, EPE-occ
   within 0.1 px, F1 within 0.5 points), the 2012 pair and the 2015 test
   split; launches counted per lane, ms a pair per frame size, every
   ``--save-dir`` PNG equal to its prediction.  (d)
   ``scripts/torch_train_kitti.py`` from the ``.pth`` at B=4: an epoch of
   8 steps ending with an evaluation and a checkpoint, then ``--resume``
   for 2 more; step ms, the loader's share of a step and the device's
   busy share.  (e) ``SintelEvalDataset`` (final pass) through the bench
   against the JAX package's under (c)'s bars, then
   ``scripts/torch_train_sintel.py --crop 384 768 --batch 4``.  (f)
   ``demo.demo()`` on the card.  Each step prints one JSON line.
9. Data parallelism (``parallel/``) on the one card.  (a) A one-rank
   NCCL group on cuda:0 runs phase 6's step from the checkpoint at B=4
   256x832 through ``make_sharded_train_step``, at fp32 and bf16: its
   loss equals ``make_train_step``'s bit for bit, its parameters reach
   cosine >= 0.99999 with the single process's, every kernel of the path
   launches (``conv3x3_seg`` at bf16) and no plain version runs on a CUDA
   tensor; the two steps are then timed in turns and profiled once each.
   (b) Two processes on cuda:0 over gloo (NCCL takes one rank a device),
   each this script with ``--parallel-rank R INIT OUT``, at B=2 each of
   that batch, fp32, at mask threshold 1.0, at 0.9999, and at 0.9999 with
   the equivariance pass (weight 0.1): the global loss within 1e-3
   relative of one process at B=4, and at 0.9999 every loss term within
   1e-5 and the gradient's cosine >= 0.9999; the ranks' losses,
   gradients and parameters equal bit for bit,
   every kernel of the path launched on both; at threshold 1.0 each rank
   runs the two steps a second time from the checkpoint and prints
   whether the losses and parameters equal the first run's (a reading,
   not a gate).  (c)
   ``scripts/torch_train_kitti.py`` in torchrun's one-rank environment
   (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_*) for 2 steps: it joins a NCCL
   group of one, launches every kernel of the path and leaves the group.
   Each step's ms is printed beside phase 6's with the card's name and
   power limit.
10. Width sharding (``parallel/spatial.py``) on the one card.  (a) The
   four warp kernels (``feature_warp`` at fp32 and bf16, ``warp``,
   ``sgu_blend`` from fp32 and bf16 heads, ``sgu_final``) at every rank's
   columns of 2 and of 3 ranks (an offset ``x0`` and a narrower output)
   at the decode-level shapes of B=1 375x1242 and B=2 384x1280, mask
   threshold 1.0: bit for bit against their plain versions at the same
   columns, mask bits included (``sgu_final`` within phase 2's 1e-4 px),
   and bit for bit against the columns of the whole frame's launch; the
   correlation, corr_norm and ``conv3x3_seg`` on every rank's column
   windows of 2 and 3 ranks, against their plain versions and the whole
   frame's columns under phase 2's bars.  (b)
   Two processes on cuda:0 over gloo, each this script with
   ``--spatial-rank R 2 INIT OUT``, a ('data', 'spatial') = (1, 2) mesh:
   ``make_sharded_eval_step(spatial=True)`` on B=1 375x1242 and B=2
   384x1280 at fp32 and bf16 with SGU, held against one process's
   ``forward`` at threshold 0.9999 under the AGREEMENT bars; the ranks'
   outputs equal bit for bit, each rank launching the path's kernels as
   often as one process does and no plain version on a CUDA tensor; each
   rank's forward wall and the bytes it all-reduced a forward are
   printed; every window shape the ranks launch must be one that (a)
   held; per fp32 request each rank traces where its forward first parts
   from the whole forward's (``trace_difference``).  (c) One fp32
   request, B=1 384x1280, over three ranks (every level splits
   unevenly), under the same checks.  (d)
   ``dryrun_multigpu(2)`` in (b)'s group: the step's loss on both ranks
   and the width-sharded rehearsal's line.
11. The port's bench (``upflow_pytorch_tpu_torch/bench.py``) and its
   batch sweep (``scripts/torch_bench_batch_sweep.py``).  (a) One chained
   forward of the bench (bf16, B=4 384x1280) launches phase 3's bf16
   counts less the occlusion check's two warps, no plain version on a
   CUDA tensor, and as many device kernels as the network alone plus the
   chain's own ops (counted by ``scripts/torch_forward_wall.py``'s
   ``kernel_count``); one step of the bench's train lane launches phase
   6's fp32 counts.  (b) ``bench.main([])`` at its defaults (B=4
   384x1280, 20 forwards a run, the train lane) prints its JSON line:
   every key of the JAX bench's line but ``degraded``, the card's name,
   every rate finite and > 0, the bf16 and fp32 interior EPE within 0.02
   px of the JAX package's (``jax_reference_epe.json``, ``b4_384x1280``,
   the same pairs), the fused A/B at most the chaos floor + 0.02 px, the
   out-of-halo lane's median inter-flow beyond the 40-px halo; then the
   sweep at B = 4, 8, 16 prints a line a batch (with its peak memory) and
   its summary.  (c) Training is reproducible: two runs of five
   uninterrupted steps of ``make_train_step`` from the checkpoint, at
   fp32 and bf16 with phase 6's recipe and at fp32 with the equivariance
   pass and with the SSIM loss, must give bit-equal losses and
   parameters; a run between them
   with the package's ``deterministic_numerics`` replaced by a null
   context times what determinism costs (median step ms both ways, the
   ratio, peak memory); ``bincount`` with weights must raise under the manager.
12. RAFT (``models/raft.py``; ``python3 chip_smoke.py --raft`` runs phases
   1 and 12 alone).  The correlation lookup kernel against its plain
   version (corr.py's ``bilinear_sampler``) at the cell's 47x156 grid of
   both directions, at a ragged 17x45 grid of 3 items and at 48x160 of 4,
   coordinates partly and wholly outside every level included, at fp32
   and bf16 output, the same bits on a second call, its device ms beside
   its bound and the plain version's ms; ``conv3x3_seg`` at each 3x3
   conv of a request: the encoders' three shapes without an activation,
   the update block's five with ReLU or none, on the channel ranges of
   its buffers that it reads and writes; then the bf16 entry at
   375x1242: one eager request's launches (24 lookups, 24 iterations, no
   plain version on the card), a capture and replays bit for bit the
   eager request, the forward ms from the graph and eagerly, the request
   through the plain lookup and conv within 0.1 px EPE of the kernels',
   and a profiled request's ``upflow.raft.*`` spans and device ms by
   span.
13. GMFlow (``models/gmflow.py``; ``python3 chip_smoke.py --gmflow`` runs
   phases 1 and 13 alone).  The global matching kernel against its plain
   version at the cell's shapes (N=2, L=S=7,488, C=128: both directions
   of a 48x156 grid, as matching with the grid and as propagation with a
   flow), at a ragged 100 x 77 of 3 items and at one key, the same bits
   on a second call, its device ms beside its bound (``cost`` of
   ``benchmark/ops/global_match.py``) and the plain version's ms;
   ``conv3x3_seg`` without a bias at the backbone's 3x3 shapes and with
   one at the upsampler's; then the bf16 entry at 375x1242: one eager
   request's launches (2 matching calls, the attention calls by kind, no
   plain version on the card), a capture and replays bit for bit the
   eager request, the forward ms from the graph and eagerly, the request
   through the plain matching within 0.05 px EPE of the kernel's (and
   through the plain conv too, shown), and a profiled request's
   ``upflow.gmflow.*`` spans and device ms by span.

The line before the last is the card's name and power limit; the line
before that holds the kernels' numbers as JSON, the one before that
GMFlow's, the one before that RAFT's, and the one before that the training step's (with the Trainer's
under ``trainer``); the kernels'
line also holds each kernel's launches in phase 9a's sharded step, and
in phase 10b's width-sharded forward, and the cases phase 10a held it
at on a rank's columns.  The last line,
``{"ok": true, "device": ...}``, is printed only when every check passed;
any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
NPZ = ROOT / "assets" / "synthetic_trained.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores and dense bf16 on the tensor cores.  bound_ms is the larger
# of bytes / HBM and ops / the peak of the ops' type.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the eval recipe, fp32: slice 1 ran it without SGU, the served
# configuration runs it with SGU
EVAL_KNOBS = dict(if_norm_before_cost_volume=True,
                  norm_moments_across_channels=False,
                  norm_moments_across_images=False,
                  if_sgu_upsample=False, if_use_cor_pytorch=False)
SGU_KNOBS = dict(EVAL_KNOBS, if_sgu_upsample=True)
BF16_KNOBS = dict(SGU_KNOBS, compute_dtype="bfloat16")
NORM_KW = dict(normalize=True, center=True, moments_across_channels=False,
               moments_across_images=False)
MAIN_B, MAIN_H, MAIN_W = 4, 384, 1280
PYRAMID_CHS = (196, 128, 96, 64, 32)  # decode levels 0..4, coarsest first
# (batch, height, width, seed); 375x1242 is KITTI's native size, whose
# pyramid shapes are ragged (quarter resolution 94x311)
REQUESTS = [(4, 384, 1280, 1), (1, 375, 1242, 2), (4, 384, 1280, 3)]
SGU_REQUESTS = [(4, 384, 1280, 4), (1, 375, 1242, 5), (4, 384, 1280, 6)]
BF16_REQUESTS = [(4, 384, 1280, 7), (1, 375, 1242, 8), (4, 384, 1280, 9)]
# kernel launches of one forward.  Without SGU: level 0 correlates both
# directions, levels 1-4 warp and correlate both directions, the occlusion
# check warps both flows.  SGU adds per direction a feature warp at levels
# 1-4 and at the end, one blend launch a level for both directions at
# levels 1-4, and per direction the final stage at the end.
# bf16 adds conv3x3_seg wherever a 3x3 stride-1 conv reads >= 64 channels
# on a map of >= 8 rows and >= 2048 pixels (ops/conv.py): at B=4 384x1280
# and at 375x1242 the estimator (5 convs and its head) and the context
# network (convs 0-5) at decode levels 3 and 4, 2 x 2 x 12 = 48; the SGU
# estimator (5 convs and its head) at levels 3 and 4 and the final stage,
# 2 x 3 x 6 = 36; the pyramid's level2_conv1 (64 channels at 1/8) on both
# frames, 2.  86 in all.
LAUNCHES_PER_FORWARD = {"correlation": 2, "feature_warp": 8,
                        "corr_norm": 8, "warp": 2, "sgu_blend": 0,
                        "sgu_final": 0, "conv3x3_seg": 0}
SGU_LAUNCHES_PER_FORWARD = dict(LAUNCHES_PER_FORWARD, feature_warp=18,
                                sgu_blend=4, sgu_final=2)
BF16_LAUNCHES_PER_FORWARD = dict(SGU_LAUNCHES_PER_FORWARD, conv3x3_seg=86)
# per path: knobs, requests, launches per forward, snapshot arrays skipped
PATHS = {"no-sgu": (EVAL_KNOBS, REQUESTS, LAUNCHES_PER_FORWARD, 20),
         "sgu": (SGU_KNOBS, SGU_REQUESTS, SGU_LAUNCHES_PER_FORWARD, 0),
         "sgu-bf16": (BF16_KNOBS, BF16_REQUESTS, BF16_LAUNCHES_PER_FORWARD,
                      0)}
# kernel path against plain path at the relaxed threshold: mean and 99.9th
# percentile of |diff flow| in px, and the share of occlusion pixels that
# may differ.  The SGU bars are the 3e-4 eval-knob bars of
# tests/test_torch_parity.py.  At bf16 two correct forwards differ by
# where they round: on the H100 the plain path and the library route (the
# plain path with every conv on the plain-conv route, the JAX package's
# XLA route, no kernel anywhere) differed by up to 2.0e-2 px mean, 0.59
# px p99.9 and 1.0e-2 of occlusion pixels over the three bf16 requests;
# the bf16 bars are twice that, and each run prints that floor again.
AGREEMENT = {"no-sgu": (1e-4, 1e-3, 1e-3), "sgu": (3e-4, 3e-3, 1e-3),
             "sgu-bf16": (4e-2, 1.2, 2e-2)}
RELAXED_THRESHOLD = 0.9999
# phase 6: the JAX package's training recipe (bench.py's train lane, with
# the occlusion masks' gradient stopped as tests/test_grad_parity.py has
# it) on B=4 256x832 crops of 320x896 synthetic pairs
TRAIN_KNOBS = dict(SGU_KNOBS, photo_loss_census_weight=1.0,
                   multi_scale_distillation_weight=0.01,
                   multi_scale_distillation_style="upup",
                   multi_scale_distillation_occ=True,
                   if_use_boundary_warp=True, stop_occ_gradient=True)
TRAIN_DATA = dict(n_pairs=4, seed=11, raw_hw=(320, 896), crop_hw=(256, 832))
# per precision: knobs, timed steps after one warm-up step, kernel launches
# of one step (its forward's: the backward rules launch none), the cosine
# bar of the gradient against the plain path's.  At 256x832 the bf16 step
# runs conv3x3_seg where it does at 384x1280 (86 calls), in 19 ConvBlocks
# (the estimator's and the SGU estimator's six, the context network's
# first six, the pyramid's level2_conv1), each packing its weights once a
# step.
TRAIN_PATHS = {
    "fp32": (TRAIN_KNOBS, 5, SGU_LAUNCHES_PER_FORWARD, 0.9999, 0),
    "bf16": (dict(TRAIN_KNOBS, compute_dtype="bfloat16"), 3,
             BF16_LAUNCHES_PER_FORWARD, 0.999, 19)}
DESCENT_STEPS, DESCENT_LR = 25, 2e-4
DEV = "cuda"
# the port's kernels by the profiler's kernel names
KERNEL_OF = (("corr_plain_kernel", "correlation"),
             ("corr_norm_kernel", "corr_norm"),
             ("feature_warp_kernel", "feature_warp"),
             ("sgu_blend_kernel", "sgu_blend"),
             ("sgu_final_kernel", "sgu_final"),
             ("conv3x3_seg_kernel", "conv3x3_seg"),
             ("corr_lookup_kernel", "corr_lookup"),  # RAFT's
             ("global_match_kernel", "global_match"),  # GMFlow's
             ("warp_kernel", "warp"))
# the kernels' other rows: row 5 of the TPU kernels (_window_warp_resident)
# is served by the image warp kernel, and the bf16 rows are the bf16
# instantiations of kernels 1-3 and 7
SERVED_BY = {"warp_window": "warp", "correlation_bf16": "correlation",
             "feature_warp_bf16": "feature_warp",
             "corr_norm_bf16": "corr_norm", "sgu_blend_bf16": "sgu_blend"}
KERNEL_KEY = {name: key for key, name in KERNEL_OF}
KERNEL_KEY.update({row: KERNEL_KEY[kernel]
                   for row, kernel in SERVED_BY.items()})

failures = []


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def pyramid_hw(h: int, w: int):
    """(h, w) of decode levels 0..4: six stride-2 convs (pad 1, k 3) give
    ceil(x / 2) each; the decoder runs on the coarsest five."""
    sizes = []
    for _ in range(6):
        h, w = (h + 1) // 2, (w + 1) // 2
        sizes.append((h, w))
    return sizes[::-1][:5]


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


DEVICE_MS_ATTEMPTS = 3


def device_ms(fn, key=None, calls: int = 21):
    """Device time per call of ``fn``, from torch.profiler over ``calls``
    calls: of the kernels whose names hold ``key``, or of every kernel
    with no key.  Unlike ``time_ms`` it leaves out the host's time to
    launch a call.  A window in which the profiler saw no such kernel is
    retried with a fresh one, up to ``DEVICE_MS_ATTEMPTS`` in all.
    Returns (ms or None, the attempt that gave it or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, DEVICE_MS_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (key is None or key in e.name)]
        if us:
            return sum(us) / calls / 1e3, attempt
    return None, None


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmt(v) -> str:
    return "n/a" if v is None else "%.4f" % v


def ulp_report(got, ref):
    """(values that differ, the largest difference in fp32 ulps) between
    two sequences of fp32 tensors."""
    differ, ulps = 0, 0
    for g, r in zip(got, ref):
        d = (g.contiguous().view(torch.int32).long()
             - r.contiguous().view(torch.int32).long()).abs()
        differ += int((g != r).sum().item())
        ulps = max(ulps, int(d.max().item()))
    return differ, ulps


def make_flow(rng, b, h, w, amp):
    """Smooth, large, near-integer flow (B, 2, H, W): a coarse random field
    of amplitude ``amp`` px upsampled, rounded, plus 0.05 px of noise, so
    sample coordinates sit next to integers, where the >= 1.0 mask is
    chaotic, and the edges point out of the frame."""
    coarse = torch.from_numpy(
        (rng.rand(b, 2, 4, 6).astype(np.float32) - 0.5) * 2 * amp)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=True).round()
    noise = torch.from_numpy(
        ((rng.rand(b, 2, h, w) - 0.5) * 0.05).astype(np.float32))
    return (smooth + noise).to(DEV).contiguous()


def grid_of(flow: torch.Tensor) -> torch.Tensor:
    """grid_sample's normalised grid for a (B, 2, H, W) flow (the library
    yardstick's input, built outside its timing)."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, device=flow.device, dtype=torch.float32)
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)
    gx = 2.0 * (xs[None, None] + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys[None, :, None] + flow[:, 1]) / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1).contiguous()


def grid_sample(x, grid):
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def conv_shapes(b=MAIN_B, hw=(MAIN_H, MAIN_W), ragged=True):
    """Every conv3x3_seg call of one bf16 SGU forward at ``b`` x ``hw``
    (B=4, 384x1280 by default), and with ``ragged`` the ragged ones of the
    B=1 375x1242 serving requests (names "ragged ...", 0 calls a forward):
    two of UPFlow's level 4 (94x311), every conv of its level 3 (47x156)
    and the five of RAFT's update block (2x47x156).  Each is (what, b, h,
    w, cin, cout, dilation, relu, calls per forward, buffer).  ``buffer``
    is (channels, start) of the dense buffer whose range [start, start +
    cin) is the conv's input and [start - cout, start) its output slot
    (where start >= cout), or None for a standalone tensor."""
    out = []

    def stack(tag, b, h, w, feat, fs, head, per_forward, extra):
        start = sum(fs)  # the input fills [start, feat)
        for i, f in enumerate(fs):
            out.append(("%s conv%d" % (tag, i + 1), b, h, w, feat - start, f,
                        1, True, per_forward, (feat + extra, start)))
            start -= f
        out.append(("%s head" % tag, b, h, w, feat, head, 1, False,
                    per_forward, (feat + extra, 0)))

    def level(b, h, w, lv, sgu_calls, calls=2):
        tag = "L%d" % lv
        stack("estimator " + tag, b, h, w, 563, (128, 128, 96, 64, 32), 2,
              calls, 2)
        cin = 565
        for i, (f, d) in enumerate(zip((128, 128, 128, 96, 64, 32),
                                       (1, 2, 4, 8, 16, 1))):
            out.append(("context %s conv%d" % (tag, i), b, h, w, cin, f,
                        d, True, calls, (565, 0) if i == 0 else None))
            cin = f
        stack("sgu " + tag, b, h, w, 184, (32, 32, 32, 16, 8), 3,
              sgu_calls, 0)

    levels = pyramid_hw(*hw)
    # the SGU estimator runs at level 3, and at 96 x 320 for level 4 and
    # for the final stage
    level(b, *levels[3], 3, 2)
    level(b, *levels[4], 4, 4)
    h, w = levels[3]
    out.append(("pyramid level2_conv1", b, h, w, 64, 64, 1, True, 2, None))
    if not ragged:
        return out
    n = len(out)
    h, w = pyramid_hw(375, 1242)[4]
    out.append(("estimator conv1", 1, h, w, 115, 128, 1, True, 0,
                (565, 448)))
    out.append(("context conv4", 1, h, w, 96, 64, 16, True, 0, None))
    h, w = pyramid_hw(375, 1242)[3]
    level(1, h, w, 3, 0, 0)
    out.append(("pyramid level2_conv1", 1, h, w, 64, 64, 1, True, 0, None))
    # RAFT's update block, both directions ("relu": conv3x3_seg.RELU)
    h, w = RAFT_GRID
    out += [("raft convc2", 2, h, w, 256, 192, 1, "relu", 0, None),
            ("raft convf2", 2, h, w, 128, 64, 1, "relu", 0, None),
            ("raft conv", 2, h, w, 256, 126, 1, "relu", 0, None),
            ("raft heads of hx", 2, h, w, 128, 512, 1, "relu", 0, (384, 0)),
            ("raft flow head of heads", 2, h, w, 256, 2, 1, False, 0,
             (512, 0))]
    return out[:n] + [("ragged " + s[0],) + s[1:] for s in out[n:]]


def conv_agreement(got, ref):
    """conv3x3_seg's bar: within 1 bf16 ulp of the plain value, or, where
    |plain| < 1e-3 of max|plain| (sums that cancel), within 1e-5 of
    max|plain|.  Returns |got - ref| and (ok, a description)."""
    scale = ref.abs().max().item()
    diff = (got - ref).abs()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    ulps = diff / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    ok = (ulps <= 1.0) | ((ref.abs() < 1e-3 * scale)
                          & (diff <= 1e-5 * scale))
    big = ref.abs() >= 1e-3 * scale
    return diff, (bool(ok.all()) and bool(torch.isfinite(got).all()),
                  "%.2e of values differ from the plain version, max %.2f "
                  "bf16 ulp where |plain| >= 1e-3 max, %d outside the bar"
                  % ((diff > 0).float().mean().item(),
                     ulps[big].max().item(), int((~ok).sum().item())))


def phase_kernels(k):
    """Each kernel against its plain version at the main path's shapes.
    Returns per-kernel lists of per-shape measurements."""
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    levels = pyramid_hw(MAIN_H, MAIN_W)
    rows = {name: [] for name in list(LAUNCHES_PER_FORWARD) + list(SERVED_BY)}

    def record(name, shape, err, fn, plain, nbytes, ops, library=None,
               per_forward=2, ops_per_s=FP32_OPS_PER_S, reps=21, inner=10,
               **extra):
        t_bound, by = bound_ms(nbytes, ops, ops_per_s)
        dev, attempt = device_ms(fn, KERNEL_KEY[name], reps)
        lib_dev, lib_attempt = ((None, None) if library is None
                                else device_ms(library, calls=reps))
        row = dict(
            shape=shape, max_abs_err=err, per_forward=per_forward,
            ms=time_ms(fn, reps, inner), device_ms=dev,
            device_attempt=attempt, plain_ms=time_ms(plain, reps, inner),
            library_ms=(None if library is None
                        else time_ms(library, reps, inner)),
            library_device_ms=lib_dev, library_device_attempt=lib_attempt,
            bound_ms=t_bound, bound_by=by, **extra)
        # the host's share of a call: event time of back-to-back calls
        # beyond the device time of the same calls
        row["host_ms"] = (None if row["device_ms"] is None
                          else row["ms"] - row["device_ms"])
        rows[name].append(row)
        return row

    # kernel 1: the plain correlation at every decode level of B=4
    # 384x1280 and B=1 375x1242, fp32 and bf16 (the main path runs level
    # 0; with if_use_cor_pytorch it runs at every level).  Each shape must
    # be within 1e-5 x max|out| of the plain version and give the same bits
    # on a second call; it prints its grid and its device ms beside
    # corr_norm's at the same shape.  Level 0 of the main size is timed
    # for the kernels line.
    for b, hw in ((MAIN_B, (MAIN_H, MAIN_W)), (1, (375, 1242))):
        for level, (h, w) in enumerate(pyramid_hw(*hw)):
            c = PYRAMID_CHS[level]
            f1 = randn(b, c, h, w)
            f2 = randn(b, c, h, w)
            aff = k.cn.affine_pair(*k.cn.moments(f1, False),
                                   *k.cn.moments(f2, False), NORM_KW)
            for dtype, suffix in ((torch.float32, ""),
                                  (torch.bfloat16, "_bf16")):
                a1, a2 = f1.to(dtype), f2.to(dtype)
                got = k.corr.correlation(a1, a2)
                again = k.corr.correlation(a1, a2)
                ref = k.corr.correlation_plain(a1, a2)
                err = (got - ref).abs().max().item()
                bar = 1e-5 * ref.abs().max().item()
                rows_, cols, splits, blocks = k.corr.launch_config(
                    b, c, h, w)
                what = "correlation %s L%d %s (tile %dx%d, channels split " \
                    "%d ways, %d blocks)" % (str(dtype)[6:], level,
                                             (b, c, h, w), rows_, cols,
                                             splits, blocks)
                check(err <= bar, "%s: max abs err %.3e (bound 1e-5 x "
                      "max|out| = %.3e)" % (what, err, bar))
                check(torch.equal(got, again),
                      "%s: a second call gives the same bits (%d of %d "
                      "values differ)" % (what, int((got != again).sum()),
                                          got.numel()))
                fn = (lambda a1=a1, a2=a2: k.corr.correlation(a1, a2))
                if b == MAIN_B and level == 0:
                    px = b * h * w
                    dev = record(
                        "correlation" + suffix, [b, c, h, w], err, fn,
                        lambda a1=a1, a2=a2: k.corr.correlation_plain(a1, a2),
                        a1.element_size() * 2 * px * c + 4 * 81 * px,
                        px * (162 * c + 81))["device_ms"]
                else:
                    dev, _ = device_ms(fn, KERNEL_KEY["correlation"])
                norm_dev, _ = device_ms(
                    lambda a1=a1, a2=a2, aff=aff: k.cn.corr_norm(
                        a1, a2, aff, 0.1), KERNEL_KEY["corr_norm"])
                ratio = (None if dev is None or norm_dev is None
                         else dev / norm_dev)
                print("  info %s: device %s ms, corr_norm %s ms at the same "
                      "shape (ratio %s)" % (what, fmt(dev), fmt(norm_dev),
                                            fmt(ratio)))

    # kernels 2 and 3.  The feature warp must equal its plain version bit
    # for bit, values and mask bits, and its mask must have both values;
    # corr_norm must be within 1e-5 x max|out| of its plain version and
    # give the same bits on a second call.
    def warp_check(what, x, flow):
        out, mask = k.fw.feature_warp(x, flow, 1.0, with_mask=True)
        ref, ref_mask = k.fw.feature_warp_plain(x, flow, 1.0, with_mask=True)
        differ = int((out != ref).sum().item())
        flips = int((mask != ref_mask).sum().item())
        share = mask.mean().item()
        threads, _, groups, size = k.fw.launch_config(*x.shape)
        check(out.dtype == x.dtype and differ == 0 and flips == 0
              and 0.0 < share < 1.0,
              "feature_warp %s %s %s (%d threads a block, %d groups of %d "
              "channels): %d of %d values and %d of %d mask bits differ; "
              "valid share %.4f"
              % (str(x.dtype)[6:], what, tuple(x.shape), threads, groups,
                 size, differ, out.numel(), flips, mask.numel(), share))
        return ref, (out.float() - ref.float()).abs().max().item()

    def corr_norm_check(what, f_tgt, warped):
        m1, v1 = k.cn.moments(f_tgt, False)
        m2, v2 = k.cn.moments(warped, False)
        aff = k.cn.affine_pair(m1, v1, m2, v2, NORM_KW)
        got = k.cn.corr_norm(f_tgt, warped, aff, 0.1)
        again = k.cn.corr_norm(f_tgt, warped, aff, 0.1)
        ref = k.cn.corr_norm_plain(f_tgt, warped, aff, 0.1)
        err = (got - ref).abs().max().item()
        bar = 1e-5 * ref.abs().max().item()
        rows_, cols, splits, blocks = k.cn.launch_config(*f_tgt.shape)
        route = k.cn.staging_route(f_tgt.shape[3], f_tgt.element_size(),
                                   f_tgt.data_ptr(), warped.data_ptr())
        check(err <= bar,
              "corr_norm %s %s %s (tile %dx%d, channels split %d ways, %d "
              "blocks, %s staging): max abs err %.3e (bound 1e-5 x "
              "max|out| = %.3e)"
              % (str(f_tgt.dtype)[6:], what, tuple(f_tgt.shape), rows_,
                 cols, splits, blocks, route, err, bar))
        check(torch.equal(got, again),
              "corr_norm %s %s %s: a second call gives the same bits (%d of "
              "%d values differ)"
              % (str(f_tgt.dtype)[6:], what, tuple(f_tgt.shape),
                 int((got != again).sum().item()), got.numel()))
        return aff, err

    def info(row, name, what):
        print("  info %s %s %s: device %s ms (attempt %s), events %.4f ms, "
              "host %s ms; library device %s ms (attempt %s), events %s "
              "ms; bound %.5f ms"
              % (name, what, tuple(row["shape"]), fmt(row["device_ms"]),
                 row["device_attempt"], row["ms"], fmt(row["host_ms"]),
                 fmt(row["library_device_ms"]),
                 row["library_device_attempt"], fmt(row["library_ms"]),
                 row["bound_ms"]))

    def record_warp(name, what, x, flow, err, per_forward):
        grid = grid_of(flow).to(x.dtype)
        b, c, h, w = x.shape
        px = b * h * w
        # bytes: the map read and the output written at its type, the
        # flow read; operations: the taps (30) and 8 a channel
        row = record(name, list(x.shape), err,
                     lambda: k.fw.feature_warp(x, flow, 1.0),
                     lambda: k.fw.feature_warp_plain(x, flow, 1.0),
                     x.element_size() * 2 * px * c + 4 * 2 * px,
                     px * (30 + 8 * c),
                     library=lambda: grid_sample(x, grid),
                     per_forward=per_forward, what=what)
        info(row, name, what)

    def record_corr_norm(name, what, f_tgt, warped, aff, err):
        b, c, h, w = f_tgt.shape
        px = b * h * w
        row = record(name, list(f_tgt.shape), err,
                     lambda: k.cn.corr_norm(f_tgt, warped, aff, 0.1),
                     lambda: k.cn.corr_norm_plain(f_tgt, warped, aff, 0.1),
                     f_tgt.element_size() * 2 * px * c
                     + 4 * (b * 4 * c + 81 * px),
                     px * (162 * c + 4 * c + 162), what=what)
        info(row, name, what)

    # the 8 cost-volume calls (levels 1-4, two directions each) and the
    # SGU's 10 warps of the 32-channel 1x1 features (levels 1-4 and the
    # final stage at quarter resolution), at fp32 and at bf16
    dtypes = ((torch.float32, ""), (torch.bfloat16, "_bf16"))
    for level in range(1, 6):
        final = level == 5
        h, w = levels[4 if final else level]
        amp = max(2.0, min(40.0, w / 4))
        if not final:
            c = PYRAMID_CHS[level]
            x = randn(MAIN_B, c, h, w) * 2 + 0.5
            flow = make_flow(rng, MAIN_B, h, w, amp)
            f_tgt = randn(MAIN_B, c, h, w) * 3 - 1
            what = "cost volume L%d" % level
            for dtype, suffix in dtypes:
                xd = x.to(dtype)
                warped, err = warp_check("%s, flow +-%g px" % (what, amp), xd,
                                         flow)
                record_warp("feature_warp" + suffix, what, xd, flow, err, 2)
                td = f_tgt.to(dtype)
                aff, err = corr_norm_check(what, td, warped)
                record_corr_norm("corr_norm" + suffix, what, td, warped, aff,
                                 err)
        x = randn(MAIN_B, 32, h, w) * 2 + 0.5
        flow = make_flow(rng, MAIN_B, h, w, amp)
        what = "SGU final" if final else "SGU L%d" % level
        for dtype, suffix in dtypes:
            xd = x.to(dtype)
            _, err = warp_check("%s, flow +-%g px" % (what, amp), xd, flow)
            record_warp("feature_warp" + suffix, what, xd, flow, err, 2)
    check(sum(r["per_forward"] for r in rows["feature_warp"])
          == SGU_LAUNCHES_PER_FORWARD["feature_warp"],
          "feature_warp shapes cover %d calls of an SGU forward"
          % sum(r["per_forward"] for r in rows["feature_warp"]))

    # the same checks at the ragged level shapes of 375x1242 (B=1): widths
    # 39, 78, 156 and 311 end in partial tiles and partial float4 groups
    for level, (h, w) in enumerate(pyramid_hw(375, 1242)):
        if level == 0:
            continue
        amp = max(2.0, min(40.0, w / 4))
        c = PYRAMID_CHS[level]
        flow = make_flow(rng, 1, h, w, amp)
        x = randn(1, c, h, w) * 2 + 0.5
        x32 = randn(1, 32, h, w) * 2 + 0.5
        f_tgt = randn(1, c, h, w) * 3 - 1
        for dtype, _ in dtypes:
            what = "ragged L%d" % level
            warped, _ = warp_check(what, x.to(dtype), flow)
            warp_check("ragged SGU L%d" % level, x32.to(dtype), flow)
            corr_norm_check(what, f_tgt.to(dtype), warped)

    # kernel 4: the occlusion check's flow warp at full resolution
    flow_src = make_flow(rng, MAIN_B, MAIN_H, MAIN_W, 40.0)
    flow = make_flow(rng, MAIN_B, MAIN_H, MAIN_W, 40.0)
    got = k.warp.warp(flow_src, flow)
    ref = k.warp.warp_plain(flow_src, flow)
    err = (got - ref).abs().max().item()
    check(err <= 1e-6,
          "warp %s, flow +-40 px: max abs err %.3e"
          % (tuple(flow_src.shape), err))
    grid = grid_of(flow)
    lib_err = (grid_sample(flow_src, grid) - got).abs().max().item()
    print("  info warp vs grid_sample (yardstick only): max abs diff %.3e"
          % lib_err)
    px = MAIN_B * MAIN_H * MAIN_W
    row = record("warp", list(flow_src.shape), err,
                 lambda: k.warp.warp(flow_src, flow),
                 lambda: k.warp.warp_plain(flow_src, flow),
                 4 * (2 * px * 2 + 2 * px), px * (30 + 7 * 2),
                 library=lambda: grid_sample(flow_src, grid))
    print("  info warp %s: %.4f ms a call by events, %s device ms, host "
          "%s ms; grid_sample %.4f ms, %s device ms; bound %.4f ms"
          % (tuple(flow_src.shape), row["ms"], fmt(row["device_ms"]),
             fmt(row["host_ms"]), row["library_ms"],
             fmt(row["library_device_ms"]), row["bound_ms"]))

    # row 5: the same kernel at the magnitudes of the TPU's windowed planar
    # warp (|u| <= 119, |v| <= 39 px), and beyond its window
    for tier, (amp_u, amp_v) in (("medium window", (119.0, 39.0)),
                                 ("beyond the window", (300.0, 300.0))):
        flow = torch.cat([make_flow(rng, MAIN_B, MAIN_H, MAIN_W, amp)[:, :1]
                          for amp in (amp_u, amp_v)], dim=1)
        flow[:, 0].clamp_(-amp_u, amp_u)
        flow[:, 1].clamp_(-amp_v, amp_v)
        flow = flow.contiguous()
        got = k.warp.warp(flow_src, flow)
        ref = k.warp.warp_plain(flow_src, flow)
        differ = int((got != ref).sum().item())
        err = (got - ref).abs().max().item()
        check(differ == 0,
              "warp (row 5) %s, %s |u| <= %g, |v| <= %g px: %d of %d values "
              "differ (max abs err %.3e)"
              % (tuple(flow_src.shape), tier, amp_u, amp_v, differ,
                 got.numel(), err))
        if tier == "medium window":
            grid = grid_of(flow)
            record("warp_window", list(flow_src.shape), err,
                   lambda: k.warp.warp(flow_src, flow),
                   lambda: k.warp.warp_plain(flow_src, flow),
                   4 * (2 * px * 2 + 2 * px), px * (30 + 7 * 2),
                   library=lambda: grid_sample(flow_src, grid),
                   per_forward=1)

    # kernel 7: the SGU blend at decode levels 1-4 of both request sizes,
    # both directions in one launch, reading raw (B, 3, H, W) heads, fp32
    # and bf16, in place.  Inter-flows of the TPU's fused tier (+-1.5 px),
    # its medium tier (+-30 / +-15 px) and beyond (+-300 px), mask logits
    # of +-6.  Bit for bit against the plain version; the medium tier at
    # B=4 384x1280 is timed, one row a level.  The one-direction op with
    # the mask given (ops/warp.py::sgu_blend) is held at the same cases.
    def uniform(shape, amp):
        return torch.from_numpy(
            ((rng.rand(*shape) - 0.5) * 2 * amp).astype(np.float32)).to(DEV)

    def raw_head(b, h, w, amp_u, amp_v):
        return torch.cat([uniform((b, 1, h, w), amp_u),
                          uniform((b, 1, h, w), amp_v),
                          uniform((b, 1, h, w), 6.0)], dim=1)

    stages = {}
    for b, hw in ((MAIN_B, (MAIN_H, MAIN_W)), (1, (375, 1242))):
        for level, (h, w) in enumerate(pyramid_hw(*hw)):
            if level == 0:
                continue
            amp = max(2.0, min(40.0, w / 4))
            flows = [make_flow(rng, b, h, w, amp) for _ in range(2)]
            pix, rows_, blocks = k.sb.launch_config(2, b, h, w)
            for tier, (amp_u, amp_v) in (("fused", (1.5, 1.5)),
                                         ("medium", (30.0, 15.0)),
                                         ("beyond", (300.0, 300.0))):
                heads32 = [raw_head(b, h, w, amp_u, amp_v) for _ in range(2)]
                for dtype, suffix in dtypes:
                    heads = [x.to(dtype) for x in heads32]
                    args = (flows[0], heads[0], flows[1], heads[1])
                    got = k.sb.sgu_blend_pair(*args)
                    ref = k.sb.sgu_blend_pair_plain(*args)
                    differ, ulps = ulp_report(got, ref)
                    err = max((g - r).abs().max().item()
                              for g, r in zip(got, ref))
                    what = "sgu_blend %s head L%d %s, both directions (%d " \
                        "pixels a thread, %d-row blocks, %d blocks), " \
                        "inter-flow +-%g/+-%g px (%s)" % (
                            str(dtype)[6:], level, (b, 3, h, w), pix, rows_,
                            blocks, amp_u, amp_v, tier)
                    check(differ == 0, "%s: %d of %d values differ (max "
                          "%d ulp, max abs err %.3e)"
                          % (what, differ, 2 * got[0].numel(), ulps, err))
                    if dtype == torch.float32:
                        masks = [torch.sigmoid(x[:, 2:3]) for x in heads]
                        one = [k.sb.sgu_blend(fl, x[:, :2].contiguous(), m)
                               for fl, x, m in zip(flows, heads, masks)]
                        differ, ulps = ulp_report(one, ref)
                        check(differ == 0, "sgu_blend one direction, mask "
                              "given, L%d %s (%s): %d values differ from "
                              "the plain pair (max %d ulp)"
                              % (level, (b, 2, h, w), tier, differ, ulps))
                    if b != MAIN_B or tier != "medium":
                        continue
                    stages[level, str(dtype)[6:]] = args
                    px = 2 * b * h * w
                    # bytes: per pixel and direction the flow and the head
                    # read, the output written; operations: the taps (30),
                    # the sigmoid besides its exp (3), per plane the tap
                    # sum (7) and the blend (4)
                    row = record(
                        "sgu_blend" + suffix, [2, b, 3, h, w], err,
                        lambda args=args: k.sb.sgu_blend_pair(*args),
                        lambda args=args: k.sb.sgu_blend_pair_plain(*args),
                        px * (8 + 3 * heads[0].element_size() + 8),
                        px * (30 + 3 + 2 * 11), per_forward=1,
                        what="L%d" % level, pix=pix, block_rows=rows_,
                        blocks=blocks)
                    print("  info sgu_blend %s L%d %s: device %s ms "
                          "(attempt %s), bound %.5f ms (%.2f MB), events "
                          "%.4f ms with the wrapper, host %s ms"
                          % (str(dtype)[6:], level, (2, b, 3, h, w),
                             fmt(row["device_ms"]), row["device_attempt"],
                             row["bound_ms"],
                             px * (16 + 3 * heads[0].element_size()) / 1e6,
                             row["ms"], fmt(row["host_ms"])))
    # a level's blend stage as this model runs it (one launch from the raw
    # heads) and as the model ran it before (per direction the head cast
    # to fp32, the inter-flow slice copied, the sigmoid, a one-direction
    # blend), by events (the host's time included) and device time
    def stage_before(args):
        out = []
        for fl, x in ((args[0], args[1]), (args[2], args[3])):
            x = x.float()
            out.append(k.warp_ops.sgu_blend(fl, x[:, :2],
                                            torch.sigmoid(x[:, 2:3])))
        return out

    for (level, dtype), args in sorted(stages.items()):
        if level not in (1, 4):
            continue
        times = []
        for stage in (lambda: k.warp_ops.sgu_blend_pair(*args),
                      lambda: stage_before(args)):
            dev, _ = device_ms(stage)
            times += [time_ms(stage), dev]
        print("  info sgu_blend stage L%d, %s heads: %.4f ms by events, %s "
              "device ms in one launch; as the model ran it before: %.4f "
              "ms, %s device ms in %d kernels"
              % (level, dtype, times[0], fmt(times[1]), times[2],
                 fmt(times[3]), 8 if dtype == "bfloat16" else 6))
    for name in ("sgu_blend", "sgu_blend_bf16"):
        shapes = rows[name]
        dev = (None if any(r["device_ms"] is None for r in shapes)
               else sum(r["device_ms"] for r in shapes))
        print("  info %s a forward (%d launches): device %s ms, bound %.5f "
              "ms, events %.4f ms with the wrapper"
              % (name, len(shapes), fmt(dev),
                 sum(r["bound_ms"] for r in shapes),
                 sum(r["ms"] for r in shapes)))

    # kernel 8: the final SGU stage, (4, ., 96, 320) -> (384, 1280) and
    # (1, ., 94, 311) -> (375, 1242).  Quarter-resolution inter-flows of
    # +-0.4, +-9 (the trained checkpoint's regime, timed) and +-75 px, the
    # last beyond the kernel's staged halo.
    for b, h, w in ((MAIN_B, MAIN_H, MAIN_W), (1, 375, 1242)):
        hq, wq = pyramid_hw(h, w)[4]
        flow_q = make_flow(rng, b, hq, wq, 10.0)
        for amp in (0.4, 9.0, 75.0):
            x_out = torch.cat([uniform((b, 2, hq, wq), amp),
                               uniform((b, 1, hq, wq), 3.0)], dim=1)
            got = k.sf.sgu_final(flow_q, x_out, (h, w))
            ref = k.sf.sgu_final_plain(flow_q, x_out, (h, w))
            d = (got - ref).abs()
            err = d.max().item()
            what = "sgu_final %s -> %s (tile %dx%d), quarter-resolution " \
                "inter-flow +-%g px" % (tuple(x_out.shape), (b, 2, h, w),
                                       k.sf.tile_rows(b, h, w),
                                       k.sf.TILE_W, amp)
            check(tuple(got.shape) == (b, 2, h, w) and err <= 1e-4,
                  "%s: max abs err %.3e px (<= 1e-4), mean %.3e, %d of %d "
                  "values differ" % (what, err, d.mean().item(),
                                     int((d > 0).sum().item()), got.numel()))
            fn = (lambda x_out=x_out, flow_q=flow_q, h=h, w=w:
                  k.sf.sgu_final(flow_q, x_out, (h, w)))
            if b == MAIN_B and amp == 9.0:
                px = b * h * w
                # bytes: flow_q and x_out read, the output written;
                # operations of the kernel per output pixel: 3 resized
                # samples (9 each) and their scales, the taps (30), and per
                # flow plane 5 resized samples, 5 scales, the tap sum (7)
                # and the blend (4)
                dev = record("sgu_final", list(x_out.shape), err, fn,
                             lambda: k.sf.sgu_final_plain(flow_q, x_out,
                                                          (h, w)),
                             4 * (5 * b * hq * wq + 2 * px),
                             px * (29 + 30 + 2 * (50 + 7 + 4)))["device_ms"]
            else:
                dev, _ = device_ms(fn, KERNEL_KEY["sgu_final"])
            print("  info %s: device %s ms" % (what, fmt(dev)))

    # kernel 6: conv3x3_seg at every conv shape of the bf16 forward, reading
    # and writing channel ranges of a dense buffer where the model does,
    # under conv_agreement's bar; the ragged shapes of the B=1 375x1242
    # requests also bit for bit against the TMA route on the input
    # zero-extended to the pitched width, and timed beside it
    total = 0
    for what, b, h, w, cin, cout, d, relu, per_forward, buf in conv_shapes():
        total += per_forward
        if buf is None:
            x = randn(b, cin, h, w).bfloat16()
            out = torch.empty((b, cout, h, w), dtype=torch.bfloat16,
                              device=DEV)
        else:
            full = randn(b, buf[0], h, w).bfloat16()
            x = full[:, buf[1]:buf[1] + cin]
            out = (full[:, buf[1] - cout:buf[1]] if buf[1] >= cout else
                   torch.empty((b, cout, h, w), dtype=torch.bfloat16,
                               device=DEV))
        weight = randn(cout, cin, 3, 3) * (2.0 / (9 * cin)) ** 0.5
        bias = randn(cout) * 0.1
        route = k.seg.staging_route(w, x.stride(0), x.data_ptr())
        ragged = what.startswith("ragged")
        want = "pitched" if ragged else "tma"
        before = dict(k.seg.conv3x3_seg.route_launches)
        got = k.seg.conv3x3_seg(x, weight, bias, d, relu, out=out).float()
        ran = {r: n - before[r]
               for r, n in k.seg.conv3x3_seg.route_launches.items()}
        other = "tma" if ragged else "pitched"
        check(route == want and ran == {want: 1, other: 0},
              "conv3x3_seg %s staged by the %s route (launches %s)"
              % (what, route, ran))
        ref = k.seg.conv3x3_seg_plain(x, weight, bias, d, relu).float()
        diff, stats = conv_agreement(got, ref)
        check(stats[0], "conv3x3_seg %s (%d, %d->%d, %dx%d, d=%d): %s"
              % ((what, b, cin, cout, h, w, d) + stats[1:]))
        wb, bb = weight.bfloat16(), bias.bfloat16()
        px = b * h * w
        # timed as the model calls it (weights packed once), and packing
        # on every call
        packed = k.seg.packed_params(torch.nn.Module(), weight, bias)
        call = (lambda x=x, weight=weight, bias=bias, d=d, relu=relu,
                out=out, packed=packed: k.seg.conv3x3_seg(
                    x, weight, bias, d, relu, out=out, packed=packed))
        ext = {}
        if ragged:
            wp = k.seg.pitched_width(w, d)
            x_ext = F.pad(x, (0, wp - w))
            out_ext = torch.empty((b, cout, h, wp), dtype=torch.bfloat16,
                                  device=DEV)
            ext_route = k.seg.staging_route(wp, x_ext.stride(0),
                                            x_ext.data_ptr())
            k.seg.conv3x3_seg(x_ext, weight, bias, d, relu, out=out_ext,
                              packed=packed)
            same = torch.equal(got, out_ext[..., :w].float())
            check(ext_route == "tma" and same,
                  "conv3x3_seg %s: the pitched route equals the %s route "
                  "on the input zero-extended to %d columns, cropped, bit "
                  "for bit (%d values differ)"
                  % (what, ext_route, wp,
                     int((got != out_ext[..., :w].float()).sum().item())))
            all_ms, _ = device_ms(call, None, 11)
            ext["tma_ext_device_ms"], _ = device_ms(
                lambda: k.seg.conv3x3_seg(x_ext, weight, bias, d, relu,
                                          out=out_ext, packed=packed),
                KERNEL_KEY["conv3x3_seg"], 11)
            ext["pitched_width"] = wp
        row = record(
            "conv3x3_seg", [b, cin, h, w, cout, d], diff.max().item(),
            call, lambda: k.seg.conv3x3_seg_plain(x, weight, bias, d, relu),
            2 * px * (cin + cout) + 2 * 9 * cin * cout + 4 * cout,
            2 * 9 * px * cin * cout, per_forward=per_forward,
            library=lambda: F.conv2d(x, wb, bb, padding=d, dilation=d),
            ops_per_s=BF16_OPS_PER_S, reps=11, inner=5, route=route,
            pack_per_call_ms=time_ms(
                lambda: k.seg.conv3x3_seg(x, weight, bias, d, relu,
                                          out=out), 11, 5), **ext)
        if ragged:
            # the copy: every device kernel of a call but the conv's
            row["copy_device_ms"] = (None if all_ms is None
                                     or row["device_ms"] is None
                                     else all_ms - row["device_ms"])
        print("  info conv3x3_seg %s: route %s, device ms %s, cuDNN device "
              "ms %s, bound %.4f; events %.4f ms prepacked, %.4f packing "
              "per call, host %s ms"
              % (what, route, fmt(row["device_ms"]),
                 fmt(row["library_device_ms"]), row["bound_ms"], row["ms"],
                 row["pack_per_call_ms"], fmt(row["host_ms"])))
        if ragged:
            print("  info conv3x3_seg %s (%d, %d->%d, %dx%d, d=%d): pitched "
                  "kernel %s device ms + copy %s (width %d), TMA on the "
                  "zero-extended map %s"
                  % (what, b, cin, cout, h, w, d, fmt(row["device_ms"]),
                     fmt(row["copy_device_ms"]), wp,
                     fmt(row["tma_ext_device_ms"])))
    check(total == BF16_LAUNCHES_PER_FORWARD["conv3x3_seg"],
          "conv3x3_seg shapes cover %d calls of a bf16 forward" % total)
    return rows


def textured_pair(b, h, w, seed, shift=(3, -5)):
    """NHWC frames in [0, 1]: smooth random texture plus fine noise; frame
    2 reads frame 1 at an offset of ``shift`` = (dy, dx) pixels, so the
    true flow is (u, v) = (-dx, -dy)."""
    rng = np.random.RandomState(seed)
    pad = 8
    hh, ww = h + 2 * pad, w + 2 * pad
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    canvas = np.zeros((b, hh, ww, 3), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(0.01, 0.2, size=2)
        phase = rng.uniform(0, 2 * np.pi, size=(b, 1, 1, 3))
        amp = rng.uniform(0.2, 1.0, size=(b, 1, 1, 3))
        canvas += amp * np.sin(fy * yy[None, :, :, None]
                               + fx * xx[None, :, :, None] + phase)
    canvas += 0.3 * rng.randn(b, hh, ww, 3).astype(np.float32)
    canvas = (canvas - canvas.min()) / (canvas.max() - canvas.min())
    dy, dx = shift
    im1 = canvas[:, pad:pad + h, pad:pad + w]
    im2 = canvas[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
    return (np.ascontiguousarray(im1, np.float32),
            np.ascontiguousarray(im2, np.float32))


@contextlib.contextmanager
def plain_path(k):
    """Routes the model's calls to the plain versions (CUDA tensors
    included) for the comparison run; the kernels stay untouched."""
    swaps = [(k.upflow, "correlation", k.corr.correlation_plain),
             (k.cn, "corr_norm", k.cn.corr_norm_plain),
             (k.fw, "feature_warp", k.fw.feature_warp_plain),
             (k.warp, "warp", k.warp.warp_plain),
             (k.sb, "sgu_blend", k.sb.sgu_blend_plain),
             (k.sb, "sgu_blend_pair", k.sb.sgu_blend_pair_plain),
             (k.upflow, "sgu_final", k.sf.sgu_final_plain),
             (k.conv_ops, "conv3x3_seg", k.seg.conv3x3_seg_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        with k.entry.eager_entry():  # a graph's replay ignores the swaps
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def library_route(k):
    """Every bf16 conv on the plain-conv route (cuDNN), as the JAX package
    computes them off the TPU; for the bf16 path's agreement floor."""
    saved = k.conv_ops.uses_kernel
    k.conv_ops.uses_kernel = lambda *args: False
    try:
        with k.entry.eager_entry():
            yield
    finally:
        k.conv_ops.uses_kernel = saved


def flow_diffs(a, b):
    d = torch.cat([(a[key] - b[key]).abs().flatten()
                   for key in ("flow_f_out", "flow_b_out")])
    return d.mean().item(), torch.quantile(d.double(), 0.999).item()


def wall_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sgu_extrema(heads, hw):
    """Per SGU stage, the largest |u| and |v| of the inter-flow the stage
    warps with, in px at the resolution it warps at: levels 1-4 blend at
    the level's size, the final stage rate-scales its quarter-resolution
    head output to (H, W).  ``heads`` holds the estimator's outputs in call
    order, two directions per stage."""
    out = []
    for i in range(0, len(heads), 2):
        x = torch.cat([heads[i][:, :2], heads[i + 1][:, :2]])
        su, sv = 1.0, 1.0
        if i == len(heads) - 2:
            su, sv = hw[1] / x.shape[3], hw[0] / x.shape[2]
        out.append((round(x[:, 0].abs().max().item() * su, 2),
                    round(x[:, 1].abs().max().item() * sv, 2)))
    return out


def phase_serve(k, tag: str, ref_model=None):
    """Three requests through the entry points on one path of ``PATHS``;
    returns the launch counts of the path's run, the per-request times,
    the model and the first request.  With ``ref_model`` each request's
    flow difference from that model's forward is printed."""
    knobs, requests, per_forward, skipped = PATHS[tag]
    sgu = knobs["if_sgu_upsample"]
    conf = k.UPFlowConfig().updated(knobs)
    t0 = time.perf_counter()
    model = k.entry.build_model(conf, weights=str(NPZ))
    print("  %s model on %s in %.1f s: %d parameters, snapshot arrays "
          "skipped: %s" % (tag, next(model.parameters()).device,
                           time.perf_counter() - t0,
                           sum(p.numel() for p in model.parameters()),
                           len(model.skipped_keys)))
    check(len(model.skipped_keys) == skipped,
          "%s model: %d snapshot arrays skipped" % (tag,
                                                   len(model.skipped_keys)))
    pairs = [textured_pair(b, h, w, seed) for b, h, w, seed in requests]

    # the path's run: every count 0 just before, read just after
    routes = k.seg.conv3x3_seg.route_launches
    cn_routes = k.cn.corr_norm.route_launches
    for fn in k.dispatch.values():
        fn.launches = 0
    for fn in k.plain.values():
        fn.cuda_calls = 0
    routes.update({"tma": 0, "pitched": 0})
    cn_routes.update({"vec": 0, "word": 0})
    # eager: the launch counters count at a graph's capture, not its replay
    with k.entry.eager_entry():
        for i, ((b, h, w, seed), (im1, im2)) in enumerate(
                zip(requests, pairs)):
            before = {n: fn.launches for n, fn in k.dispatch.items()}
            routes_before = dict(routes)
            cn_before = dict(cn_routes)
            packs_before = k.seg.pack_weight.calls
            out = k.entry.forward(model, im1, im2)
            torch.cuda.synchronize()
            delta = {n: fn.launches - before[n]
                     for n, fn in k.dispatch.items()}
            what = "%s request %dx%dx%d" % (tag, b, h, w)
            check(delta == per_forward, "%s: launches %s" % (what, delta))
            # conv3x3_seg: TMA staging on the aligned 384x1280 pyramid,
            # pitched copies on 375x1242's; weights packed at the model's
            # first call only
            convs = per_forward["conv3x3_seg"]
            aligned = h % 64 == 0 and w % 64 == 0
            ran = {r: n - routes_before[r] for r, n in routes.items()}
            packs = k.seg.pack_weight.calls - packs_before
            check(ran == {"tma": convs if aligned else 0,
                          "pitched": 0 if aligned else convs},
                  "%s: conv3x3_seg launches by staging route %s" % (what, ran))
            # corr_norm: 4-pixel copies at the widths that are whole 4-pixel
            # groups (all of 384x1280's levels, 375x1242's 156), 4-byte words
            # at 375x1242's 39, 78 and 311
            vec = 2 * sum(lw % 4 == 0 for _, lw in pyramid_hw(h, w)[1:])
            ran = {r: n - cn_before[r] for r, n in cn_routes.items()}
            check(ran == {"vec": vec, "word": per_forward["corr_norm"] - vec},
                  "%s: corr_norm launches by staging route %s" % (what, ran))
            check(i == 0 or packs == 0,
                  "%s: %d pack_weight calls (the model's first forward packs "
                  "its kernel-route convs once)" % (what, packs))
            for key, ch in (("flow_f_out", 2), ("flow_b_out", 2),
                            ("occ_fw", 1), ("occ_bw", 1)):
                t = out[key]
                check(tuple(t.shape) == (b, h, w, ch) and t.is_cuda
                      and bool(torch.isfinite(t).all()),
                      "%s: %s %s finite on %s" % (what, key, tuple(t.shape),
                                                 t.device))
            check(bool(((out["occ_fw"] == 0) | (out["occ_fw"] == 1)).all()),
                  "%s: occlusion mask in {0, 1}" % what)
            check(len(out["flows"]) == 5, "%s: 5 levels" % what)
            print("  info %s: mean flow (u, v) = (%.3f, %.3f); the frames are "
                  "shifted by (5, -3) px"
                  % ((what,) + tuple(out["flow_f_out"].mean(dim=(0, 1, 2))
                                     .tolist())))
    launches = {n: fn.launches for n, fn in k.dispatch.items()}
    plain_calls = {n: fn.cuda_calls for n, fn in k.plain.items()}
    check(all((v > 0) == (per_forward[n] > 0) for n, v in launches.items()),
          "%s path launched every kernel it runs: %s" % (tag, launches))
    check(all(v == 0 for v in plain_calls.values()),
          "no plain version ran on CUDA tensors in the %s path: %s"
          % (tag, plain_calls))

    # kernel path against plain path on the card, relaxed threshold
    bar_mean, bar_p999, bar_occ = AGREEMENT[tag]
    timing = []
    k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
    try:
        for (b, h, w, seed), (im1, im2) in zip(requests, pairs):
            what = "%s request %dx%dx%d" % (tag, b, h, w)
            heads = []
            hook = (model.sgi_model.dense_estimator_mask.register_forward_hook(
                lambda mod, args, out: heads.append(out[1])) if sgu else None)
            fast = k.entry.forward(model, im1, im2)
            if hook is not None:
                hook.remove()
                print("  info %s: max |inter-flow| (u, v) px per SGU stage, "
                      "levels 1-4 then final (rate-scaled): %s"
                      % (what, sgu_extrema(heads, (h, w))))
            before = {n: fn.launches for n, fn in k.dispatch.items()}
            with plain_path(k):
                plain = k.entry.forward(model, im1, im2)
            torch.cuda.synchronize()
            check(all(fn.launches == before[n]
                      for n, fn in k.dispatch.items()),
                  "%s: the plain path launched no kernel" % what)
            if knobs.get("compute_dtype") == "bfloat16":
                with plain_path(k), library_route(k):
                    lib = k.entry.forward(model, im1, im2)
                occ = max((plain[key] != lib[key]).float().mean().item()
                          for key in ("occ_fw", "occ_bw"))
                print("  info %s: floor, plain path vs library route: flow "
                      "|diff| mean %.3e px, p99.9 %.3e px, occlusion %.2e"
                      % ((what,) + flow_diffs(plain, lib) + (occ,)))
            mean, p999 = flow_diffs(fast, plain)
            check(mean < bar_mean and p999 < bar_p999,
                  "%s at threshold %g: kernel vs plain path flow |diff| "
                  "mean %.3e px (< %g), p99.9 %.3e px (< %g)"
                  % (what, RELAXED_THRESHOLD, mean, bar_mean, p999,
                     bar_p999))
            for key in ("occ_fw", "occ_bw"):
                frac = (fast[key] != plain[key]).float().mean().item()
                check(frac < bar_occ, "%s: %s disagrees on %.2e of pixels "
                      "(< %g)" % (what, key, frac, bar_occ))
            levels = max(max((ff - pf).abs().max().item(),
                             (fb - pb).abs().max().item())
                         for (ff, fb), (pf, pb) in zip(fast["flows"],
                                                       plain["flows"]))
            print("  info %s: per-level flow max |diff| %.3e px"
                  % (what, levels))
            if ref_model is not None:
                mean, p999 = flow_diffs(
                    fast, k.entry.forward(ref_model, im1, im2))
                print("  info %s: against the fp32 SGU kernel path, flow "
                      "|diff| mean %.3e px, p99.9 %.3e px" % (what, mean,
                                                              p999))
            fast_ms = wall_ms(lambda: k.entry.forward(model, im1, im2))
            with plain_path(k):
                plain_ms = wall_ms(lambda: k.entry.forward(model, im1, im2))
            timing.append(dict(path=tag, request=[b, h, w],
                               kernel_ms=fast_ms, plain_ms=plain_ms))
            print("  info %s: forward %.2f ms (kernels), %.2f ms (plain "
                  "versions)" % (what, fast_ms, plain_ms))
    finally:
        k.warp_ops.MASK_THRESHOLD = 1.0
    return launches, timing, model, pairs[0]


def phase_tf32_request(k, model, pair):
    """One SGU request under ``torch.set_float32_matmul_precision("high")``,
    as a caller that wants TF32 elsewhere sets it.  ``forward`` pins
    full-fp32 matrix products (the flow resizes) for the call, so the
    request keeps the SGU agreement bars against the plain path, and the
    caller's setting reads "high" afterwards."""
    im1, im2 = pair
    what = "sgu request %dx%dx%d under matmul precision \"high\"" % (
        im1.shape[:3])
    bar_mean, bar_p999, bar_occ = AGREEMENT["sgu"]
    k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
    try:
        exact = k.entry.forward(model, im1, im2)
        with plain_path(k):
            plain = k.entry.forward(model, im1, im2)
        torch.set_float32_matmul_precision("high")
        try:
            fast = k.entry.forward(model, im1, im2)
            torch.cuda.synchronize()
            after = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision("highest")
    finally:
        k.warp_ops.MASK_THRESHOLD = 1.0
    check(after == "high", "%s: the caller's setting reads %r afterwards"
          % (what, after))
    mean, p999 = flow_diffs(fast, plain)
    check(mean < bar_mean and p999 < bar_p999,
          "%s at threshold %g: kernel vs plain path flow |diff| mean %.3e px "
          "(< %g), p99.9 %.3e px (< %g)"
          % (what, RELAXED_THRESHOLD, mean, bar_mean, p999, bar_p999))
    for key in ("occ_fw", "occ_bw"):
        frac = (fast[key] != plain[key]).float().mean().item()
        check(frac < bar_occ, "%s: %s disagrees on %.2e of pixels (< %g)"
              % (what, key, frac, bar_occ))
    print("  info %s: flows equal to the forward under \"highest\" bit for "
          "bit: %s" % (what, all(torch.equal(fast[key], exact[key]) for key
                                 in ("flow_f_out", "flow_b_out"))))


# cuDNN's kernel names, FFT-based convolutions included
CONV_WORDS = ("conv", "gemm", "xmma", "cudnn", "winograd", "implicit", "fft",
              "region_transform")


def phase_profile(k, model, pair, tag):
    """One forward of the first request under torch.profiler: device time
    by kernel, by kind, the device's busy share of the wall time and the
    number of device kernels the forward launched (host-device transfers
    and memsets counted apart).  Copies are host-device transfers and copy
    kernels (concatenation and ``.contiguous()``).  Returns the kernel
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    im1, im2 = pair
    k.entry.forward(model, im1, im2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k.entry.forward(model, im1, im2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    kernels = transfers = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            if e.name.lower().startswith(("memcpy", "memset")):
                transfers += 1
            else:
                kernels += 1
    busy_us = sum(by_name.values())
    if busy_us == 0:
        print("  info the profiler recorded no device time")
        return None
    kinds = {"port kernels": 0.0, "convolutions": 0.0, "copies": 0.0,
             "other": 0.0}
    port = {name: 0.0 for _, name in KERNEL_OF}
    for kname, us in by_name.items():
        mine = next((n for key, n in KERNEL_OF if key in kname), None)
        if mine is not None:
            port[mine] += us
            kinds["port kernels"] += us
        elif "memcpy" in kname.lower() or "copy" in kname.lower():
            kinds["copies"] += us
        elif any(w in kname.lower() for w in CONV_WORDS):
            kinds["convolutions"] += us
        else:
            kinds["other"] += us
    print("  info %s forward %dx%dx%d: wall %.0f us, device busy %.0f us "
          "(%.1f%%)" % ((tag,) + im1.shape[:3]
                        + (wall_us, busy_us, 100 * busy_us / wall_us)))
    for kind, us in kinds.items():
        print("  info   %-13s %9.0f us  %5.1f%% of device time"
              % (kind, us, 100 * us / busy_us))
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print("  info   %9.0f us  %s" % (us, kname[:110]))
    print("  info port kernels' device us in this forward: %s"
          % {n: round(us, 1) for n, us in port.items()})
    print("  info %s forward: %d device kernels, %d transfers and memsets"
          % (tag, kernels, transfers))
    return kernels


# phase 5's requests: name -> (make_dataset arguments, pairs a forward,
# pad_to_multiple); the names are those of the JAX reference file
EVAL_REQUESTS = {
    "b4_384x1280": (dict(n_pairs=4, seed=7, raw_hw=(384, 1280),
                         crop_hw=(384, 1280)), 4, None),
    "b1_375x1242_native": (dict(n_pairs=2, seed=11, raw_hw=(375, 1242),
                                crop_hw=(375, 1242)), 1, None),
    "b1_375x1242_pad64": (dict(n_pairs=2, seed=11, raw_hw=(375, 1242),
                               crop_hw=(375, 1242)), 1, 64),
}
# the requests whose interior EPE is held to the JAX package's, within
# EPE_BAR px, on both SGU paths
EPE_GATED = ("b4_384x1280", "b1_375x1242_native")
EPE_BAR = 0.02
JAX_REFERENCE = ROOT / "upflow_pytorch_tpu_torch" / "eval" / \
    "jax_reference_epe.json"


def phase_eval(k, models):
    """The evaluation path: ``EvaluationBench`` with the port's
    ``NetEvalModel`` over the synthetic pairs of ``EVAL_REQUESTS``, on the
    fp32 and the bf16 SGU paths at the default mask threshold, through the
    kernels and through the plain versions on the card.  Per path and
    request it prints EPE-all and F1 (all-ones masks) and the interior EPE
    (8 px cropped, ``data/synthetic.epe``) beside the JAX package's (fp32,
    on the CPU, ``scripts/torch_eval_jax_reference.py``), and the bf16
    path's mean |flow - fp32 flow|.  Each kernel run counts its launches
    from 0: every kernel of the path, as often as its forwards need."""
    ref = json.loads(JAX_REFERENCE.read_text())
    print("  info JAX reference: %s" % ref["source"])

    class Keeping(k.trainer.NetEvalModel):
        def eval_save_result(self, save_name, predflow, *args, **kwargs):
            self.preds.append(predflow)

    for name, (kw, per_forward, pad) in EVAL_REQUESTS.items():
        kw = dict(kw)
        t0 = time.perf_counter()
        data = k.synthetic.make_dataset(kw.pop("n_pairs"), **kw)
        gt = data["gt_flow"]
        ones = np.ones_like(gt[..., :1])
        samples = [k.bench.EvalSample(
            data["im1"][i:i + per_forward], data["im2"][i:i + per_forward],
            gt[i:i + per_forward], ones[i:i + per_forward],
            gt[i:i + per_forward], ones[i:i + per_forward])
            for i in range(0, len(gt), per_forward)]
        jax_ref = ref["requests"][name]
        print("  info %s: %d pairs made in %.1f s; JAX fp32 EPE-all %.4f, "
              "F1 %.4f, interior EPE %.4f"
              % (name, len(gt), time.perf_counter() - t0, jax_ref["epe_all"],
                 jax_ref["f1"], jax_ref["epe_interior"]))
        preds = {}
        for tag in ("sgu", "sgu-bf16"):
            for route in ("kernels", "plain"):
                eval_model = Keeping(models[tag], pad_to_multiple=pad)
                eval_model.preds = []
                bench = k.bench.EvaluationBench(samples)
                what = "%s %s path (%s)" % (name, tag, route)
                if route == "kernels":
                    for fn in k.dispatch.values():
                        fn.launches = 0
                    for fn in k.plain.values():
                        fn.cuda_calls = 0
                    res = bench(eval_model)
                    torch.cuda.synchronize()
                    want = {n: c * len(samples)
                            for n, c in PATHS[tag][2].items()}
                    got = {n: fn.launches for n, fn in k.dispatch.items()}
                    plain_calls = sum(fn.cuda_calls
                                      for fn in k.plain.values())
                    check(got == want and plain_calls == 0,
                          "%s: launches %s over %d forwards, %d plain calls "
                          "on CUDA tensors" % (what, got, len(samples),
                                                plain_calls))
                else:
                    with plain_path(k):
                        res = bench(eval_model)
                pred = np.concatenate(eval_model.preds)
                preds[tag, route] = pred
                interior = k.synthetic.epe(pred, gt)
                check(pred.shape == gt.shape and bool(np.isfinite(pred).all())
                      and all(np.isfinite(v) for v in res),
                      "%s: flow %s finite; EPE-all %.4f, F1 %.4f, interior "
                      "EPE %.4f (JAX %.4f, diff %+.4f)"
                      % (what, pred.shape, res.epe_all, res.f1, interior,
                         jax_ref["epe_interior"],
                         interior - jax_ref["epe_interior"]))
                if route == "kernels" and name in EPE_GATED:
                    check(abs(interior - jax_ref["epe_interior"]) <= EPE_BAR,
                          "%s: interior EPE %.4f within %g px of the JAX "
                          "package's %.4f"
                          % (what, interior, EPE_BAR,
                             jax_ref["epe_interior"]))
        for route in ("kernels", "plain"):
            drift = np.abs(preds["sgu-bf16", route] - preds["sgu", route])
            print("  info %s (%s): bf16 against fp32 flow |diff| mean %.4f "
                  "px, share above 1 px %.2e"
                  % (name, route, drift.mean(), (drift > 1.0).mean()))


def train_batch(k, n_pairs=None):
    data = k.synthetic.make_dataset(**TRAIN_DATA)
    return {key: torch.from_numpy(v[:n_pairs]).to(DEV)
            for key, v in data.items() if key != "gt_flow"}


def step_gradients(k, conf, batch):
    """The gradient of one step's total loss by parameter name, from the
    checkpoint's weights, the step's loss terms, and the peak memory (GiB)
    of its forward and of the whole step."""
    model = k.entry.build_model(conf, weights=str(NPZ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = k.upflow.forward_with_loss(model, batch)
    torch.cuda.synchronize()
    forward_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with k.resize.fp32_numerics():
        out["total_loss"].backward()
    torch.cuda.synchronize()
    return ({n: p.grad for n, p in model.named_parameters()},
            {key: float(out[key].detach()) for key in k.step.METRICS},
            (forward_peak, torch.cuda.max_memory_allocated() / 2 ** 30))


def kernel_kind(name: str) -> str:
    """A device kernel's kind in a training step's split, by its name."""
    low = name.lower()
    if any(key in name for key, _ in KERNEL_OF):
        return "forward kernels"
    if "memcpy" in low or "copy" in low:
        return "copies"
    if any(w in low for w in CONV_WORDS):
        return "convolutions"
    return "other"


def profile_train_step(k, step_fn, state, batch, tag, forwards=False):
    """One training step under torch.profiler: device time split by kind
    and by backward rule.  Every device kernel counts by its name
    (``kernel_kind``), except those that the profiler links to a host op
    inside one of the program's spans of a backward rule
    (``upflow.rule.<Function>``), with ``forwards`` of a forward
    (``upflow.step.loss``: "teacher forward", ``upflow.step.equivariance``:
    "student forward"), or inside the optimizer's step, which count there.
    Returns (state, split, rules, busy ms, wall ms); the split and rules
    are None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rule_of = {"upflow.rule." + fn.__name__: name
               for name, fn in k.functions.items()}
    forward_of = ({"upflow.step.loss": "teacher forward",
                   "upflow.step.equivariance": "student forward"}
                  if forwards else {})
    with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds = {"forward kernels": 0.0, "backward rules": 0.0,
             "convolutions": 0.0, "optimizer": 0.0, "copies": 0.0,
             "other": 0.0}
    rules = {name: 0.0 for name in k.functions}
    by_name = {}
    events = prof.events()
    for e in events:
        # the profiler mirrors a user-scope host range (the optimizer's)
        # on the device's timeline as a user annotation: not a kernel
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(("upflow.", "Optimizer."))):
            us = e.time_range.elapsed_us()
            kinds[kernel_kind(e.name)] += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        scope, parent = None, e
        while parent is not None and scope is None:
            if parent.name in rule_of:
                scope = rule_of[parent.name]
            elif parent.name in forward_of:
                scope = forward_of[parent.name]
            elif parent.name.startswith("Optimizer.step"):
                scope = "optimizer"
            parent = parent.cpu_parent
        if scope is None:
            continue
        for kern in e.kernels:
            kinds[kernel_kind(kern.name)] -= kern.duration
            if scope == "optimizer":
                kinds["optimizer"] += kern.duration
            elif scope.endswith(" forward"):
                kinds[scope] = kinds.get(scope, 0.0) + kern.duration
            else:
                kinds["backward rules"] += kern.duration
                rules[scope] += kern.duration
    busy = sum(kinds.values())
    if busy == 0:
        print("  info %s step: the profiler recorded no device time" % tag)
        return state, None, None, None, wall
    print("  info %s step under the profiler: wall %.1f ms, device busy "
          "%.1f ms (%.1f%%)" % (tag, wall, busy / 1e3, busy / 10 / wall))
    for kind, us in kinds.items():
        print("  info   %-16s %9.3f ms  %5.1f%% of device time"
              % (kind, us / 1e3, 100 * us / busy))
    print("  info %s backward rules' device ms a step: %s"
          % (tag, {n: round(us / 1e3, 4) for n, us in rules.items()}))
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print("  info   %9.3f ms  %s" % (us / 1e3, kname[:110]))
    return (state, {kind: us / 1e3 for kind, us in kinds.items()},
            {n: us / 1e3 for n, us in rules.items()}, busy / 1e3, wall)


def phase_train(k):
    """Phase 6: the training step on both precisions, its gradient against
    the plain path's, and a descent from seeded weights.  Returns the
    train JSON object."""
    batch = train_batch(k)
    out = {"batch": [4, 256, 832], "raw": [320, 896]}
    for tag, (knobs, steps, per_step, cos_bar, packers) in \
            TRAIN_PATHS.items():
        conf = k.UPFlowConfig().updated(knobs)
        model, state, opt = k.step.create_train_state(
            conf, k.TrainerConfig(), weights=str(NPZ))
        step_fn = k.step.make_train_step(model, opt)
        # the path's run: every count 0 just before, read just after
        for fn in k.dispatch.values():
            fn.launches = 0
        for fn in k.plain.values():
            fn.cuda_calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(1 + steps):
            before = {n: fn.launches for n, fn in k.dispatch.items()}
            packs = k.seg.pack_weight.calls
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            if i > 0:
                times.append((time.perf_counter() - t0) * 1e3)
            what = "train %s step %d" % (tag, i)
            delta = {n: fn.launches - before[n]
                     for n, fn in k.dispatch.items()}
            check(delta == per_step, "%s: launches %s" % (what, delta))
            packs = k.seg.pack_weight.calls - packs
            check(packs == packers, "%s: %d conv3x3_seg weight packs (one "
                  "per kernel-route conv, %d)" % (what, packs, packers))
            terms = {key: float(v) for key, v in metrics.items()}
            check(all(np.isfinite(v) for v in terms.values()),
                  "%s: loss terms finite %s" % (what, terms))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {n: fn.launches for n, fn in k.dispatch.items()}
        plain_calls = {n: fn.cuda_calls for n, fn in k.plain.items()}
        check(all((v > 0) == (per_step[n] > 0) for n, v in launches.items()),
              "train %s path launched every kernel it runs: %s"
              % (tag, launches))
        check(all(v == 0 for v in plain_calls.values()),
              "no plain version ran on CUDA tensors in the train %s path: "
              "%s" % (tag, plain_calls))
        zero = [n for n, p in model.named_parameters()
                if p.grad is None or not bool(p.grad.abs().max() > 0)]
        check(not zero and any(n.startswith("feature_pyramid_extractor")
                               for n, _ in model.named_parameters()),
              "train %s: every parameter has a nonzero gradient, the "
              "pyramid's included (zero: %s)" % (tag, zero))
        print("  info train %s: step %.1f ms median (%.1f-%.1f) over %d "
              "steps; peak memory %.2f GiB; last terms %s"
              % (tag, statistics.median(times), min(times), max(times),
                 steps, peak, {key: round(v, 5) for key, v in terms.items()}))
        state, split, rules, busy, wall = profile_train_step(
            k, step_fn, state, batch, "train " + tag)

        # one step's gradient, kernels against plain versions on the card
        k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
        try:
            fast, fast_terms, peaks = step_gradients(k, conf, batch)
            with plain_path(k):
                plain, plain_terms, _ = step_gradients(k, conf, batch)
        finally:
            k.warp_ops.MASK_THRESHOLD = 1.0
        names = sorted(fast)
        a = torch.cat([fast[n].double().flatten() for n in names])
        b = torch.cat([plain[n].double().flatten() for n in names])
        cos = float(a @ b / (a.norm() * b.norm()))
        rel = {n: float((fast[n].double() - plain[n].double()).norm()
                        / plain[n].double().norm().clamp_min(1e-30))
               for n in names}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        check(cos >= cos_bar, "train %s at threshold %g: gradient cosine, "
              "kernels vs plain path, %.7f (>= %g)"
              % (tag, RELAXED_THRESHOLD, cos, cos_bar))
        print("  info train %s: per-tensor relative L2, kernels vs plain: "
              "median %.2e, largest %s; terms kernels %s, plain %s; peak "
              "memory from the weights: forward %.2f GiB, step %.2f GiB"
              % ((tag, statistics.median(rel.values()),
                  [(n, "%.2e" % v) for n, v in worst],
                  {key: round(v, 6) for key, v in fast_terms.items()},
                  {key: round(v, 6) for key, v in plain_terms.items()})
                 + peaks))
        out[tag] = dict(step_ms_median=statistics.median(times),
                        step_ms_min=min(times), step_ms_max=max(times),
                        timed_steps=steps, peak_memory_gib=peak,
                        launches_per_step=per_step,
                        profiled_step=dict(wall_ms=wall, device_ms=busy,
                                           split_ms=split,
                                           backward_rule_ms=rules),
                        forward_peak_memory_gib=peaks[0],
                        grad_cosine_vs_plain=cos,
                        max_tensor_rel_l2_vs_plain=worst[0][1])

    # descent from seeded weights on one pair
    conf = k.UPFlowConfig().updated(TRAIN_KNOBS)
    model, state, opt = k.step.create_train_state(
        conf, k.TrainerConfig(lr=DESCENT_LR), seed=0)
    step_fn = k.step.make_train_step(model, opt)
    pair = train_batch(k, 1)
    losses = []
    for _ in range(DESCENT_STEPS):
        state, metrics = step_fn(state, pair)
        losses.append(float(metrics["total_loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "train from seeded weights, %d fp32 steps (lr %g) on one pair: "
          "total loss %.5f -> %.5f" % (DESCENT_STEPS, DESCENT_LR, losses[0],
                                       losses[-1]))
    out["descent"] = dict(steps=DESCENT_STEPS, lr=DESCENT_LR,
                          first=losses[0], last=losses[-1])
    return out


# phase 7: the Trainer.  7a trains phase 6's recipe from the checkpoint
# with the equivariance pass (eq_loss_weight 0.1, occlusion-masked) at B=4
# 256x832 crops of 8 synthetic pairs, evaluating on phase 5's two B=1
# 375x1242 pairs (padded to multiples of 64) at every two-step epoch: run
# A to step 2, run B resumes A's checkpoint and goes on to step 4, run C
# trains 0 -> 4 in another directory.  The step runs under the package's
# deterministic_numerics, so B's step 3 equals A's uninterrupted step 3
# bit for bit, B's parameters and optimizer state after step 4 equal C's,
# and every step of A and B equals C's step of the same count.
TRAINER_DATA = dict(n_pairs=8, seed=11, raw_hw=(320, 896), crop_hw=(256, 832))
TRAINER_CONF = dict(batchsize=4, batch_per_epoch=2, batch_per_print=1,
                    eq_loss_weight=0.1, eq_loss_use_occ=True, num_workers=2,
                    eval_pad_to_multiple=64)
# an equivariance step runs the teacher's forward (forward_with_loss: a
# forward and the occlusion check) and the student's (a forward on the
# transformed pair, no occlusion check)
EQ_LAUNCHES_PER_STEP = {n: c + (0 if n == "warp" else c)
                        for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
# 7b: a bf16 forward at B=1 375x1242 runs conv3x3_seg in 19 ConvBlocks,
# each of which packs its weights at the first forward after a load
BF16_PACKERS = 19
# 7c: the JAX package's tests/test_synthetic_learning.py, from seeded
# Kaiming-normal weights: its recipe, data, batch, learning rate, steps and
# bars (EPE against the exact flow starts above 3x the mean flow, ends
# below 1.2 px and below 0.25x its start)
LEARN_KNOBS = dict(if_norm_before_cost_volume=True,
                   norm_moments_across_channels=False,
                   norm_moments_across_images=False, if_sgu_upsample=True,
                   if_use_cor_pytorch=True, photo_loss_census_weight=1.0,
                   multi_scale_distillation_weight=0.01,
                   multi_scale_distillation_style="upup",
                   multi_scale_distillation_occ=True,
                   if_use_boundary_warp=True)
LEARN_DATA = dict(n_pairs=8, seed=0, raw_hw=(96, 192), crop_hw=(64, 160))
LEARN_BATCH, LEARN_STEPS, LEARN_LR, LEARN_EPE_AT = 4, 60, 1e-4, (30, 60)
# per step of that path (if_use_cor_pytorch: the plain correlation at
# every level, the feature warp before it at levels 1-4)
LEARN_LAUNCHES_PER_STEP = dict(SGU_LAUNCHES_PER_FORWARD, correlation=10,
                               corr_norm=0)
# kernel -> (the module attribute the model calls, the plain version's,
# bar on the largest difference: None for bit for bit, else a share of
# max|plain|, phase 2's bars)
RECORDED = {"correlation": (("upflow", "correlation"),
                            ("corr", "correlation_plain"), 1e-5),
            "feature_warp": (("fw", "feature_warp"),
                             ("fw", "feature_warp_plain"), None),
            "warp": (("warp", "warp"), ("warp", "warp_plain"), 1e-6),
            "sgu_blend": (("sb", "sgu_blend_pair"),
                          ("sb", "sgu_blend_pair_plain"), None),
            "sgu_final": (("upflow", "sgu_final"),
                          ("sf", "sgu_final_plain"), 1e-4)}


class PairDataset:
    """Items of a ``make_dataset`` batch (without its ground truth)."""

    def __init__(self, data):
        self.data = {key: v for key, v in data.items() if key != "gt_flow"}

    def __len__(self):
        return len(self.data["im1"])

    def __getitem__(self, i):
        return {key: v[i] for key, v in self.data.items()}


def make_trainer(k, exp_dir, dataset, bench):
    """A ``Trainer`` of phase 6's recipe with the equivariance pass, from
    the checkpoint's weights, whose every step is timed and has its
    launches counted.  Returns the trainer, its untimed step function and
    the run's record (log lines, steps)."""
    logs = []

    def log(line):
        print("  log %s" % line, flush=True)
        logs.append(line)

    trainer = k.trainer.Trainer(
        k.UPFlowConfig().updated(TRAIN_KNOBS),
        k.TrainerConfig(exp_dir=str(exp_dir), **TRAINER_CONF), dataset,
        bench, log_fn=log, weights=str(NPZ))
    step_fn = trainer.train_step
    steps = []

    def timed(state, batch):
        before = {n: fn.launches for n, fn in k.dispatch.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(
            step=state.step, ms=(time.perf_counter() - t0) * 1e3,
            launches={n: fn.launches - before[n]
                      for n, fn in k.dispatch.items()},
            metrics={key: float(v) for key, v in metrics.items()}))
        return state, metrics

    trainer.train_step = timed
    return trainer, step_fn, dict(logs=logs, steps=steps)


def same_state(a, b) -> bool:
    """Whether two state dicts (nested) hold the same values, tensors bit
    for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[x], b[x])
                                             for x in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_state, a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b.to(a.device))
    return a == b


def rel_diff(run_x, run_y, step, key):
    x = next(s for s in run_x["steps"] if s["step"] == step)["metrics"][key]
    y = next(s for s in run_y["steps"] if s["step"] == step)["metrics"][key]
    return abs(x - y) / abs(y)


def phase_trainer(k, tmp, fp32_busy):
    """Phase 7a: train, resume and compare, with the equivariance pass.
    Run A trains to step 2 (evaluation, checkpoint); run B, a fresh
    trainer in A's directory, resumes A's checkpoint, which must give A's
    parameters and optimizer state bit for bit, and trains to step 4; A
    goes on to step 3 from the same state, the uninterrupted step B's
    step 3 must equal bit for bit; run C trains 0 -> 4 in another
    directory, and B's parameters and optimizer state after step 4 must
    equal C's bit for bit, every step of A and B C's step of the same
    count.  Returns C's trainer, an eval pair and the trainer JSON
    object."""
    data = k.synthetic.make_dataset(**TRAINER_DATA)
    dataset = PairDataset(data)
    kw = dict(EVAL_REQUESTS["b1_375x1242_native"][0])
    pairs = k.synthetic.make_dataset(kw.pop("n_pairs"), **kw)
    ones = np.ones_like(pairs["gt_flow"][..., :1])
    bench = k.bench.EvaluationBench([k.bench.EvalSample(
        pairs["im1"][i:i + 1], pairs["im2"][i:i + 1],
        pairs["gt_flow"][i:i + 1], ones[i:i + 1], pairs["gt_flow"][i:i + 1],
        ones[i:i + 1]) for i in range(len(ones))])
    for fn in k.plain.values():
        fn.cuda_calls = 0
    a, _, run_a = make_trainer(k, tmp / "ab", dataset, bench)
    a.train(2)
    after_a = k.state_io.latest_step(a.ckpt_dir)
    b, _, run_b = make_trainer(k, tmp / "ab", dataset, bench)
    resumed = b.try_resume()
    start, cursor = b.state.step, b.loader.state()
    cursor = (cursor["epoch"], cursor["position"])
    restored = (same_state(a.model.state_dict(), b.model.state_dict()),
                same_state(a.optimizer.state_dict(),
                           b.optimizer.state_dict()))
    a.train(3)
    b.train(4)
    a.loader.close()
    b.loader.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer_c, step_fn, run_c = make_trainer(k, tmp / "c", dataset, bench)
    trainer_c.train(4)
    trainer_c.loader.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plain_calls = {n: fn.cuda_calls for n, fn in k.plain.items()}

    evals = [line for line in run_a["logs"] if line.startswith("eval @")]
    check(len(evals) == 1 and evals[0].startswith("eval @2: EPE All=")
          and after_a == 2,
          "trainer run A: one epoch, one eval line (%s), checkpoint at step "
          "%s" % (evals, after_a))
    check(resumed is True and start == 2 and cursor == (1, 0)
          and restored == (True, True),
          "trainer run B: try_resume %s at step %d, loader cursor %s (want "
          "True, 2, (1, 0)); parameters and optimizer state equal to A's at "
          "step 2 bit for bit: %s" % (resumed, start, cursor, restored))
    runs = (run_a, run_b, run_c)
    steps = [s for run in runs for s in run["steps"]]
    check([s["step"] for s in steps] == [1, 2, 3, 3, 4, 1, 2, 3, 4],
          "trainer runs A, B, C took steps %s" % [s["step"] for s in steps])
    bad = [(s["step"], s["launches"]) for s in steps
           if s["launches"] != EQ_LAUNCHES_PER_STEP]
    check(not bad, "trainer: every equivariance step launches %s (the "
          "teacher's forward and the student's; differing: %s)"
          % (EQ_LAUNCHES_PER_STEP, bad))
    finite = all(np.isfinite(v) for s in steps for v in s["metrics"].values())
    check(finite and all(s["metrics"]["eq_loss"] > 0 for s in steps),
          "trainer: every loss term finite, eq_loss > 0 (eq_loss %s)"
          % [round(s["metrics"]["eq_loss"], 6) for s in steps])
    check(all(v == 0 for v in plain_calls.values()),
          "trainer: no plain version ran on CUDA tensors: %s" % plain_calls)
    step3 = [next(s["metrics"] for s in run["steps"] if s["step"] == 3)
             for run in (run_b, run_a)]
    check(step3[0] == step3[1], "trainer: resumed B's step 3 equals A's "
          "uninterrupted step 3 from the same state bit for bit (B %s, A %s)"
          % tuple(step3))
    final = (same_state(b.model.state_dict(), trainer_c.model.state_dict()),
             same_state(b.optimizer.state_dict(),
                        trainer_c.optimizer.state_dict()))
    check(final == (True, True), "trainer: parameters and optimizer state "
          "of B and C after step 4 bit-equal: %s" % (final,))
    pb = torch.cat([p.detach().double().flatten()
                    for p in b.model.parameters()])
    pc = torch.cat([p.detach().double().flatten()
                    for p in trainer_c.model.parameters()])
    cos = float(pb @ pc / (pb.norm() * pc.norm()))
    print("  info trainer: parameters of B and C after step 4, cosine 1 - "
          "%.3e" % (1 - cos))
    # the step is deterministic, so two runs part at no step, before or
    # after a backward
    spread = {"%s@%d %s" % (key, step, pair): rel_diff(x, y, step, key)
              for key in ("total_loss", "eq_loss")
              for pair, x, y, at in (("A-C", run_a, run_c, (1, 2, 3)),
                                     ("B-C", run_b, run_c, (3, 4)))
              for step in at}
    check(all(v == 0.0 for v in spread.values()),
          "trainer: runs A and C at steps 1-3, B and C at steps 3-4 give "
          "the same losses (relative differences %s)"
          % {key: "%.2e" % v for key, v in spread.items()})
    times = [s["ms"] for run in runs for s in run["steps"][1:]]
    print("  info trainer: equivariance step %.1f ms median (%.1f-%.1f) "
          "over %d steps (each run's first left out); peak memory of run C "
          "%.2f GiB; eval line %s"
          % (statistics.median(times), min(times), max(times), len(times),
             peak, evals[0] if evals else None))

    batch = {key: torch.from_numpy(v[:4]).to(DEV)
             for key, v in data.items() if key != "gt_flow"}
    _, split, rules, busy, wall = profile_train_step(
        k, step_fn, trainer_c.state, batch, "trainer eq", forwards=True)
    student = None if split is None else split.get("student forward", 0.0)
    increment = (None if busy is None or fp32_busy is None
                 else (busy - fp32_busy) / busy)
    print("  info trainer eq step: student forward %s device ms (%s of "
          "device time); device time beyond phase 6's fp32 step %s ms (%s)"
          % (fmt(student), fmt(None if student is None else student / busy),
             fmt(None if increment is None else busy - fp32_busy),
             fmt(increment)))
    out = dict(batch=[4, 256, 832], eq_loss_weight=0.1,
               step_ms_median=statistics.median(times),
               step_ms_min=min(times), step_ms_max=max(times),
               timed_steps=len(times), peak_memory_gib=peak,
               launches_per_step=EQ_LAUNCHES_PER_STEP,
               resume_step3_bit_equal=step3[0] == step3[1],
               resume_state_bit_equal=final == (True, True),
               resume_param_cosine=cos,
               run_rel_loss_spread=spread,
               eval_line=evals[0] if evals else None,
               profiled_step=dict(wall_ms=wall, device_ms=busy,
                                  split_ms=split, backward_rule_ms=rules),
               student_forward_share=(None if student is None
                                      else student / busy),
               eq_device_share=increment)
    return trainer_c, (pairs["im1"][:1], pairs["im2"][:1]), out


def phase_pth(k, model_c, pair, tmp):
    """Phase 7b: C's model exported with ``params_to_torch_state_dict`` as
    a zip and a legacy ``.pth``, each loaded by ``Trainer.load_pretrained``
    into a fresh model, which must serve C's flow; then at bf16 from the
    zip file, after a forward with the fresh weights: the first forward
    after the load repacks every kernel-route conv and gives the flow of a
    bf16 model built from C's weights (an ``.npz`` snapshot of them)."""
    sd = k.torch_import.params_to_torch_state_dict(model_c)
    paths = {"zip": tmp / "c_zip.pth", "legacy": tmp / "c_legacy.pth"}
    torch.save(sd, paths["zip"])
    torch.save(sd, paths["legacy"], _use_new_zipfile_serialization=False)
    want = k.entry.forward(model_c, *pair)
    out = {}

    def fresh(knobs, name):
        trainer = k.trainer.Trainer(
            k.UPFlowConfig().updated(knobs),
            k.TrainerConfig(exp_dir=str(tmp / name), **TRAINER_CONF),
            [], log_fn=lambda line: print("  log %s" % line))
        trainer.loader.close()
        return trainer

    for fmt_name, path in paths.items():
        trainer = fresh(TRAIN_KNOBS, "pth_" + fmt_name)
        report = trainer.load_pretrained(str(path))
        got = k.entry.forward(trainer.model, *pair)
        differ = sum(int((got[key] != want[key]).sum())
                     for key in ("flow_f_out", "flow_b_out"))
        mean = max((got[key] - want[key]).abs().mean().item()
                   for key in ("flow_f_out", "flow_b_out"))
        check(len(report["loaded"]) == len(sd) and not report["skipped"],
              "pth %s: load_pretrained loaded %d of %d keys, skipped %s"
              % (fmt_name, len(report["loaded"]), len(sd),
                 report["skipped"]))
        check(differ == 0 or mean < 1e-6,
              "pth %s: B=1 375x1242 flow of the loaded model against C's: "
              "%d values differ, mean |diff| %.3e px%s"
              % (fmt_name, differ, mean, "" if differ == 0 else
                 " (not bit-equal: cuDNN's forward is not reproducible "
                 "here; mean below 1e-6 px)"))
        out[fmt_name] = dict(loaded=len(report["loaded"]),
                             skipped=len(report["skipped"]),
                             values_differ=differ, mean_abs_diff=mean)

    bf16 = dict(TRAIN_KNOBS, compute_dtype="bfloat16")
    trainer = fresh(bf16, "pth_bf16")
    k.entry.forward(trainer.model, *pair)
    report = trainer.load_pretrained(str(paths["zip"]))
    packs = k.seg.pack_weight.calls
    got = k.entry.forward(trainer.model, *pair)
    packs = k.seg.pack_weight.calls - packs
    npz = tmp / "c.npz"
    k.npz_io.save_params_npz(str(npz), model_c)
    ref = k.entry.forward(k.entry.build_model(
        k.UPFlowConfig().updated(bf16), weights=str(npz)), *pair)
    differ = sum(int((got[key] != ref[key]).sum())
                 for key in ("flow_f_out", "flow_b_out"))
    drift = (got["flow_f_out"] - want["flow_f_out"]).abs().mean().item()
    check(len(report["loaded"]) == len(sd) and packs == BF16_PACKERS
          and differ == 0,
          "pth bf16: loaded %d keys; the first forward after the load "
          "packed %d convs (%d); %d flow values differ from a bf16 model "
          "built from C's weights; bf16 against fp32 flow mean |diff| %.4f "
          "px" % (len(report["loaded"]), packs, BF16_PACKERS, differ, drift))
    out["bf16"] = dict(packs=packs, values_differ=differ,
                       mean_drift_vs_fp32=drift)
    return out


@contextlib.contextmanager
def recording(k):
    """Records every call of the kernels of ``RECORDED`` (tensor inputs
    cloned) while the model runs; yields {kernel: [(args, kwargs)]}."""
    calls = {name: [] for name in RECORDED}
    saved = []
    for name, ((owner, attr), _, _) in RECORDED.items():
        mod = getattr(k, owner)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def spy(*args, name=name, fn=fn, **kwargs):
            calls[name].append(([a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args], kwargs))
            return fn(*args, **kwargs)

        # the kernel's launch path counts on the module attribute, now the
        # spy: a copy of the counters takes this comparison's launches
        spy.__dict__.update(vars(fn))
        setattr(mod, attr, spy)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def phase_learn(k):
    """Phase 7c: every kernel of the learning run's path held against its
    plain version at the run's level shapes, then the JAX package's
    synthetic-learning recipe trained through ``make_train_step``.
    Returns the EPE curve."""
    data = k.synthetic.make_dataset(**LEARN_DATA)
    gt = data.pop("gt_flow")
    data = {key: torch.from_numpy(v).to(DEV) for key, v in data.items()}
    conf = k.UPFlowConfig().updated(LEARN_KNOBS)
    model, state, opt = k.step.create_train_state(
        conf, k.TrainerConfig(lr=LEARN_LR), seed=0)

    with recording(k) as calls:
        k.entry.forward(model, data["im1"][:LEARN_BATCH],
                        data["im2"][:LEARN_BATCH])
    for name, ((owner, attr), (p_owner, p_attr), bar) in RECORDED.items():
        kernel = getattr(getattr(k, owner), attr)
        plain = getattr(getattr(k, p_owner), p_attr)
        shapes, errs, failed = [], [], []
        for args, kwargs in calls[name]:
            got, ref = kernel(*args, **kwargs), plain(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            scale = max(r.float().abs().max().item() for r in ref)
            shapes.append(tuple(args[0].shape))
            errs.append(err)
            if not (all(torch.equal(g, r) for g, r in zip(got, ref))
                    if bar is None else err <= bar * scale):
                failed.append((shapes[-1], err))
        check(len(shapes) == LEARN_LAUNCHES_PER_STEP[name] and not failed,
              "learning path: %s against its plain version at all %d calls "
              "of a forward (%s), shapes %s: max abs err %.3e; failing %s"
              % (name, len(shapes), "bit for bit" if bar is None
                 else "bar %g x max|out|" % bar, sorted(set(shapes)),
                 max(errs, default=0.0), failed))
    for fn in k.plain.values():
        fn.cuda_calls = 0

    step_fn = k.step.make_train_step(model, opt)

    def eval_epe():
        es = [k.synthetic.epe(k.entry.forward(
            model, data["im1"][i:i + LEARN_BATCH],
            data["im2"][i:i + LEARN_BATCH])["flow_f_out"].cpu().numpy(),
            gt[i:i + LEARN_BATCH])
            for i in range(0, len(gt), LEARN_BATCH)]
        return float(np.mean(es))

    gt_mag = float(np.linalg.norm(gt, axis=-1).mean())
    curve = [(0, eval_epe())]
    rng = np.random.RandomState(1)
    bad = []
    t0 = time.perf_counter()
    for i in range(1, LEARN_STEPS + 1):
        idx = torch.from_numpy(rng.choice(len(gt), LEARN_BATCH,
                                          replace=False)).to(DEV)
        before = {n: fn.launches for n, fn in k.dispatch.items()}
        state, metrics = step_fn(state, {key: v[idx]
                                         for key, v in data.items()})
        delta = {n: fn.launches - before[n] for n, fn in k.dispatch.items()}
        if delta != LEARN_LAUNCHES_PER_STEP or not np.isfinite(
                float(metrics["total_loss"])):
            bad.append((i, delta, float(metrics["total_loss"])))
        if i in LEARN_EPE_AT:
            curve.append((i, eval_epe()))
    seconds = time.perf_counter() - t0
    plain_calls = sum(fn.cuda_calls for fn in k.plain.values())
    check(not bad and plain_calls == 0,
          "learning: every step launches %s with a finite loss, no plain "
          "version on CUDA tensors (%d calls; differing steps %s)"
          % (LEARN_LAUNCHES_PER_STEP, plain_calls, bad[:3]))
    e0, e1 = curve[0][1], curve[-1][1]
    print("  info learning: EPE against the exact flow %s (mean flow %.2f "
          "px); %d steps in %.1f s"
          % (", ".join("step %d %.3f" % c for c in curve), gt_mag,
             LEARN_STEPS, seconds))
    check(e0 > 3.0 * gt_mag and e1 < 1.2 and e1 < 0.25 * e0,
          "learning: EPE %.3f -> %.3f px (start > 3 x %.2f, end < 1.2 and "
          "< 0.25 x start)" % (e0, e1, gt_mag))
    return dict(epe=curve, gt_mean_px=gt_mag, steps=LEARN_STEPS,
                seconds=seconds, batch=[LEARN_BATCH, 64, 160])


# --- phase 8: the KITTI and Sintel data path -------------------------------
# 8a: the decode-level shapes that the datasets' other frame sizes bring:
# KITTI 2015's 376x1241 (odd full-resolution width), 370x1224 and 374x1238
# (odd widths 153, 77, 155) at B=1, Sintel's 436x1024 frame (odd heights
# 109, 55, 7) at B=1 and its 384x768 training crop at B=4
SHAPE_SIZES = ((1, 376, 1241), (1, 370, 1224), (1, 374, 1238),
               (1, 436, 1024), (4, 384, 768))
# the trees of scripts/torch_synthetic_trees.py, from the seed that
# upflow_pytorch_tpu_torch/eval/jax_dataset_reference.json was made with
TREE_SEED = 0
DATASET_REFERENCE = ROOT / "upflow_pytorch_tpu_torch" / "eval" / \
    "jax_dataset_reference.json"
# the port's bench against the JAX package's on the trees: EPE-all and
# EPE-noc in px, EPE-occ (over the few out-of-frame pixels) in px, F1 in
# points (phase 5 saw F1 0.12 points apart at 375x1242, so a wider bar)
DATASET_BARS = {"epe_all": 0.02, "epe_noc": 0.02, "epe_occ": 0.1,
                "f1": 0.5}
# 8d: one epoch of KITTI_STEPS steps (evaluation and checkpoint at its
# end), then RESUME_STEPS more after --resume; 8e: SINTEL_STEPS steps
KITTI_STEPS, RESUME_STEPS, SINTEL_STEPS = 8, 2, 3
KITTI_PROFILED = (2, 4)  # 8d's steps under the profiler
FRAMES_A_STEP = 8  # a B=4 step reads two frames an item


def encode_filtered_png(path, img, filters=(1, 2, 3, 4)):
    """A PNG of the uint8 (H, W, 3) ``img`` whose row y is filtered by
    ``filters[y % len(filters)]`` (1 Sub, 2 Up, 3 Average, 4 Paeth), which
    the port's ``write_png`` never writes; KITTI's own PNGs use them."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        line = rows[y]
        up = rows[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        f = filters[y % len(filters)]
        if f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8)
                   .tobytes())

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out), 6)))
        fh.write(chunk(b"IEND", b""))


def launches_from_zero(k):
    for fn in k.dispatch.values():
        fn.launches = 0
    for fn in k.plain.values():
        fn.cuda_calls = 0


def launch_counts(k):
    """(kernel launches, plain-version calls on CUDA tensors) since
    ``launches_from_zero``."""
    torch.cuda.synchronize()
    return ({n: fn.launches for n, fn in k.dispatch.items()},
            sum(fn.cuda_calls for fn in k.plain.values()))


def phase_shapes(k):
    """Phase 8a: every kernel of the CLI path against its plain version at
    the decode-level shapes of ``SHAPE_SIZES`` under phase 2's bars:
    correlation (every level), feature_warp, corr_norm (levels 1-4) at
    fp32 and bf16, sgu_blend (levels 1-4, three inter-flow tiers) and the
    image warp and sgu_final at full resolution at fp32; conv3x3_seg at
    every conv shape of the bf16 forward, on its own staging route and,
    where that is TMA, also on the pitched route (the input one bf16
    element off a 16-byte boundary).  A bf16 forward at each size must
    launch conv3x3_seg as often as those shapes say."""
    held = {}

    def hold(name, ok, what):
        check(ok, "8a " + what)
        held[name] = held.get(name, 0) + 1

    rng = np.random.RandomState(8)
    gen = torch.Generator(device=DEV).manual_seed(8)
    bf16_model = k.entry.build_model(k.UPFlowConfig().updated(BF16_KNOBS),
                                     weights=str(NPZ))
    out = {"B=%d %dx%d" % size: hold_frame(k, *size, rng, gen, hold,
                                           bf16_model, "8a")
           for size in SHAPE_SIZES}
    del bf16_model
    return dict(sizes=out, shapes_held=held)


def hold_frame(k, b, h, w, rng, gen, hold, bf16_model, tag):
    """Phase 8a's checks at one b x h x w frame: each kernel against its
    plain version at the frame's decode-level shapes (``hold(kernel, ok,
    what)`` records each), then one bf16 forward of ``bf16_model`` whose
    conv3x3_seg launches, by route, must be those the shapes say.  The
    random inputs come from ``rng`` and ``gen``."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    def close(got, ref, share):
        err = (got.float() - ref.float()).abs().max().item()
        bar = share * ref.float().abs().max().item()
        return err, bar

    size = "B=%d %dx%d" % (b, h, w)
    levels = pyramid_hw(h, w)
    for level, (lh, lw) in enumerate(levels):
        c = PYRAMID_CHS[level]
        amp = max(2.0, min(40.0, lw / 4))
        f1 = randn(b, c, lh, lw)
        f2 = randn(b, c, lh, lw) * 2 + 0.5
        x32 = randn(b, 32, lh, lw) * 2 + 0.5
        flow = make_flow(rng, b, lh, lw, amp)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            a1, a2 = f1.to(dtype), f2.to(dtype)
            got = k.corr.correlation(a1, a2)
            again = k.corr.correlation(a1, a2)
            err, bar = close(got, k.corr.correlation_plain(a1, a2), 1e-5)
            route = k.corr.staging_route(lw, a1.element_size(),
                                         a1.data_ptr(), a2.data_ptr())
            hold("correlation", err <= bar and torch.equal(got, again),
                 "%s correlation %s L%d %s (%s staging): max abs err "
                 "%.3e (bar %.3e), a second call the same bits"
                 % (size, dn, level, (b, c, lh, lw), route, err, bar))
            if level == 0:
                continue
            for what, x in (("cost volume", a2), ("SGU", x32.to(dtype))):
                warped, mask = k.fw.feature_warp(x, flow, 1.0,
                                                 with_mask=True)
                ref, ref_mask = k.fw.feature_warp_plain(x, flow, 1.0,
                                                        with_mask=True)
                differ = int((warped != ref).sum().item())
                flips = int((mask != ref_mask).sum().item())
                share = mask.mean().item()
                hold("feature_warp", differ == 0 and flips == 0
                     and 0.0 < share < 1.0,
                     "%s feature_warp %s %s L%d %s, flow +-%g px: %d "
                     "values and %d mask bits differ, valid share %.4f"
                     % (size, dn, what, level, tuple(x.shape), amp,
                        differ, flips, share))
                if what == "SGU":
                    continue
                aff = k.cn.affine_pair(*k.cn.moments(a1, False),
                                       *k.cn.moments(warped, False),
                                       NORM_KW)
                got = k.cn.corr_norm(a1, warped, aff, 0.1)
                again = k.cn.corr_norm(a1, warped, aff, 0.1)
                err, bar = close(got, k.cn.corr_norm_plain(
                    a1, warped, aff, 0.1), 1e-5)
                route = k.cn.staging_route(lw, a1.element_size(),
                                           a1.data_ptr(),
                                           warped.data_ptr())
                hold("corr_norm", err <= bar and torch.equal(got, again),
                     "%s corr_norm %s L%d %s (%s staging): max abs err "
                     "%.3e (bar %.3e), a second call the same bits"
                     % (size, dn, level, (b, c, lh, lw), route, err,
                        bar))
        if level == 0:
            continue
        flows = [flow, make_flow(rng, b, lh, lw, amp)]
        pix, rows_, blocks = k.sb.launch_config(2, b, lh, lw)
        for tier, (amp_u, amp_v) in (("fused", (1.5, 1.5)),
                                     ("medium", (30.0, 15.0)),
                                     ("beyond", (300.0, 300.0))):
            heads = [torch.cat([
                (randn(b, 1, lh, lw).clamp(-3, 3) / 3) * amp_u,
                (randn(b, 1, lh, lw).clamp(-3, 3) / 3) * amp_v,
                randn(b, 1, lh, lw) * 3], dim=1) for _ in range(2)]
            args = (flows[0], heads[0], flows[1], heads[1])
            got = k.sb.sgu_blend_pair(*args)
            ref = k.sb.sgu_blend_pair_plain(*args)
            differ, ulps = ulp_report(got, ref)
            masks = [torch.sigmoid(x[:, 2:3]) for x in heads]
            one = [k.sb.sgu_blend(fl, x[:, :2].contiguous(), m)
                   for fl, x, m in zip(flows, heads, masks)]
            one_differ, _ = ulp_report(one, ref)
            hold("sgu_blend", differ == 0 and one_differ == 0,
                 "%s sgu_blend L%d %s both directions (%d pixels a "
                 "thread, %d-row blocks, %d blocks), inter-flow "
                 "+-%g/+-%g px: %d values differ (max %d ulp), one "
                 "direction %d" % (size, level, (b, 3, lh, lw), pix,
                                   rows_, blocks, amp_u, amp_v, differ,
                                   ulps, one_differ))
    # the occlusion check's image warp and the final SGU stage at full
    # resolution
    flow_src = make_flow(rng, b, h, w, 40.0)
    flow = make_flow(rng, b, h, w, 40.0)
    got = k.warp.warp(flow_src, flow)
    ref = k.warp.warp_plain(flow_src, flow)
    err = (got - ref).abs().max().item()
    hold("warp", err <= 1e-6,
         "%s warp %s, flow +-40 px: max abs err %.3e, %d of %d values "
         "differ" % (size, tuple(flow_src.shape), err,
                     int((got != ref).sum().item()), got.numel()))
    hq, wq = levels[4]
    flow_q = make_flow(rng, b, hq, wq, 10.0)
    for amp in (0.4, 9.0, 75.0):
        x_out = torch.cat([randn(b, 2, hq, wq).clamp(-3, 3) / 3 * amp,
                           randn(b, 1, hq, wq) * 3], dim=1)
        got = k.sf.sgu_final(flow_q, x_out, (h, w))
        ref = k.sf.sgu_final_plain(flow_q, x_out, (h, w))
        err = (got - ref).abs().max().item()
        hold("sgu_final", tuple(got.shape) == (b, 2, h, w)
             and err <= 1e-4,
             "%s sgu_final %s -> %s (tile %dx%d, %s stores), "
             "inter-flow +-%g px: max abs err %.3e px (<= 1e-4)"
             % (size, tuple(x_out.shape), (b, 2, h, w),
                k.sf.tile_rows(b, h, w), k.sf.TILE_W,
                "16-byte" if w % 4 == 0 else "4-byte", amp, err))
    # conv3x3_seg at every conv shape of the bf16 forward at this size
    routes = {"tma": 0, "pitched": 0}
    for what, cb, ch, cw, cin, cout, d, relu, per_forward, buf in \
            conv_shapes(b, (h, w), ragged=False):
        weight = randn(cout, cin, 3, 3) * (2.0 / (9 * cin)) ** 0.5
        bias = randn(cout) * 0.1
        for offset in (0, 1):
            chans = cin if buf is None else buf[0]
            flat = torch.empty(cb * chans * ch * cw + offset,
                               dtype=torch.bfloat16, device=DEV)
            full = flat[offset:].view(cb, chans, ch, cw)
            full.copy_(randn(cb, chans, ch, cw))
            if buf is None:
                x = full
                dst = torch.empty((cb, cout, ch, cw),
                                  dtype=torch.bfloat16, device=DEV)
            else:
                x = full[:, buf[1]:buf[1] + cin]
                dst = (full[:, buf[1] - cout:buf[1]] if buf[1] >= cout
                       else torch.empty((cb, cout, ch, cw),
                                        dtype=torch.bfloat16,
                                        device=DEV))
            route = k.seg.staging_route(cw, x.stride(0), x.data_ptr())
            if offset == 0:
                routes[route] += per_forward
            before = dict(k.seg.conv3x3_seg.route_launches)
            ref = k.seg.conv3x3_seg_plain(x, weight, bias, d,
                                          relu).float()
            got = k.seg.conv3x3_seg(x, weight, bias, d, relu,
                                    out=dst).float()
            ran = {r: n - before[r]
                   for r, n in k.seg.conv3x3_seg.route_launches.items()}
            _, stats = conv_agreement(got, ref)
            hold("conv3x3_seg", stats[0] and ran[route] == 1
                 and sum(ran.values()) == 1,
                 "%s conv3x3_seg %s (%d, %d->%d, %dx%d, d=%d), %s route%s "
                 "(launches %s): %s"
                 % (size, what, cb, cin, cout, ch, cw, d, route,
                    " (forced, input 2 bytes off)" if offset else "",
                    ran, stats[1]))
            if offset == 0 and route != "tma":
                break
    # a bf16 forward at this size launches conv3x3_seg where the shapes
    # say, by these routes
    im1, im2 = textured_pair(b, h, w, seed=b * h + w)
    launches_from_zero(k)
    before = dict(k.seg.conv3x3_seg.route_launches)
    k.entry.forward(bf16_model, im1, im2)
    got, _ = launch_counts(k)
    ran = {r: n - before[r]
           for r, n in k.seg.conv3x3_seg.route_launches.items()}
    want = sum(routes.values())
    check(got["conv3x3_seg"] == want and ran == routes,
          "%s %s bf16 forward: conv3x3_seg launched %d times by route "
          "%s (the shapes above: %d, %s)"
          % (tag, size, got["conv3x3_seg"], ran, want, routes))
    names = ["%dx%d" % hw for hw in levels]
    print("  info %s %s: decode levels %s, conv3x3_seg routes of a bf16 "
          "forward %s" % (tag, size, names, ran), flush=True)
    return dict(conv3x3_seg_route_launches=ran, levels=names)


def phase_native(k, root, tmp):
    """Phase 8b: the native decoder's state, every PNG of the trees decoded
    by it and by the Python codec (bit for bit), and one 375x1242 RGB PNG
    whose rows use filters 1-4 timed through each."""
    nat = k.native
    built = nat.available()
    if built:
        print("  native: built %s" % nat.library_path())
    else:
        print("  native: not built: %s" % nat.build_error())
    out = dict(built=built, build_error=nat.build_error(),
               library=str(nat.library_path()) if built else None)
    pngs = sorted(Path(root).rglob("*.png"))
    if built:
        differ = []
        for p in pngs:
            got, ref = nat.decode_png(str(p)), k.flow_io.read_png(str(p))
            if got.dtype != ref.dtype or not np.array_equal(got, ref):
                differ.append(p.name)
            if p.parent.name in ("flow_occ", "flow_noc"):
                got, ref = (nat.decode_flow_png(str(p)),
                            k.flow_io.read_flow_png(str(p)))
                if not all(np.array_equal(g, r) for g, r in zip(got, ref)):
                    differ.append(p.name + " (flow)")
        check(not differ, "8b native decode of the trees' %d PNGs equals the "
              "Python codec's bit for bit (differing: %s)"
              % (len(pngs), differ[:5]))
        out["pngs_compared"] = len(pngs)
    frame = next(p for p in pngs if p.parent.name == "image_2")
    img = k.flow_io.read_png(str(frame))
    filtered = tmp / "filtered_rows.png"
    encode_filtered_png(str(filtered), img)
    times = {}
    decoders = {"python": k.flow_io.read_png}
    if built:
        decoders["native"] = nat.decode_png
    for name, fn in decoders.items():
        runs = 1 if name == "python" else 11
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            got = fn(str(filtered))
            ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got, img), "8b %s decoder: the PNG with filters "
              "1-4 decodes to the frame" % name)
        times[name] = statistics.median(ms)
        print("  info 8b %s decoder, %dx%d RGB PNG with filters 1-4: %.2f ms "
              "a frame (median of %d), %.1f frames a second, %.1f ms of "
              "decode for the %d frames of a B=4 step on one thread"
              % (name, img.shape[0], img.shape[1], times[name], runs,
                 1e3 / times[name], FRAMES_A_STEP * times[name],
                 FRAMES_A_STEP))
    out["filtered_png_ms"] = times
    out["frame"] = list(img.shape)
    return out


@contextlib.contextmanager
def timed_eval_forward(k):
    """Times each ``NetEvalModel.eval_forward`` (its result is a host
    array, so the card has finished) and keeps its prediction; yields
    the list of (frame (h, w), ms, prediction)."""
    calls = []
    orig = k.trainer.NetEvalModel.eval_forward

    def timed(self, im1, im2, *args):
        t0 = time.perf_counter()
        flow = orig(self, im1, im2, *args)
        calls.append((tuple(im1.shape[1:3]),
                      (time.perf_counter() - t0) * 1e3, flow))
        return flow

    k.trainer.NetEvalModel.eval_forward = timed
    try:
        yield calls
    finally:
        k.trainer.NetEvalModel.eval_forward = orig


def per_size_ms(calls):
    """{"HxW": {"first": ms, "later": [ms, ...]}} in call order."""
    out = {}
    for hw, ms, _ in calls:
        key = "%dx%d" % hw
        if key not in out:
            out[key] = {"first": ms, "later": []}
        else:
            out[key]["later"].append(ms)
    return out


def against_reference(what, res, ref, gate):
    """Prints (and with ``gate`` checks) a bench result against the JAX
    package's under ``DATASET_BARS``; returns the differences."""
    diffs = {m: getattr(res, m) - ref[m] for m in DATASET_BARS}
    line = ", ".join("%s %.4f (JAX %.4f, %+.4f, bar %g)"
                     % (m, getattr(res, m), ref[m], d, DATASET_BARS[m])
                     for m, d in diffs.items())
    finite = all(np.isfinite(v) for v in res)
    if gate:
        check(finite and all(abs(d) <= DATASET_BARS[m]
                             for m, d in diffs.items()), "%s: %s"
              % (what, line))
    else:
        check(finite, "%s: finite; %s" % (what, line))
    return diffs


def phase_kitti_eval(k, root, tmp, pth, ref):
    """Phase 8c: ``scripts/torch_kitti_eval.py`` on the KITTI trees with
    the ``.pth``: the 2015 training split at native size and padded to
    multiples of 64, each held to the JAX package's bench, the 2012 pair,
    and the 2015 test split (no metrics); each lane writes its flows with
    ``--save-dir``, which must equal the predictions as ``write_flow_png``
    writes them.  Launches counted from 0 a lane."""
    # lane, its flags, and whether its result is held to the JAX
    # package's (True), printed beside it (False) or absent (None: the
    # test split)
    lanes = (("kitti2015_native", [], True),
             ("kitti2015_pad64", ["--pad-multiple", "64"], True),
             ("kitti2012_native", ["--split", "2012_train"], False),
             ("kitti2015_test", ["--split", "2015_test"], None))
    out = {}
    for lane, extra, gate in lanes:
        save = tmp / ("save_" + lane)
        argv = ["--data-root", str(root), "--ckpt", str(pth),
                "--save-dir", str(save)] + extra
        launches_from_zero(k)
        with timed_eval_forward(k) as calls:
            res = k.cli["kitti_eval"].main(argv)
        got, plain_calls = launch_counts(k)
        pairs = len(calls)
        want = {n: c * pairs for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
        check(pairs > 0 and got == want and plain_calls == 0,
              "8c %s: %d pairs launched %s, %d plain calls on CUDA tensors"
              % (lane, pairs, got, plain_calls))
        files = list(save.iterdir())
        if gate is None:
            order = sorted(files)
        else:
            order = sorted(files, key=lambda p: int(p.stem.split("__")[-1]))
        same = 0
        for path, (_, _, pred) in zip(order, calls):
            k.flow_io.write_flow_png(str(tmp / "want.png"), pred[0])
            same += path.read_bytes() == (tmp / "want.png").read_bytes()
        check(len(files) == pairs and same == pairs,
              "8c %s: --save-dir wrote %d PNGs for %d pairs, %d equal to the "
              "prediction as write_flow_png writes it"
              % (lane, len(files), pairs, same))
        sizes = per_size_ms(calls)
        print("  info 8c %s: ms a pair by frame size (first call, later "
              "calls): %s" % (lane, {s: (round(v["first"], 1),
                                         [round(x, 1) for x in v["later"]])
                                     for s, v in sizes.items()}))
        entry = dict(pairs=pairs, launches=got, ms_a_pair=sizes)
        if gate is None:
            check(res is None, "8c %s: the test split prints no metrics"
                  % lane)
        else:
            entry["result"] = res._asdict()
            entry["minus_jax"] = against_reference(
                "8c %s against the JAX package's bench" % lane, res,
                ref["lanes"][lane], gate)
        out[lane] = entry
    return out


@contextlib.contextmanager
def watched_training(k, profile_steps=None):
    """Records each training step that a ``Trainer`` built inside the block
    takes (ms up to the device's end, kernel launches, loss terms) and the
    time each ``DataLoader.__next__`` waited; with ``profile_steps`` =
    (first, last), profiles those steps and the loader waits between them
    and records the device's busy share of that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rec = dict(steps=[], waits=[], busy=None,
               profiled=(set(range(profile_steps[0], profile_steps[1] + 1))
                         if profile_steps else set()))
    prof = {}
    orig_make, orig_next = (k.trainer.make_train_step,
                            k.pipeline.DataLoader.__next__)

    def make(*args, **kwargs):
        step_fn = orig_make(*args, **kwargs)

        def step(state, batch):
            n = len(rec["steps"]) + 1
            if profile_steps and n == profile_steps[0]:
                prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                prof["p"].__enter__()
                prof["t0"] = time.perf_counter()
            before = {m: fn.launches for m, fn in k.dispatch.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                launches={m: fn.launches - before[m]
                          for m, fn in k.dispatch.items()},
                metrics={key: float(v) for key, v in metrics.items()}))
            if profile_steps and n == profile_steps[1]:
                wall = (time.perf_counter() - prof["t0"]) * 1e3
                prof["p"].__exit__(None, None, None)
                busy = sum(e.time_range.elapsed_us()
                           for e in prof["p"].events()
                           if e.device_type == DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)
                           ) / 1e3
                rec["busy"] = dict(steps=list(profile_steps), wall_ms=wall,
                                   device_ms=busy,
                                   share=busy / wall if busy else None)
            return state, metrics

        return step

    def next_(self):
        t0 = time.perf_counter()
        batch = orig_next(self)
        rec["waits"].append((time.perf_counter() - t0) * 1e3)
        return batch

    k.trainer.make_train_step = make
    k.pipeline.DataLoader.__next__ = next_
    try:
        yield rec
    finally:
        k.trainer.make_train_step = orig_make
        k.pipeline.DataLoader.__next__ = orig_next


def step_summary(what, runs):
    """Step ms (median and range) and the loader's share of each step
    (its wait before the step over both), each run's first step and its
    profiled steps left out, and the profiled window's device busy
    share."""
    ms, shares = [], []
    for rec in runs:
        for i, (s, w) in enumerate(zip(rec["steps"], rec["waits"])):
            if i and i + 1 not in rec["profiled"]:
                ms.append(s["ms"])
                shares.append(w / (w + s["ms"]))
    busy = next((rec["busy"] for rec in runs if rec["busy"]), None)
    out = dict(steps=sum(len(rec["steps"]) for rec in runs), timed=len(ms),
               step_ms_median=statistics.median(ms), step_ms_min=min(ms),
               step_ms_max=max(ms),
               loader_wait_share_median=statistics.median(shares),
               loader_wait_share_max=max(shares),
               first_step_ms=[rec["steps"][0]["ms"] for rec in runs],
               first_wait_ms=[rec["waits"][0] for rec in runs], busy=busy)
    print("  info %s: %.1f ms median (%.1f-%.1f) over %d steps, loader wait "
          "%.2f%% of a step median (max %.2f%%); first steps %s ms after "
          "waits of %s ms; device busy %s"
          % (what, out["step_ms_median"], out["step_ms_min"],
             out["step_ms_max"], len(ms),
             100 * out["loader_wait_share_median"],
             100 * out["loader_wait_share_max"],
             [round(x, 1) for x in out["first_step_ms"]],
             [round(x, 1) for x in out["first_wait_ms"]],
             "n/a" if busy is None or busy["share"] is None else
             "%.1f of %.1f ms (%.1f%%) over steps %d-%d under the profiler"
             % (busy["device_ms"], busy["wall_ms"], 100 * busy["share"],
                *busy["steps"])))
    return out


def phase_kitti_train(k, root, tmp, pth):
    """Phase 8d: ``scripts/torch_train_kitti.py`` from the ``.pth`` at
    B=4 on the multiview tree, one epoch of ``KITTI_STEPS`` steps ending
    with an evaluation on the KITTI 2015 tree and a checkpoint, then
    ``--resume`` for ``RESUME_STEPS`` more: every step launches the
    forward's kernels, every loss term is finite, the resumed run starts
    at the checkpoint's step."""
    cli = k.cli["train_kitti"]
    base = ["--mv-root", str(root), "--eval-root", str(root), "--exp-dir",
            str(tmp / "kitti_exp"), "--batch", "4", "--batch-per-epoch",
            str(KITTI_STEPS)]
    launches_from_zero(k)
    with watched_training(k, KITTI_PROFILED) as run1:
        first = cli.main(base + ["--pretrained", str(pth), "--steps",
                                 str(KITTI_STEPS)])
    got1, plain1 = launch_counts(k)
    saved = k.state_io.latest_step(first.ckpt_dir)
    launches_from_zero(k)
    with watched_training(k) as run2:
        second = cli.main(base + ["--resume", "--steps",
                                  str(KITTI_STEPS + RESUME_STEPS)])
    got2, plain2 = launch_counts(k)
    evals = len(k.kitti.scan_eval_files(str(root), "2015_train"))
    want1 = {n: c * (KITTI_STEPS + evals)
             for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
    want2 = {n: c * RESUME_STEPS for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
    check(got1 == want1 and got2 == want2 and plain1 == plain2 == 0,
          "8d launches: run 1 (%d steps and %d eval pairs) %s, resumed run "
          "(%d steps) %s; plain calls on CUDA tensors %d, %d"
          % (KITTI_STEPS, evals, got1, RESUME_STEPS, got2, plain1, plain2))
    steps = run1["steps"] + run2["steps"]
    finite = all(np.isfinite(v) for s in steps for v in s["metrics"].values())
    check(saved == KITTI_STEPS and len(run1["steps"]) == KITTI_STEPS
          and len(run2["steps"]) == RESUME_STEPS
          and second.state.step == KITTI_STEPS + RESUME_STEPS and finite,
          "8d: checkpoint at step %s, run 1 took %d steps, the resumed run "
          "%d to step %d; every loss term finite (total %s)"
          % (saved, len(run1["steps"]), len(run2["steps"]),
             second.state.step,
             [round(s["metrics"]["total_loss"], 4) for s in steps]))
    out = step_summary("8d KITTI B=4 256x832 step", (run1, run2))
    out["total_loss"] = [s["metrics"]["total_loss"] for s in steps]
    return out


def phase_sintel(k, root, tmp, pth, ref):
    """Phase 8e: ``SintelEvalDataset`` (final pass, 436x1024) through the
    port's bench, held to the JAX package's; then
    ``scripts/torch_train_sintel.py`` at ``--crop 384 768 --batch 4``."""
    model = k.entry.build_model(k.cli["kitti_eval"].EVAL_CONF)
    k.torch_import.load_pretrained_params(str(pth), model)
    dataset = k.sintel.SintelEvalDataset(str(root), "final")
    launches_from_zero(k)
    with timed_eval_forward(k) as calls:
        res = k.bench.EvaluationBench(dataset)(k.trainer.NetEvalModel(model))
    got, plain_calls = launch_counts(k)
    want = {n: c * len(dataset) for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
    check(got == want and plain_calls == 0,
          "8e Sintel final: %d pairs launched %s, %d plain calls on CUDA "
          "tensors" % (len(dataset), got, plain_calls))
    del model
    out = dict(result=res._asdict(), ms_a_pair=per_size_ms(calls))
    out["minus_jax"] = against_reference(
        "8e Sintel final 436x1024 against the JAX package's bench", res,
        ref["lanes"]["sintel_final_native"], True)
    print("  info 8e Sintel ms a pair: %s" % {
        s: (round(v["first"], 1), [round(x, 1) for x in v["later"]])
        for s, v in out["ms_a_pair"].items()})
    launches_from_zero(k)
    with watched_training(k) as run:
        trainer = k.cli["train_sintel"].main([
            "--root", str(root), "--exp-dir", str(tmp / "sintel_exp"),
            "--crop", "384", "768", "--batch", "4", "--steps",
            str(SINTEL_STEPS), "--pretrained", str(pth)])
    got, plain_calls = launch_counts(k)
    want = {n: c * SINTEL_STEPS for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
    finite = all(np.isfinite(v) for s in run["steps"]
                 for v in s["metrics"].values())
    check(trainer.state.step == SINTEL_STEPS and got == want
          and plain_calls == 0 and finite,
          "8e Sintel training at B=4 384x768: %d steps launched %s, %d plain "
          "calls on CUDA tensors, every loss term finite (total %s)"
          % (trainer.state.step, got, plain_calls,
             [round(s["metrics"]["total_loss"], 4) for s in run["steps"]]))
    out["train"] = step_summary("8e Sintel B=4 384x768 step", (run,))
    return out


def phase_demo(k):
    """Phase 8f: ``demo.demo()`` on the card."""
    t0 = time.perf_counter()
    res = k.demo.demo()
    ms = (time.perf_counter() - t0) * 1e3
    keys = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw", "im1_warp",
            "im2_warp")
    ok = (all(res[key].is_cuda and bool(torch.isfinite(res[key]).all())
              for key in keys)
          and all(np.isfinite(float(res[key])) for key in (
              "smooth_loss", "photo_loss", "census_loss", "msd_loss",
              "total_loss")))
    check(ok, "8f demo on %s: every output finite, total loss %.4f, %.0f ms"
          % (res["flow_f_out"].device, float(res["total_loss"]), ms))
    return dict(ms=ms, total_loss=float(res["total_loss"]))


def phase_data(k, tmp):
    """Phase 8: the trees, then 8b-8f; prints one JSON line a step."""
    ref = json.loads(DATASET_REFERENCE.read_text())
    print("  info JAX reference: %s (%s)" % (ref["source"], ref["command"]))
    check(ref["seed"] == TREE_SEED, "8: the reference was made from the "
          "trees' seed %d" % TREE_SEED)
    root = tmp / "trees"
    t0 = time.perf_counter()
    splits = k.cli["trees"].write_trees(str(root), TREE_SEED)
    print("  info trees written in %.1f s: %s"
          % (time.perf_counter() - t0, {n: len(s) for n, s in splits.items()}))
    pth = tmp / "synthetic_trained.pth"
    model = k.entry.build_model(k.cli["kitti_eval"].EVAL_CONF,
                                weights=str(NPZ))
    torch.save(k.torch_import.params_to_torch_state_dict(model), pth)
    del model
    for name, fn in (("8b", lambda: phase_native(k, root, tmp)),
                     ("8c", lambda: phase_kitti_eval(k, root, tmp, pth, ref)),
                     ("8d", lambda: phase_kitti_train(k, root, tmp, pth)),
                     ("8e", lambda: phase_sintel(k, root, tmp, pth, ref)),
                     ("8f", lambda: phase_demo(k))):
        t0 = time.perf_counter()
        print("phase %s" % name, flush=True)
        res = fn()
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase_" + name: res}), flush=True)
    return root, pth


# phase 9: data parallelism (parallel/) on the one card.  9a: a one-rank
# NCCL group runs phase 6's step at both precisions against the single
# process's; 9b: two processes on the card over gloo (NCCL takes one rank
# a device) at B=2 each against one process at B=4, at the reference's
# threshold, at 0.9999, and at 0.9999 with the equivariance pass; 9c: the
# KITTI training CLI as torchrun starts it, one rank over NCCL.
PARALLEL_LOSS_BAR = 1e-3
# every loss term at threshold 0.9999, the CPU test's bar
# (tests/test_torch_port_parallel.py::ROBUST_LOSS_BAR)
PARALLEL_ROBUST_LOSS_BAR = 1e-5
PARALLEL_PARAM_COSINE_BAR = 0.99999
PARALLEL_GRAD_COSINE_BAR = 0.9999
PARALLEL_TIMED_STEPS = 3
# name: (mask threshold, eq_loss_weight, kernel launches of one step)
PARALLEL_JOBS = {"threshold 1.0": (1.0, 0.0, SGU_LAUNCHES_PER_FORWARD),
                 "threshold 0.9999": (RELAXED_THRESHOLD, 0.0,
                                      SGU_LAUNCHES_PER_FORWARD),
                 "threshold 0.9999, eq 0.1": (RELAXED_THRESHOLD, 0.1,
                                              EQ_LAUNCHES_PER_STEP)}
PARALLEL_RANK_TIMEOUT = 600  # seconds
CLI_PARALLEL_STEPS = 2


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().double().reshape(-1) for t in tensors])


def named(model, what: str):
    """The model's parameters (or their gradients) in name order."""
    return [getattr(p, what) if what else p
            for _, p in sorted(model.named_parameters())]


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def single_step(k, conf, batch, threshold=1.0, eq_weight=0.0):
    """One ``make_train_step`` step of one process from the checkpoint:
    (loss terms, parameters before, after, gradients), flat on the
    card."""
    k.warp_ops.MASK_THRESHOLD = threshold
    try:
        model, state, opt = k.step.create_train_state(
            conf, k.TrainerConfig(), weights=str(NPZ))
        before = flat(named(model, ""))
        _, metrics = k.step.make_train_step(
            model, opt, eq_loss_weight=eq_weight)(state, batch)
        torch.cuda.synchronize()
    finally:
        k.warp_ops.MASK_THRESHOLD = 1.0
    return ({key: v.item() for key, v in metrics.items()}, before,
            flat(named(model, "")), flat(named(model, "grad")))


def phase_one_rank(k, phase6):
    """Phase 9a: a one-rank NCCL group on cuda:0 runs phase 6's recipe at
    B=4 256x832 at fp32 and bf16: its loss equals ``make_train_step``'s
    bit for bit, its updated parameters reach cosine >=
    ``PARALLEL_PARAM_COSINE_BAR`` with the single process's, every kernel
    of the path launches and no plain version runs on a CUDA tensor.  Then
    both steps are timed in turns and each is profiled once."""
    pm = k.pmesh
    pm.init_distributed(rank=0, world_size=1, init_method="tcp://127.0.0.1:"
                        "%d" % free_port(), device="cuda:0",
                        timeout=datetime.timedelta(minutes=2))
    out = {}
    try:
        mesh = pm.make_mesh()
        backend = torch.distributed.get_backend()
        check(backend == "nccl" and mesh.size == 1
              and mesh.device == torch.device("cuda", 0),
              "9a: a one-rank group over %s on %s" % (backend, mesh.device))
        batch = train_batch(k)
        for tag, (knobs, _, per_step, _, _) in TRAIN_PATHS.items():
            conf = k.UPFlowConfig().updated(knobs)
            runs = {}
            for name in ("single", "one-rank"):
                model, state, opt = k.step.create_train_state(
                    conf, k.TrainerConfig(), weights=str(NPZ))
                if name == "single":
                    step_fn = k.step.make_train_step(model, opt)
                else:
                    pm.replicate(mesh, model, opt)
                    step_fn = k.pstep.make_sharded_train_step(model, opt,
                                                              mesh)
                before = flat(named(model, ""))
                # the path's run: every count 0 just before, read after
                launches_from_zero(k)
                state, metrics = step_fn(state, batch)
                got, plain_calls = launch_counts(k)
                runs[name] = dict(step=step_fn, state=state, times=[],
                                  loss=metrics["total_loss"].item(),
                                  params=flat(named(model, "")),
                                  before=before, got=got, plain=plain_calls)
            ref, one = runs["single"], runs["one-rank"]
            cos = cosine(one["params"], ref["params"])
            update_cos = cosine(one["params"] - one["before"],
                                ref["params"] - ref["before"])
            check(one["loss"] == ref["loss"], "9a %s: the one-rank step's "
                  "loss %r equals make_train_step's %r bit for bit"
                  % (tag, one["loss"], ref["loss"]))
            check(cos >= PARALLEL_PARAM_COSINE_BAR,
                  "9a %s: updated parameters' cosine with the single "
                  "process's %.9f (>= %g; the update's %.7f)"
                  % (tag, cos, PARALLEL_PARAM_COSINE_BAR, update_cos))
            check(one["got"] == per_step and one["plain"] == 0,
                  "9a %s: the step launched %s, %d plain calls on CUDA "
                  "tensors" % (tag, one["got"], one["plain"]))
            losses = []
            for _ in range(PARALLEL_TIMED_STEPS):  # in turns
                for run in runs.values():
                    t0 = time.perf_counter()
                    run["state"], metrics = run["step"](run["state"], batch)
                    torch.cuda.synchronize()
                    run["times"].append((time.perf_counter() - t0) * 1e3)
                    losses.append(metrics["total_loss"].item())
            check(all(np.isfinite(losses)), "9a %s: %d timed steps of each, "
                  "in turns, every loss finite" % (tag, PARALLEL_TIMED_STEPS))
            ms = {name: statistics.median(run["times"])
                  for name, run in runs.items()}
            print("  info 9a %s: in turns over %d steps, one-rank NCCL step "
                  "%.1f ms median (%.1f-%.1f), single process %.1f ms "
                  "(%.1f-%.1f); phase 6's %.1f ms (%s)"
                  % (tag, PARALLEL_TIMED_STEPS, ms["one-rank"],
                     min(one["times"]), max(one["times"]), ms["single"],
                     min(ref["times"]), max(ref["times"]),
                     phase6[tag]["step_ms_median"], nvidia_smi_line()))
            profiled = {}
            for name, run in runs.items():
                _, split, _, busy, wall = profile_train_step(
                    k, run["step"], run["state"], batch,
                    "9a %s %s" % (tag, name))
                profiled[name] = dict(wall_ms=wall, device_ms=busy,
                                      split_ms=split)
            out[tag] = dict(loss=one["loss"], single_loss=ref["loss"],
                            param_cosine=cos, update_cosine=update_cos,
                            launches=one["got"],
                            step_ms={n: r["times"] for n, r in runs.items()},
                            step_ms_median=ms, profiled=profiled,
                            phase6_step_ms_median=phase6[tag][
                                "step_ms_median"])
            del runs
    finally:
        pm.close_distributed()
    return out


def repeat_sharded_steps(k, mesh, conf, local, metrics, params):
    """A second run of the sharded step's two steps from the checkpoint:
    whether its losses and its parameters after them equal the first
    run's (``metrics``, ``params``) bit for bit.  A reading for 9b."""
    model, state, opt = k.step.create_train_state(
        conf, k.TrainerConfig(), weights=str(NPZ))
    k.pmesh.replicate(mesh, model, opt)
    step_fn = k.pstep.make_sharded_train_step(model, opt, mesh)
    again = []
    for _ in metrics:
        state, m = step_fn(state, local)
        again.append(m)
    return dict(losses_bit_equal=all(
                    torch.equal(a[key], b[key])
                    for a, b in zip(metrics, again) for key in a),
                params_bit_equal=torch.equal(params,
                                             flat(named(model, ""))))


def parallel_rank(rank: int, init_method: str, out: str) -> int:
    """One rank of phase 9b (``chip_smoke.py --parallel-rank R INIT
    OUT``): phase 6's fp32 recipe from the checkpoint at B=2, its half of
    the B=4 batch, for each of ``PARALLEL_JOBS``, over gloo on cuda:0;
    the results go to ``OUT`` (``torch.save``)."""
    k = Port()
    k.build.build()
    k.pmesh.init_distributed(rank=rank, world_size=2, local_rank=0,
                             init_method=init_method, backend="gloo",
                             device="cuda:0",
                             timeout=datetime.timedelta(minutes=5))
    res = {}
    try:
        mesh = k.pmesh.make_mesh(data=2)
        conf = k.UPFlowConfig().updated(TRAIN_KNOBS)
        local = k.pmesh.shard_batch(mesh, train_batch(k))
        for name, (threshold, eq_weight, _) in PARALLEL_JOBS.items():
            k.warp_ops.MASK_THRESHOLD = threshold
            model, state, opt = k.step.create_train_state(
                conf, k.TrainerConfig(), weights=str(NPZ))
            k.pmesh.replicate(mesh, model, opt)
            step_fn = k.pstep.make_sharded_train_step(
                model, opt, mesh, eq_loss_weight=eq_weight)
            launches_from_zero(k)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, local)
            torch.cuda.synchronize()
            ms = [(time.perf_counter() - t0) * 1e3]
            got, plain_calls = launch_counts(k)
            res[name] = dict(
                metrics={key: v.item() for key, v in metrics.items()},
                params=flat(named(model, "")).cpu(),
                grads=flat(named(model, "grad")).cpu(), launches=got,
                plain_calls=plain_calls,
                backend=torch.distributed.get_backend(),
                device=str(mesh.device))
            if name == "threshold 1.0":  # a step after the first
                t0 = time.perf_counter()
                _, second = step_fn(state, local)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                res[name]["repeat"] = repeat_sharded_steps(
                    k, mesh, conf, local, [metrics, second],
                    flat(named(model, "")))
            res[name]["ms"] = ms
            k.warp_ops.MASK_THRESHOLD = 1.0
            del model, state, opt, step_fn
        torch.save(res, out)
    finally:
        k.pmesh.close_distributed()
    return 0


def phase_two_ranks(k, tmp):
    """Phase 9b: two processes on the one card over gloo, each at B=2 of
    phase 6's B=4 batch, against one process at B=4: the global loss
    within ``PARALLEL_LOSS_BAR`` relative; at threshold 0.9999 (with and
    without the equivariance pass) every loss term within
    ``PARALLEL_ROBUST_LOSS_BAR`` and the gradient's cosine >=
    ``PARALLEL_GRAD_COSINE_BAR``; both ranks bit-equal (loss, gradients,
    parameters), every kernel of the path launched on both, no plain
    version on a CUDA tensor."""
    conf = k.UPFlowConfig().updated(TRAIN_KNOBS)
    batch = train_batch(k)
    refs = {}
    for name, (threshold, eq_weight, _) in PARALLEL_JOBS.items():
        terms, _, _, grads = single_step(k, conf, batch, threshold,
                                         eq_weight)
        refs[name] = (terms, grads.cpu())
    del batch
    torch.cuda.empty_cache()
    init = "file://" + str(tmp / "parallel_store")
    outs = [tmp / ("parallel_rank%d.pt" % r) for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
         str(r), init, str(outs[r])], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=PARALLEL_RANK_TIMEOUT)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    ok = all(p.returncode == 0 for p in procs)
    check(ok, "9b: both ranks exited 0 in %.1f s (exit codes %s)"
          % (seconds, [p.returncode for p in procs]))
    if not ok:
        for r, log in enumerate(logs):
            print("  rank %d output:\n%s" % (r, log[-4000:]))
        return dict(seconds=seconds)
    ranks = [torch.load(path) for path in outs]
    out = dict(seconds=seconds)
    for name, (threshold, eq_weight, per_step) in PARALLEL_JOBS.items():
        r0, r1 = (r[name] for r in ranks)
        single, single_grads = refs[name]
        loss = r0["metrics"]["total_loss"]
        rels = {key: abs(r0["metrics"][key] - v) / max(abs(v), 1e-30)
                for key, v in single.items()}
        rel = rels["total_loss"]
        grad_cos = cosine(r0["grads"], single_grads)
        what = "9b %s: 2 gloo ranks at B=2" % name
        check(r0["backend"] == r1["backend"] == "gloo"
              and r0["device"] == r1["device"] == "cuda:0",
              "%s: over %s on %s" % (what, r0["backend"], r0["device"]))
        check(r0["metrics"] == r1["metrics"]
              and torch.equal(r0["params"], r1["params"])
              and torch.equal(r0["grads"], r1["grads"]),
              "%s: the ranks' loss terms, gradients and parameters are "
              "equal bit for bit" % what)
        check(rel <= PARALLEL_LOSS_BAR, "%s: global loss %.7f against one "
              "process at B=4 %.7f, %.2e relative (<= %g)"
              % (what, loss, single["total_loss"], rel, PARALLEL_LOSS_BAR))
        if threshold != 1.0:
            check(sorted(rels) == sorted(r0["metrics"])
                  and max(rels.values()) <= PARALLEL_ROBUST_LOSS_BAR,
                  "%s: every loss term against one process's, at most "
                  "%.2e relative (<= %g; %s)"
                  % (what, max(rels.values()), PARALLEL_ROBUST_LOSS_BAR,
                     ", ".join("%s %.2e" % kv
                               for kv in sorted(rels.items()))))
            check(grad_cos >= PARALLEL_GRAD_COSINE_BAR,
                  "%s: gradient cosine with one process's %.9f (>= %g)"
                  % (what, grad_cos, PARALLEL_GRAD_COSINE_BAR))
        check(all(r["launches"] == per_step and r["plain_calls"] == 0
                  for r in (r0, r1)),
              "%s: each rank launched %s, plain calls on CUDA tensors %s"
              % (what, [r["launches"] for r in (r0, r1)],
                 [r["plain_calls"] for r in (r0, r1)]))
        print("  info %s: step ms %s on rank 0, %s on rank 1 (%s)"
              % (what, [round(x, 1) for x in r0["ms"]],
                 [round(x, 1) for x in r1["ms"]], nvidia_smi_line()))
        if "repeat" in r0:
            print("  info %s: a second run of the two steps from the "
                  "checkpoint, bit-equal to the first (losses, parameters): "
                  "rank 0 %s, rank 1 %s"
                  % (what, r0["repeat"], r1["repeat"]))
        out[name] = dict(loss=loss, single_loss=single["total_loss"],
                         rel=rel, term_rel=rels,
                         grad_cosine=grad_cos, launches=r0["launches"],
                         step_ms=[r0["ms"], r1["ms"]],
                         repeat=[r0.get("repeat"), r1.get("repeat")])
    return out


def phase_cli_ranks(k, root, tmp, pth):
    """Phase 9c: ``scripts/torch_train_kitti.py`` in the environment
    torchrun gives one rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_*):
    the CLI joins a one-rank NCCL group, trains ``CLI_PARALLEL_STEPS``
    steps from the ``.pth`` at B=4 through the sharded step, launching
    every kernel of the path, and leaves the group."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    saved = {key: os.environ.get(key) for key in env}
    backends = []
    orig_init = k.pmesh.dist.init_process_group

    def init(backend, *args, **kwargs):
        backends.append(backend)
        return orig_init(backend, *args, **kwargs)

    os.environ.update(env)
    k.pmesh.dist.init_process_group = init
    try:
        launches_from_zero(k)
        with watched_training(k) as run:
            trainer = k.cli["train_kitti"].main([
                "--mv-root", str(root), "--exp-dir", str(tmp / "kitti_nccl"),
                "--batch", "4", "--steps", str(CLI_PARALLEL_STEPS),
                "--pretrained", str(pth)])
        got, plain_calls = launch_counts(k)
    finally:
        k.pmesh.dist.init_process_group = orig_init
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    want = {n: c * CLI_PARALLEL_STEPS
            for n, c in SGU_LAUNCHES_PER_FORWARD.items()}
    finite = all(np.isfinite(v) for s in run["steps"]
                 for v in s["metrics"].values())
    check(backends == ["nccl"] and trainer.mesh is not None
          and trainer.mesh.size == 1
          and not torch.distributed.is_initialized(),
          "9c: the KITTI CLI under torchrun's one-rank environment joined "
          "a %s group of %s and left it"
          % (backends, trainer.mesh and trainer.mesh.size))
    check(trainer.state.step == CLI_PARALLEL_STEPS and got == want
          and plain_calls == 0 and finite,
          "9c: %d steps launched %s, %d plain calls on CUDA tensors, every "
          "loss term finite (total %s)"
          % (trainer.state.step, got, plain_calls,
             [round(s["metrics"]["total_loss"], 4) for s in run["steps"]]))
    ms = [s["ms"] for s in run["steps"]]
    print("  info 9c KITTI CLI, one NCCL rank, B=4 256x832: step ms %s (%s)"
          % ([round(x, 1) for x in ms], nvidia_smi_line()))
    return dict(step_ms=ms, launches=got)


def phase_parallel(k, root, tmp, pth, phase6):
    """Phase 9: 9a, 9b and 9c; prints one JSON line."""
    out = {}
    for name, fn in (("9a", lambda: phase_one_rank(k, phase6)),
                     ("9b", lambda: phase_two_ranks(k, tmp)),
                     ("9c", lambda: phase_cli_ranks(k, root, tmp, pth))):
        t0 = time.perf_counter()
        print("phase %s" % name, flush=True)
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase_9": out}), flush=True)
    return out


# phase 10: width sharding (parallel/spatial.py) on the one card.  10a:
# the four warp kernels at column offsets (each rank's columns of 2 and of
# 3 ranks) at the decode-level shapes of the 10b requests, and the other
# three kernels on the windows the sharded forward gives them; 10b: two gloo
# ranks on cuda:0 (NCCL takes one rank a device) run the SGU eval at fp32
# and bf16 with the width split over 'spatial', against one process at
# threshold 0.9999 under the AGREEMENT bars; 10c: one fp32 request over
# three ranks, whose widths split unevenly at every level; 10d:
# dryrun_multigpu(2) with its width-sharded rehearsal, in 10b's group.
SPATIAL_REQUESTS = [("b1_375x1242", 1, 375, 1242, 21),
                    ("b2_384x1280", 2, 384, 1280, 22)]
SPATIAL_UNEVEN = ("b1_384x1280", 1, 384, 1280, 23)  # 1280 / 3 .. 20 / 3
SPATIAL_PATHS = {"sgu": (SGU_KNOBS, SGU_LAUNCHES_PER_FORWARD),
                 "sgu-bf16": (BF16_KNOBS, BF16_LAUNCHES_PER_FORWARD)}
SPATIAL_RANK_TIMEOUT = 600  # seconds
# 10a's windows of the other three kernels: the frames of 10b (two and
# three ranks) and 10c's (three ranks)
WINDOW_FRAMES = (((1, 375, 1242), (2, 3)), ((2, 384, 1280), (2, 3)),
                 ((1, 384, 1280), (3,)))
# the rank processes wrap these launchers of the kernels that run on
# windows, to record the shapes they launch
WINDOW_LAUNCHERS = (("corr", "correlation_cuda", "correlation"),
                    ("cn", "corr_norm_cuda", "corr_norm"),
                    ("seg", "conv3x3_seg_cuda", "conv3x3_seg"))


def split_cols(w: int):
    """Every rank's columns of a map ``w`` wide over 2 and over 3 ranks."""
    return [(s * w // n, (s + 1) * w // n) for n in (2, 3) for s in range(n)]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    word = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(word),
                            b.contiguous().view(word)))


def window_key(name, x, *extra):
    """How 10a and the rank processes name a launch on a window: the
    kernel, the map's type and shape, and for the conv its Cout and
    dilation."""
    return (name, str(x.dtype)[6:], tuple(x.shape)) + tuple(extra)


def zero_window(x, lo, hi):
    """Columns [lo, hi) of ``x``, zero outside it (``WidthShard.window``'s
    zero fill)."""
    out = x.new_zeros(tuple(x.shape[:-1]) + (hi - lo,))
    a, b = max(lo, 0), min(hi, x.shape[-1])
    out[..., a - lo:b - lo] = x[..., a:b]
    return out


def phase_offsets(k):
    """Phase 10a: each warp kernel at every rank's columns of 2 and of 3
    ranks (x0 and a narrower output), at the decode-level shapes of B=1
    375x1242 and B=2 384x1280 (full resolution for the occlusion warp and
    the final stage), mask threshold 1.0: bit for bit against its plain
    version at the same columns, mask bits included (the final stage
    within phase 2's 1e-4 px), and bit for bit against the columns of the
    whole frame's launch.  Then ``phase_windows``.  Returns the cases held
    per kernel row and the window shapes held."""
    rng = np.random.RandomState(41)
    held = {name: 0 for name in list(LAUNCHES_PER_FORWARD) + list(SERVED_BY)}

    def rand(*shape, amp=1.0):
        return torch.from_numpy(((rng.rand(*shape) - 0.5) * 2 * amp).astype(
            np.float32)).to(DEV)

    def hold(name, what, cases):
        ok = all(cases)
        held[name] += len(cases)
        check(ok, "10a %s %s: %d of %d column ranges bit for bit against "
              "the plain version and the whole frame's columns"
              % (name, what, sum(cases), len(cases)))

    for b, h, w in ((1, 375, 1242), (2, 384, 1280)):
        for level, (hl, wl) in enumerate(pyramid_hw(h, w)):
            if level == 0:
                continue
            amp = max(2.0, min(40.0, wl / 4))
            flows = [make_flow(rng, b, hl, wl, amp) for _ in range(2)]
            for c, dtype in ((PYRAMID_CHS[level], torch.float32),
                             (32, torch.float32),
                             (PYRAMID_CHS[level], torch.bfloat16)):
                x = rand(b, c, hl, wl).to(dtype)
                whole, whole_mask = k.fw.feature_warp(x, flows[0], 1.0,
                                                      with_mask=True)
                cases = []
                for lo, hi in split_cols(wl):
                    fl = flows[0][..., lo:hi].contiguous()
                    got, mask = k.fw.feature_warp(x, fl, 1.0, with_mask=True,
                                                  x0=lo)
                    ref, ref_mask = k.fw.feature_warp_plain(
                        x, fl, 1.0, with_mask=True, x0=lo)
                    cases.append(
                        same_bits(got, ref) and same_bits(mask, ref_mask)
                        and same_bits(got, whole[..., lo:hi])
                        and same_bits(mask, whole_mask[..., lo:hi]))
                hold("feature_warp" + ("_bf16" if dtype == torch.bfloat16
                                       else ""),
                     "%s L%d %s" % (str(dtype)[6:], level, (b, c, hl, wl)),
                     cases)
            for dtype in (torch.float32, torch.bfloat16):
                heads = [torch.cat([rand(b, 2, hl, wl, amp=15.0),
                                    rand(b, 1, hl, wl, amp=6.0)],
                                   dim=1).to(dtype) for _ in range(2)]
                whole = k.sb.sgu_blend_pair(flows[0], heads[0], flows[1],
                                            heads[1])
                cases = []
                for lo, hi in split_cols(wl):
                    args = (flows[0], heads[0][..., lo:hi].contiguous(),
                            flows[1], heads[1][..., lo:hi].contiguous())
                    got = k.sb.sgu_blend_pair(*args, x0=lo)
                    ref = k.sb.sgu_blend_pair_plain(*args, x0=lo)
                    cases.append(all(
                        same_bits(g, r) and same_bits(g, f[..., lo:hi])
                        for g, r, f in zip(got, ref, whole)))
                hold("sgu_blend" + ("_bf16" if dtype == torch.bfloat16
                                    else ""),
                     "%s heads L%d %s" % (str(dtype)[6:], level,
                                          (b, 3, hl, wl)), cases)
        flows = [make_flow(rng, b, h, w, 20.0) for _ in range(2)]
        # row 5's magnitudes (|u| <= 119, |v| <= 39 px), as phase 2 has them
        wide = torch.cat([make_flow(rng, b, h, w, amp)[:, :1]
                          for amp in (119.0, 39.0)], dim=1)
        wide[:, 0].clamp_(-119.0, 119.0)
        wide[:, 1].clamp_(-39.0, 39.0)
        for row, flow in (("warp", flows[0]), ("warp_window", wide)):
            whole = k.warp.warp(flows[1], flow)
            cases = []
            for lo, hi in split_cols(w):
                fl = flow[..., lo:hi].contiguous()
                got = k.warp.warp(flows[1], fl, lo)
                cases.append(
                    same_bits(got, k.warp.warp_plain(flows[1], fl, lo))
                    and same_bits(got, whole[..., lo:hi]))
            hold(row, "occlusion warp %s" % ((b, 2, h, w),), cases)
        hq, wq = pyramid_hw(h, w)[4]
        flow_q = make_flow(rng, b, hq, wq, 10.0)
        x_out = torch.cat([rand(b, 2, hq, wq, amp=9.0),
                           rand(b, 1, hq, wq, amp=3.0)], dim=1)
        whole = k.sf.sgu_final(flow_q, x_out, (h, w))
        cases, err = [], 0.0
        for lo, hi in split_cols(w):
            got = k.sf.sgu_final(flow_q, x_out, (h, w), lo, hi - lo)
            ref = k.sf.sgu_final_plain(flow_q, x_out, (h, w), lo, hi - lo)
            err = max(err, (got - ref).abs().max().item())
            cases.append(same_bits(got, whole[..., lo:hi])
                         and (got - ref).abs().max().item() <= 1e-4)
        held["sgu_final"] += len(cases)
        check(all(cases), "10a sgu_final %s -> %s: %d of %d column ranges "
              "bit for bit against the whole frame's columns, max abs err "
              "against the plain version %.3e px (<= 1e-4)"
              % (tuple(x_out.shape), (b, 2, h, w), sum(cases), len(cases),
                 err))
    return held, phase_windows(k, held)


def phase_windows(k, held):
    """Phase 10a, the kernels that run on windows and are cropped:
    correlation (decode level 0, ``[lo - 4, hi + 4)`` zero-filled, the
    first map's halo zeros), corr_norm (levels 1-4, ``[lo - 4, hi + 4)``
    clipped to the frame, the affine of the frame's moments) at fp32 and
    bf16, and conv3x3_seg (every kernel-route conv of the bf16 forward,
    ``[lo - d, hi + d)`` zero-filled), at every rank's columns of
    ``WINDOW_FRAMES``, each on the grid of the frame's width as the
    sharded forward launches it.  Each is held against its plain version
    on the window and, cropped to the rank's columns, against the whole
    frame's launch, both under phase 2's bars (1e-5 x max|out|;
    ``conv_agreement``); the cases equal bit for bit are counted.  Adds
    the cases to ``held`` and returns the window shapes held
    (``window_key``)."""
    gen = torch.Generator(device=DEV).manual_seed(43)
    shapes, bits = set(), {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    def corr_bar(got, ref):
        err = (got - ref).abs().max().item()
        return err <= 1e-5 * ref.abs().max().item(), err

    def hold(row, what, cases):
        """cases: (ok against plain, ok against the whole frame, bit for
        bit against it, max abs err against the whole frame)."""
        held[row] += len(cases)
        same = sum(c[2] for c in cases)
        total, eq = bits.get(row, (0, 0))
        bits[row] = (total + len(cases), eq + same)
        check(all(c[0] and c[1] for c in cases),
              "10a %s %s: %d of %d windows within phase 2's bar of the plain "
              "version and of the whole frame's columns (%d bit for bit, max "
              "abs err against the whole frame %.3e)"
              % (row, what, sum(c[0] and c[1] for c in cases), len(cases),
                 same, max(c[3] for c in cases)))

    for (b, h, w), ranks in WINDOW_FRAMES:
        for level, (hl, wl) in enumerate(pyramid_hw(h, w)):
            c = PYRAMID_CHS[level]
            cols = [(s * wl // n, (s + 1) * wl // n)
                    for n in ranks for s in range(n)]
            f1, f2 = randn(b, c, hl, wl), randn(b, c, hl, wl) * 2 + 0.5
            aff = k.cn.affine_pair(*k.cn.moments(f1, False),
                                   *k.cn.moments(f2, False), NORM_KW)
            for dtype, suffix in ((torch.float32, ""),
                                  (torch.bfloat16, "_bf16")):
                a1, a2 = f1.to(dtype), f2.to(dtype)
                cases = []
                if level == 0:
                    whole = k.corr.correlation(a1, a2)
                    for lo, hi in cols:
                        w1 = torch.nn.functional.pad(a1[..., lo:hi], (4, 4))
                        w2 = zero_window(a2, lo - 4, hi + 4)
                        got = k.corr.correlation(w1, w2, 4, wl)
                        ref = k.corr.correlation_plain(w1, w2)
                        crop = got[..., 4:got.shape[3] - 4]
                        shapes.add(window_key("correlation", w1))
                        ok_whole, err = corr_bar(crop, whole[..., lo:hi])
                        cases.append((corr_bar(got, ref)[0], ok_whole,
                                      same_bits(crop, whole[..., lo:hi]),
                                      err))
                    row = "correlation" + suffix
                else:
                    whole = k.cn.corr_norm(a1, a2, aff, 0.1)
                    for lo, hi in cols:
                        a, e = max(lo - 4, 0), min(hi + 4, wl)
                        w1 = a1[..., a:e].contiguous()
                        w2 = a2[..., a:e].contiguous()
                        got = k.cn.corr_norm(w1, w2, aff, 0.1, wl)
                        ref = k.cn.corr_norm_plain(w1, w2, aff, 0.1)
                        crop = got[..., lo - a:hi - a]
                        shapes.add(window_key("corr_norm", w1))
                        ok_whole, err = corr_bar(crop, whole[..., lo:hi])
                        cases.append((corr_bar(got, ref)[0], ok_whole,
                                      same_bits(crop, whole[..., lo:hi]),
                                      err))
                    row = "corr_norm" + suffix
                hold(row, "%s L%d %s, %d windows of %s"
                     % (str(dtype)[6:], level, (b, c, hl, wl), len(cols),
                        ranks), cases)
        for what, _, hc, wc, cin, cout, d, relu, per_forward, _ in \
                conv_shapes(b, (h, w), ragged=False):
            if per_forward == 0:
                continue
            x = randn(b, cin, hc, wc).bfloat16()
            weight = randn(cout, cin, 3, 3) * (2.0 / (9 * cin)) ** 0.5
            bias = randn(cout) * 0.1
            whole = k.seg.conv3x3_seg(x, weight, bias, d, relu).float()
            cases = []
            for lo, hi in [(s * wc // n, (s + 1) * wc // n)
                           for n in ranks for s in range(n)]:
                xw = zero_window(x, lo - d, hi + d)
                got = k.seg.conv3x3_seg(xw, weight, bias, d, relu).float()
                ref = k.seg.conv3x3_seg_plain(xw, weight, bias, d,
                                              relu).float()
                crop = got[..., d:got.shape[3] - d]
                shapes.add(window_key("conv3x3_seg", xw, cout, d))
                diff, stats = conv_agreement(crop, whole[..., lo:hi])
                cases.append((conv_agreement(got, ref)[1][0], stats[0],
                              same_bits(crop, whole[..., lo:hi]),
                              diff.max().item()))
            hold("conv3x3_seg", "%s (%d, %d->%d, %dx%d, d=%d), %d windows "
                 "of %s" % (what, b, cin, cout, hc, wc, d, len(cases),
                            ranks), cases)
    for row, (total, eq) in sorted(bits.items()):
        print("  info 10a %s on windows: %d of %d cropped windows equal the "
              "whole frame's columns bit for bit" % (row, eq, total))
    return shapes


@contextlib.contextmanager
def recording_windows(k, shapes):
    """Adds to ``shapes`` the ``window_key`` of every launch of the kernels
    that run on windows (``WINDOW_LAUNCHERS``) inside the block."""
    saved = []
    for mod, fn, name in WINDOW_LAUNCHERS:
        module = getattr(k, mod)
        launcher = getattr(module, fn)

        def wrapped(x, *args, _launcher=launcher, _name=name, **kw):
            extra = (args[0].shape[0], args[2]) if _name == "conv3x3_seg" \
                else ()
            shapes.add(window_key(_name, x, *extra))
            return _launcher(x, *args, **kw)

        saved.append((module, fn, launcher))
        setattr(module, fn, wrapped)
    try:
        yield
    finally:
        for module, fn, launcher in saved:
            setattr(module, fn, launcher)


# the model's ops whose outputs the trace compares (module, name), besides
# every ConvBlock
TRACED_OPS = (("upflow", "normalize_features"), ("upflow", "_correlation"),
              ("upflow", "upsample2d_flow_as"), ("cn", "moments"),
              ("upflow", "warp_norm_corr"), ("warp_ops", "flow_warp_masked"),
              ("warp_ops", "sgu_blend_pair"), ("upflow", "sgu_final"),
              ("entry", "occ_check"))


def trace_difference(k, model, im1, im2, shard):
    """Where a width-sharded forward first parts from one process's: the
    whole forward on this rank, then the sharded one, recording the
    tensors in and out of every ConvBlock and ``TRACED_OPS`` call in the
    order they run; each of the whole run's is cropped to this rank's
    columns (where its width is not already the sharded one's).  Returns
    the number of calls, the first whose output is not bit for bit the
    whole run's, and per op the calls whose inputs were equal but whose
    outputs were not (the sources of a difference), with their largest
    |difference|."""
    def flat(v):
        if isinstance(v, torch.Tensor):
            return [v]
        if isinstance(v, (list, tuple)):
            return [t for x in v for t in flat(x)]
        return []

    def crop(whole, part):
        if whole.shape == part.shape:
            return whole
        lo, hi = shard.cols(whole.shape[-1])
        if whole.shape[:-1] == part.shape[:-1] and hi - lo == part.shape[-1]:
            return whole[..., lo:hi]
        return None

    record, calls = [], []

    def note(name, ins, outs):
        ins, outs = flat(ins), flat(outs)
        if record is not None:
            record.append((name, [t.detach().clone() for t in ins],
                           [t.detach().clone() for t in outs]))
            return
        i = len(calls)
        if i >= len(whole_run) or whole_run[i][0] != name:
            calls.append((name, None, None, None))
            return
        _, w_ins, w_outs = whole_run[i]

        def same(ws, ps):
            pairs = [(crop(w, p), p) for w, p in zip(ws, ps)]
            return (len(ws) == len(ps)
                    and all(w is not None and same_bits(w, p)
                            for w, p in pairs)), pairs

        ins_same, _ = same(w_ins, ins)
        outs_same, pairs = same(w_outs, outs)
        diff = max([(w.float() - p.float()).abs().max().item()
                    for w, p in pairs if w is not None and w.numel()
                    and w.dtype.is_floating_point] or [0.0])
        calls.append((name, ins_same, outs_same, diff))

    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: note(name, args[:1], out))
        for name, m in model.named_modules()
        if type(m).__name__ == "ConvBlock"]
    saved = []
    for mod, fn in TRACED_OPS:
        module = getattr(k, mod)
        op = getattr(module, fn)

        def wrapped(*args, _op=op, _fn=fn, **kw):
            out = _op(*args, **kw)
            note(_fn, list(args), out)
            return out

        saved.append((module, fn, op))
        setattr(module, fn, wrapped)
    try:
        k.entry.forward(model, im1, im2)
        whole_run, record = record, None
        k.entry.forward(model, im1, im2, shard)
    finally:
        for h in hooks:
            h.remove()
        for module, fn, op in saved:
            setattr(module, fn, op)
    first = next(((i, c[0], c[3]) for i, c in enumerate(calls)
                  if not c[2]), None)
    sources = {}
    for name, ins_same, outs_same, diff in calls:
        if ins_same and not outs_same:
            n, d = sources.get(name, (0, 0.0))
            sources[name] = (n + 1, max(d, diff))
    aligned = (len(calls) == len(whole_run)
               and all(c[1] is not None for c in calls))
    return dict(calls=len(calls), aligned=aligned, first=first,
                sources=sources)


def spatial_rank(rank: int, world: int, init_method: str, out: str) -> int:
    """One rank of phase 10b-d (``chip_smoke.py --spatial-rank R WORLD INIT
    OUT``), over gloo on cuda:0: with 2 ranks the SGU eval of
    ``SPATIAL_PATHS`` on ``SPATIAL_REQUESTS``, then ``dryrun_multigpu(2)``
    in the same group; with 3 ranks the fp32 request ``SPATIAL_UNEVEN``.
    Each request runs once to warm up and once counted and timed; the
    results go to ``OUT`` (``torch.save``)."""
    k = Port()
    k.build.build()
    k.pmesh.init_distributed(rank=rank, world_size=world, local_rank=0,
                             init_method=init_method, backend="gloo",
                             device="cuda:0",
                             timeout=datetime.timedelta(minutes=5))
    res = {}
    try:
        mesh = k.pmesh.make_mesh(data=1, spatial=world)
        if world == 2:
            jobs = [(path, req) for path in SPATIAL_PATHS
                    for req in SPATIAL_REQUESTS]
        else:
            jobs = [("sgu", SPATIAL_UNEVEN)]
        k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
        models, windows = {}, set()
        for path, (name, b, h, w, seed) in jobs:
            if path not in models:
                models[path] = k.entry.build_model(
                    k.UPFlowConfig().updated(SPATIAL_PATHS[path][0]),
                    weights=str(NPZ))
            step = k.pstep.make_sharded_eval_step(models[path], mesh,
                                                  spatial=True)
            im1, im2 = textured_pair(b, h, w, seed)
            with recording_windows(k, windows):
                step(im1, im2)
                torch.cuda.synchronize()
                launches_from_zero(k)
                step.shard.bytes_reduced = step.shard.collectives = 0
                t0 = time.perf_counter()
                outs = step(im1, im2)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            got, plain_calls = launch_counts(k)
            res[path, name] = dict(
                outputs={key: v.cpu() for key, v in
                         zip(("flow_f_out", "flow_b_out", "occ_fw",
                              "occ_bw"), outs)},
                launches=got, plain_calls=plain_calls, ms=ms,
                bytes=step.shard.bytes_reduced,
                collectives=step.shard.collectives,
                backend=torch.distributed.get_backend(),
                device=str(mesh.device))
            if path == "sgu":
                res[path, name]["trace"] = trace_difference(
                    k, models[path], im1, im2, step.shard)
        res["windows"] = windows
        k.warp_ops.MASK_THRESHOLD = 1.0
        del models
        torch.cuda.empty_cache()
        if world == 2:
            res["dryrun_loss"] = k.dryrun.dryrun_multigpu(2)
        torch.save(res, out)
    finally:
        k.pmesh.close_distributed()
    return 0


def run_spatial_ranks(tmp: Path, world: int):
    """Starts ``world`` processes of ``spatial_rank`` on the card and
    waits for them; returns (results by rank or None, outputs, seconds)."""
    init = "file://" + str(tmp / ("spatial_store_%d" % world))
    outs = [tmp / ("spatial_%d_rank%d.pt" % (world, r)) for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--spatial-rank",
         str(r), str(world), init, str(outs[r])], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPATIAL_RANK_TIMEOUT)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    ok = all(p.returncode == 0 for p in procs)
    check(ok, "10: %d ranks exited 0 in %.1f s (exit codes %s)"
          % (world, seconds, [p.returncode for p in procs]))
    if not ok:
        for r, log in enumerate(logs):
            print("  rank %d output:\n%s" % (r, log[-4000:]))
        return None, logs, seconds
    return [torch.load(path) for path in outs], logs, seconds


def hold_spatial(k, ranks, path, req, refs, what):
    """The ranks' gathered outputs of one request: equal bit for bit on
    every rank, within the path's AGREEMENT bars of one process, every
    kernel of the path launched per forward, no plain call.  Returns its
    summary."""
    name, b, h, w, _ = req
    per_rank = [r[path, name] for r in ranks]
    r0 = per_rank[0]
    ref = refs[path, name]
    mean, p999 = flow_diffs(r0["outputs"], ref)
    occ = max((r0["outputs"][key] != ref[key]).float().mean().item()
              for key in ("occ_fw", "occ_bw"))
    mean_bar, p999_bar, occ_bar = AGREEMENT[path]
    want = SPATIAL_PATHS[path][1]
    what = "%s %s %s over %d gloo ranks" % (what, path, name, len(ranks))
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0"
              for r in per_rank), "%s: over gloo on cuda:0" % what)
    check(all(same_bits(r["outputs"][key], r0["outputs"][key])
              for r in per_rank for key in r0["outputs"]),
          "%s: every rank holds the same four outputs bit for bit" % what)
    check(tuple(r0["outputs"]["flow_f_out"].shape) == (b, h, w, 2)
          and mean < mean_bar and p999 < p999_bar and occ < occ_bar,
          "%s: flow against one process mean %.3e px (< %g), p99.9 %.3e px "
          "(< %g), occlusion pixels apart %.2e (< %g)"
          % (what, mean, mean_bar, p999, p999_bar, occ, occ_bar))
    check(all(r["launches"] == want and r["plain_calls"] == 0
              for r in per_rank),
          "%s: each rank launched %s a forward (want %s), plain calls on "
          "CUDA tensors %s" % (what, [r["launches"] for r in per_rank], want,
                               [r["plain_calls"] for r in per_rank]))
    print("  info %s: forward wall ms by rank %s, bytes all-reduced a "
          "forward by rank %s in %s collectives (%d gloo ranks on one "
          "card: %s)" % (what, [round(r["ms"], 1) for r in per_rank],
                         [r["bytes"] for r in per_rank],
                         [r["collectives"] for r in per_rank],
                         len(per_rank), nvidia_smi_line()), flush=True)
    traces = [r.get("trace") for r in per_rank]
    for rank, t in enumerate(traces):
        if t is None:
            continue
        print("  info %s rank %d against the whole forward on the same "
              "rank: %d calls traced (aligned %s); first output apart: %s; "
              "calls with equal inputs and outputs apart (count, max "
              "|diff|): %s" % (what, rank, t["calls"], t["aligned"],
                               t["first"], t["sources"]), flush=True)
    return dict(mean=mean, p999=p999, occ=occ,
                launches=r0["launches"], ms=[r["ms"] for r in per_rank],
                bytes=[r["bytes"] for r in per_rank],
                collectives=r0["collectives"], trace=traces)


def phase_spatial(k, tmp):
    """Phase 10: 10a, then the one-process references, 10b with 10d, and
    10c; prints one JSON line."""
    out = {}
    t0 = time.perf_counter()
    print("phase 10a", flush=True)
    out["10a"], held_windows = phase_offsets(k)
    launched_windows = set()
    refs = {}
    k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
    for path, (knobs, _) in SPATIAL_PATHS.items():
        model = k.entry.build_model(k.UPFlowConfig().updated(knobs),
                                    weights=str(NPZ))
        reqs = SPATIAL_REQUESTS + ([SPATIAL_UNEVEN] if path == "sgu" else [])
        for name, b, h, w, seed in reqs:
            res = k.entry.forward(model, *textured_pair(b, h, w, seed))
            refs[path, name] = {key: res[key].cpu() for key in
                                ("flow_f_out", "flow_b_out", "occ_fw",
                                 "occ_bw")}
        del model, res
    k.warp_ops.MASK_THRESHOLD = 1.0
    torch.cuda.empty_cache()
    print("phase 10b, 10d", flush=True)
    ranks, logs, seconds = run_spatial_ranks(tmp, 2)
    out["10b"] = dict(seconds=seconds)
    if ranks is not None:
        for path in SPATIAL_PATHS:
            for req in SPATIAL_REQUESTS:
                out["10b"]["%s %s" % (path, req[0])] = hold_spatial(
                    k, ranks, path, req, refs, "10b")
        launched_windows.update(*(r["windows"] for r in ranks))
        lines = [line for log in logs for line in log.splitlines()]
        losses = {r["dryrun_loss"] for r in ranks}
        rehearsal = [line for line in lines if line.startswith(
            "dryrun_multigpu: spatial=2 full-model eval ok (1, 64, 128, 2)")]
        check(len(losses) == 1 and all(np.isfinite(list(losses)))
              and len(rehearsal) == 2,
              "10d dryrun_multigpu(2) in the 2-rank gloo group: loss %s on "
              "both ranks, the width-sharded rehearsal printed %d times "
              "(want 2)" % (sorted(losses), len(rehearsal)))
        out["10d"] = dict(loss=losses.pop() if len(losses) == 1 else None)
    print("phase 10c", flush=True)
    ranks, _, seconds = run_spatial_ranks(tmp, 3)
    out["10c"] = dict(seconds=seconds)
    if ranks is not None:
        out["10c"][SPATIAL_UNEVEN[0]] = hold_spatial(
            k, ranks, "sgu", SPATIAL_UNEVEN, refs, "10c")
        launched_windows.update(*(r["windows"] for r in ranks))
    missing = sorted(launched_windows - held_windows)
    check(launched_windows and not missing,
          "10a held every window shape that the ranks of 10b and 10c "
          "launched correlation, corr_norm and conv3x3_seg at (%d shapes "
          "launched, %d held, not held: %s)"
          % (len(launched_windows), len(held_windows), missing[:5]))
    out["seconds"] = time.perf_counter() - t0
    print("  info phase 10 took %.1f s" % out["seconds"], flush=True)
    print(json.dumps({"phase_10": out}), flush=True)
    return out


# --- phase 11: the port's bench and its batch sweep ------------------------
# the bench's pairs are phase 5's b4_384x1280, whose JAX interior EPE is
# in JAX_REFERENCE; the fused A/B may exceed the chaos floor by AB_BAR px
BENCH_REFERENCE = "b4_384x1280"
AB_BAR = 0.02
SWEEP_BATCHES = (4, 8, 16)
# the bench's forward is the network without the occlusion check (as the
# JAX bench applies it): phase 3's bf16 counts less the check's two warps
BENCH_LAUNCHES_PER_FORWARD = dict(BF16_LAUNCHES_PER_FORWARD, warp=0)
# the fused A/B's off side: the fp32 forward with every feature warp on
# its plain version (phase 3's SGU counts, less the check's two warps)
AB_OFF_LAUNCHES = dict(SGU_LAUNCHES_PER_FORWARD, warp=0, feature_warp=0)
AB_OFF_PLAIN_CALLS = {n: (SGU_LAUNCHES_PER_FORWARD["feature_warp"]
                          if n == "feature_warp" else 0)
                      for n in SGU_LAUNCHES_PER_FORWARD}
# frames that earlier phases hold every kernel at: phase 2's, phase 8a's
HELD_FRAMES = {(MAIN_B, MAIN_H, MAIN_W), *SHAPE_SIZES}
# the JAX bench's keys, less "degraded", and the port's additions
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "sgu_fallback_pairs_per_sec", "loop_dispatch_overhead_s",
              "weights", "epe_vs_gt_bf16_px", "epe_vs_gt_fp32_px",
              "bf16_vs_fp32_mean_epe_px", "bf16_vs_fp32_frac_gt_1px",
              "bf16_vs_fp32_max_epe_px", "fused_on_off_fp32_mean_epe_px",
              "chaos_floor_fp32_mean_epe_px",
              "train_pairs_per_sec_fp32_256x832", "device", "power_limit",
              "batch", "hw", "iters")
BENCH_RATES = ("value", "sgu_fallback_pairs_per_sec",
               "train_pairs_per_sec_fp32_256x832")
REPRO_STEPS = 5  # uninterrupted steps a run of 11c
# 11c's modes: phase 6's recipe at fp32 and bf16, 7a's equivariance pass
# at fp32, and the SSIM photometric loss (its avg_pool2d runs on no other
# path of this script) at fp32 (name: knobs, eq_loss_weight)
REPRO_MODES = {"fp32": (TRAIN_KNOBS, 0.0),
               "bf16": (dict(TRAIN_KNOBS, compute_dtype="bfloat16"), 0.0),
               "fp32 eq": (TRAIN_KNOBS, 0.1),
               "fp32 SSIM": (dict(TRAIN_KNOBS, photo_loss_type="SSIM"), 0.0)}


def positive(x) -> bool:
    return isinstance(x, (int, float)) and bool(np.isfinite(x)) and x > 0


def zero_counts(k) -> None:
    for fn in k.dispatch.values():
        fn.launches = 0
    for fn in k.plain.values():
        fn.cuda_calls = 0


def bench_launches(k):
    """11a: one chained forward of the bench launches phase 3's kernels of
    its path, no plain version, and, besides the network's own device
    kernels, only the chain's ops; one step of the bench's train lane
    launches phase 6's fp32 counts (the image warp among them)."""
    hb = k.headline
    model, _ = hb.load_model(hb.CONF, DEV)
    im1, im2 = (hb.as_nchw(x, DEV) for x in textured_pair(
        MAIN_B, MAIN_H, MAIN_W, 31))
    run = hb.chained_loop(model, im1, im2, 1)
    run(0.0)  # packs the weights, fills the caches
    zero_counts(k)
    run(1.0)
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in k.dispatch.items()}
    plain_calls = {n: fn.cuda_calls for n, fn in k.plain.items()}
    check(launched == BENCH_LAUNCHES_PER_FORWARD
          and not any(plain_calls.values()),
          "11a one bench forward (bf16, B=4 384x1280): launches %s (phase "
          "3's bf16 counts less the occlusion check's 2 warps), plain "
          "calls on CUDA tensors %s" % (launched, plain_calls))
    # device kernels, each a difference of two profiler windows that start
    # (and end) alike: in a long process the profiler misses a window's
    # first or last few dozen device events, as many in both windows; and
    # now and then a whole window's (phase 2 retries for it), so each
    # window's count is the largest of DEVICE_MS_ATTEMPTS
    def count(*fns):
        def window():
            for fn in fns:
                fn()
        return max(k.cli["wall"].kernel_count(window)[0]
                   for _ in range(DEVICE_MS_ATTEMPTS))

    acc = im1.new_zeros(())
    flow = torch.zeros_like(im1[:, :2])

    def forward():
        hb.forward_flow(model, im1, im2)

    def chain_ops():
        hb.accumulate(acc, hb.chain_input(im1, acc)[:, :2], flow)

    one = count(lambda: run(2.0))
    two = count(lambda: hb.chained_loop(model, im1, im2, 2)(3.0))
    base = count(forward)
    alone = count(forward, forward) - base
    chain = count(forward, chain_ops) - base
    check(two - one == alone + chain,
          "11a device kernels of one chained forward %d = the network's "
          "%d + the chain's %d (the perturbed input, two sums, two adds; "
          "windows: loops of one and two %d, %d; a forward %d)"
          % (two - one, alone, chain, one, two, base))
    del model, run

    # the A/B's off side reaches every feature warp of the model: each runs
    # the plain version on the card, the kernel none
    model, _ = hb.load_model(hb.CONF_AB, DEV)
    zero_counts(k)
    with hb.plain_feature_warp():
        hb.forward_flow(model, im1, im2)
    torch.cuda.synchronize()
    ab_launched = {n: fn.launches for n, fn in k.dispatch.items()}
    ab_plain = {n: fn.cuda_calls for n, fn in k.plain.items()}
    check(ab_launched == AB_OFF_LAUNCHES and ab_plain == AB_OFF_PLAIN_CALLS,
          "11a the fused A/B's off side (fp32, plain_feature_warp): "
          "launches %s, plain calls on CUDA tensors %s (want %s, %s)"
          % (ab_launched, ab_plain, AB_OFF_LAUNCHES, AB_OFF_PLAIN_CALLS))
    del model

    model, state, opt = k.step.create_train_state(hb.TRAIN_CONF,
                                                  k.TrainerConfig())
    step_fn = k.step.make_train_step(model, opt)
    batch = train_batch(k)
    zero_counts(k)
    step_fn(state, batch)
    torch.cuda.synchronize()
    got = {n: fn.launches for n, fn in k.dispatch.items()}
    plain_calls = {n: fn.cuda_calls for n, fn in k.plain.items()}
    check(got == SGU_LAUNCHES_PER_FORWARD and not any(plain_calls.values()),
          "11a one step of the bench's train lane (fp32, B=4 256x832): "
          "launches %s, plain calls on CUDA tensors %s"
          % (got, plain_calls))
    return dict(forward_launches=launched, train_step_launches=got,
                ab_off_launches=ab_launched, ab_off_plain_calls=ab_plain,
                device_kernels=dict(chained_forward=two - one,
                                    network=alone, chain=chain))


def hold_bench(k, result, ref_epe):
    """11b's gates on the bench's JSON line."""
    missing = [key for key in BENCH_KEYS if key not in result]
    check(not missing and "degraded" not in result,
          "11b bench line has every key (missing %s), no 'degraded'"
          % missing)
    check(result.get("device") == nvidia_smi_line().split(",")[0].strip()
          and result.get("unit") == "pairs/sec/gpu",
          "11b bench line names the card: %s, %s, unit %s"
          % (result.get("device"), result.get("power_limit"),
             result.get("unit")))
    for key in BENCH_RATES:
        check(positive(result.get(key)),
              "11b %s = %s is finite and > 0" % (key, result.get(key)))
    for key in ("epe_vs_gt_bf16_px", "epe_vs_gt_fp32_px"):
        v = result.get(key)
        check(positive(v) and abs(v - ref_epe) <= EPE_BAR,
              "11b %s %s within %g px of the JAX package's %.4f"
              % (key, v, EPE_BAR, ref_epe))
    ab = result.get("fused_on_off_fp32_mean_epe_px")
    floor = result.get("chaos_floor_fp32_mean_epe_px")
    check(isinstance(ab, float) and isinstance(floor, float)
          and ab <= floor + AB_BAR,
          "11b fused A/B %s px <= chaos floor %s px + %g"
          % (ab, floor, AB_BAR))
    median = result.get("sgu_fallback_median_inter_flow_px")
    halo = k.headline.SGU_HALO_PX
    check(isinstance(median, float) and median > halo,
          "11b out-of-halo lane: SGU head x %s, final stage's median "
          "inter-flow %s px beyond the %d-px halo; %s against %s pairs/s"
          % (result.get("sgu_fallback_head_scale"), median, halo,
             result.get("sgu_fallback_pairs_per_sec"), result.get("value")))


def hold_sweep(summary):
    """11b's gates on the sweep's summary."""
    rates = summary.get("sweep", {})
    peaks = summary.get("peak_memory_gib", {})
    check(sorted(rates) == list(SWEEP_BATCHES)
          and all(positive(v) for v in rates.values())
          and all(positive(peaks.get(b)) for b in SWEEP_BATCHES)
          and summary.get("best_batch") in SWEEP_BATCHES,
          "11b sweep: pairs/s %s, peak GiB %s, best batch %s"
          % ({b: round(v, 2) for b, v in rates.items()},
             peaks,
             summary.get("best_batch")))


def quantile_999(d: torch.Tensor) -> float:
    """The 99.9th percentile of the flat ``d`` (``torch.quantile``'s linear
    rule; it refuses more than 2**24 values, which B=16 flows exceed)."""
    s = d.double().sort().values
    pos = 0.999 * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return (s[lo] + (s[hi] - s[lo]) * (pos - lo)).item()


def hold_sweep_frames(k):
    """11b: the sweep's batches at the kernels and end to end.  At each
    batch of ``SWEEP_BATCHES`` that no earlier phase holds, phase 8a's
    checks (``hold_frame``) at B x 384x1280; then at every batch, one
    forward of the sweep's model on the sweep's pairs launches
    ``BENCH_LAUNCHES_PER_FORWARD`` and no plain version, and its flows
    agree with the plain path's (every kernel on its plain version, none
    launched) under the bf16 path's ``AGREEMENT`` bars at phase 3's
    relaxed threshold."""
    hb = k.headline
    held = {}

    def hold(name, ok, what):
        check(ok, "11b " + what)
        held[name] = held.get(name, 0) + 1

    rng = np.random.RandomState(11)
    gen = torch.Generator(device=DEV).manual_seed(11)
    model, _ = hb.load_model(hb.CONF, DEV)
    frames = {"B=%d %dx%d" % (b, MAIN_H, MAIN_W): hold_frame(
        k, b, MAIN_H, MAIN_W, rng, gen, hold, model, "11b")
        for b in SWEEP_BATCHES if (b, MAIN_H, MAIN_W) not in HELD_FRAMES}
    torch.cuda.empty_cache()
    data = hb.render_pairs(max(SWEEP_BATCHES), 7, (MAIN_H, MAIN_W))
    mean_bar, p999_bar, _ = AGREEMENT["sgu-bf16"]
    forwards = {}
    saved = k.warp_ops.MASK_THRESHOLD
    k.warp_ops.MASK_THRESHOLD = RELAXED_THRESHOLD
    try:
        for b in SWEEP_BATCHES:
            im1, im2 = (hb.as_nchw(data[key][:b], DEV)
                        for key in ("im1", "im2"))
            with torch.no_grad(), k.resize.fp32_numerics():
                zero_counts(k)
                got = model(im1, im2)[:2]
                torch.cuda.synchronize()
                launched = {n: fn.launches for n, fn in k.dispatch.items()}
                plain_calls = sum(fn.cuda_calls for fn in k.plain.values())
                with plain_path(k):
                    zero_counts(k)
                    ref = model(im1, im2)[:2]
                    torch.cuda.synchronize()
                plain_launches = sum(fn.launches
                                     for fn in k.dispatch.values())
                plain_ran = sum(fn.cuda_calls for fn in k.plain.values())
            d = torch.cat([(x.float() - y.float()).abs().flatten()
                           for x, y in zip(got, ref)])
            mean, p999 = d.mean().item(), quantile_999(d)
            check(launched == BENCH_LAUNCHES_PER_FORWARD and plain_calls == 0
                  and plain_launches == 0 and plain_ran > 0
                  and mean < mean_bar and p999 < p999_bar,
                  "11b sweep forward B=%d %dx%d: launches %s, plain calls "
                  "%d; the plain path launched %d kernels, %d plain calls; "
                  "at threshold %g |flow - plain flow| mean %.3e px (< %g), "
                  "p99.9 %.3e px (< %g)"
                  % (b, MAIN_H, MAIN_W, launched, plain_calls,
                     plain_launches, plain_ran, RELAXED_THRESHOLD, mean,
                     mean_bar, p999, p999_bar))
            forwards[b] = dict(launches=launched, mean_px=mean,
                               p999_px=p999)
            del im1, im2, got, ref, d
    finally:
        k.warp_ops.MASK_THRESHOLD = saved
    del model
    return dict(frames=frames, shapes_held=held, forwards=forwards)


def repro_run(k, conf, batch, eq_weight):
    """``REPRO_STEPS`` uninterrupted steps of ``make_train_step`` from the
    checkpoint: the steps' metrics, the parameters after them, each
    step's ms and the run's peak memory (GiB)."""
    model, state, opt = k.step.create_train_state(conf, k.TrainerConfig(),
                                                  weights=str(NPZ))
    step_fn = k.step.make_train_step(model, opt, eq_loss_weight=eq_weight)
    metrics, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(REPRO_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({key: v.clone() for key, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return metrics, {n: p.detach().clone()
                     for n, p in model.named_parameters()}, ms, peak


def raises_under_strict_mode(k, op) -> str:
    """The message of the RuntimeError that ``op`` raises under the
    package's ``deterministic_numerics``, or '' if it raises none."""
    try:
        with k.step.deterministic_numerics():
            op()
            torch.cuda.synchronize()
    except RuntimeError as e:
        return str(e)
    return ""


def phase_repro(k):
    """11c: card training is reproducible run to run.  For each of
    ``REPRO_MODES`` two runs of ``REPRO_STEPS`` steps from the checkpoint,
    as the package runs them (``make_train_step`` under its
    ``deterministic_numerics``), must give bit-equal losses and
    parameters.  A run between them with the package's manager replaced
    by a null context for the block (a measurement-only patch, restored
    after it) times what determinism costs: each mode's median step ms
    after the first step, both ways, and the ratio; and each way's peak
    memory.
    ``bincount`` with weights, which has no deterministic CUDA kernel,
    must raise under the manager: strict mode is on.  ``kthvalue``, which
    raised nothing under it in torch 2.11, is a reading."""
    batch = train_batch(k)
    out = {}
    probe = {"bincount": lambda: torch.bincount(
                 torch.zeros(4, dtype=torch.long, device=DEV),
                 weights=torch.ones(4, device=DEV)),
             "kthvalue": lambda: torch.kthvalue(
                 torch.arange(4.0, device=DEV), 2)}
    raised = {name: raises_under_strict_mode(k, op)
              for name, op in probe.items()}
    check(bool(raised["bincount"]), "11c bincount with weights raises "
          "under deterministic_numerics on the card: %s"
          % raised["bincount"][:60])
    print("  info 11c kthvalue under deterministic_numerics: %s"
          % (raised["kthvalue"][:60] or "no error"))
    for mode, (knobs, eq_weight) in REPRO_MODES.items():
        conf = k.UPFlowConfig().updated(knobs)
        ma, pa, msa, peak = repro_run(k, conf, batch, eq_weight)
        saved = k.step.deterministic_numerics
        k.step.deterministic_numerics = contextlib.nullcontext
        try:
            _, _, msc, peak_default = repro_run(k, conf, batch, eq_weight)
        finally:
            k.step.deterministic_numerics = saved
        mb, pb, msb, _ = repro_run(k, conf, batch, eq_weight)
        losses_equal = all(torch.equal(a[key], b[key])
                           for a, b in zip(ma, mb) for key in a)
        params_equal = pa.keys() == pb.keys() and all(
            torch.equal(pa[n], pb[n]) for n in pa)
        losses = [[float(m["total_loss"]) for m in run] for run in
                  (ma, mb)]
        check(all(np.isfinite(v) for run in losses for v in run)
              and losses_equal and params_equal,
              "11c %s: two runs of %d steps, losses bit-equal %s, "
              "parameters bit-equal %s; total losses %s"
              % (mode, REPRO_STEPS, losses_equal, params_equal, losses))
        del pa, pb
        strict = statistics.median(msa[1:] + msb[1:])
        default = statistics.median(msc[1:])
        print("  info 11c %s: step ms %s deterministic (median after the "
              "first %.1f), %s without the manager (%.1f), ratio %.4f; "
              "peak %.2f / %.2f GiB (%s)"
              % (mode, [round(v, 1) for v in msa + msb], strict,
                 [round(v, 1) for v in msc], default, strict / default,
                 peak, peak_default, nvidia_smi_line()))
        out[mode] = dict(losses_bit_equal=losses_equal,
                         params_bit_equal=params_equal, total_losses=losses,
                         step_ms=msa + msb, step_ms_default=msc,
                         median_ms=strict, median_ms_default=default,
                         ratio=strict / default, peak_memory_gib=peak,
                         peak_memory_gib_default=peak_default)
        torch.cuda.empty_cache()
    out["strict_probe"] = {name: msg[:200] for name, msg in raised.items()}
    return out


def phase_bench(k):
    """Phase 11: the port's bench at its defaults, then the sweep at
    ``SWEEP_BATCHES``, then 11c; prints one JSON line."""
    t0 = time.perf_counter()
    out = {"11a": bench_launches(k)}
    out["11a_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ref = json.loads(JAX_REFERENCE.read_text())["requests"][BENCH_REFERENCE]
    print("phase 11b: python -m upflow_pytorch_tpu_torch.bench", flush=True)
    t1 = time.perf_counter()
    result = k.headline.main([])
    out["bench_s"] = time.perf_counter() - t1
    hold_bench(k, result, ref["epe_interior"])
    torch.cuda.empty_cache()
    print("phase 11b: scripts/torch_bench_batch_sweep.py batches=%s"
          % ",".join(map(str, SWEEP_BATCHES)), flush=True)
    t1 = time.perf_counter()
    summary = k.cli["sweep"].main(["batches=%s" % ",".join(
        map(str, SWEEP_BATCHES))])
    out["sweep_s"] = time.perf_counter() - t1
    hold_sweep(summary)
    torch.cuda.empty_cache()
    print("phase 11b: the sweep's batches against the plain versions",
          flush=True)
    t1 = time.perf_counter()
    out["sweep_held"] = hold_sweep_frames(k)
    out["sweep_held_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    print("phase 11c: training is reproducible run to run", flush=True)
    out["11c"] = phase_repro(k)
    out["seconds"] = time.perf_counter() - t0
    print("  info phase 11 took %.1f s (11a %.1f s, bench %.1f s, sweep %.1f "
          "s, its batches held %.1f s)"
          % (out["seconds"], out["11a_s"], out["bench_s"], out["sweep_s"],
             out["sweep_held_s"]), flush=True)
    print(json.dumps({"phase_11": out}), flush=True)
    return out


class Port:
    """The port's modules, imported once the card is known to be there."""

    def __init__(self):
        sys.path.insert(0, str(ROOT))
        from upflow_pytorch_tpu_torch import _build
        from upflow_pytorch_tpu_torch.checkpoint import (
            npz_io, state_io, torch_import)
        from upflow_pytorch_tpu_torch.config import UPFlowConfig
        from upflow_pytorch_tpu_torch.data import synthetic
        from upflow_pytorch_tpu_torch.eval import bench
        from upflow_pytorch_tpu_torch.config import GMFlowConfig, RAFTConfig
        from upflow_pytorch_tpu_torch.models import (
            entry, gmflow, raft, upflow)
        from upflow_pytorch_tpu_torch.ops import conv as conv_ops
        from upflow_pytorch_tpu_torch.ops import resize
        from upflow_pytorch_tpu_torch.ops.kernels import corr_lookup as cl
        from upflow_pytorch_tpu_torch.ops.kernels import global_match as gm
        from upflow_pytorch_tpu_torch.ops import warp as warp_ops
        from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg
        from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as cn
        from upflow_pytorch_tpu_torch.ops.kernels import correlation as corr
        from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as fw
        from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as sb
        from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as sf
        from upflow_pytorch_tpu_torch.ops.kernels import warp
        from upflow_pytorch_tpu_torch.parallel import dryrun
        from upflow_pytorch_tpu_torch.parallel import mesh as pmesh
        from upflow_pytorch_tpu_torch.parallel import step as pstep
        from upflow_pytorch_tpu_torch.train import step, trainer
        from upflow_pytorch_tpu_torch.config import TrainerConfig
        from upflow_pytorch_tpu_torch import demo
        from upflow_pytorch_tpu_torch.data import (
            flow_io, kitti, native, pipeline, sintel)
        sys.path.insert(0, str(ROOT / "scripts"))
        import torch_bench_batch_sweep
        import torch_forward_wall
        import torch_kitti_eval
        import torch_synthetic_trees
        import torch_train_kitti
        import torch_train_sintel
        from upflow_pytorch_tpu_torch import bench as headline

        self.build, self.UPFlowConfig = _build, UPFlowConfig
        self.step, self.TrainerConfig = step, TrainerConfig
        self.entry, self.upflow, self.resize = entry, upflow, resize
        self.raft, self.cl, self.RAFTConfig = raft, cl, RAFTConfig
        self.gmflow, self.gm, self.GMFlowConfig = gmflow, gm, GMFlowConfig
        self.pmesh, self.pstep, self.dryrun = pmesh, pstep, dryrun
        self.warp_ops, self.cn, self.corr, self.fw, self.warp = (
            warp_ops, cn, corr, fw, warp)
        self.sb, self.sf, self.conv_ops, self.seg = sb, sf, conv_ops, seg
        self.synthetic, self.bench, self.trainer = synthetic, bench, trainer
        self.npz_io, self.state_io, self.torch_import = (
            npz_io, state_io, torch_import)
        self.flow_io, self.native, self.pipeline = flow_io, native, pipeline
        self.kitti, self.sintel, self.demo = kitti, sintel, demo
        self.headline = headline  # the port's bench
        # the port's dataset CLIs and the synthetic trees' writer
        self.cli = {"kitti_eval": torch_kitti_eval,
                    "train_kitti": torch_train_kitti,
                    "train_sintel": torch_train_sintel,
                    "trees": torch_synthetic_trees,
                    "sweep": torch_bench_batch_sweep,
                    "wall": torch_forward_wall}
        self.dispatch = {"correlation": corr.correlation,
                         "feature_warp": fw.feature_warp,
                         "corr_norm": cn.corr_norm, "warp": warp.warp,
                         "sgu_blend": sb.sgu_blend, "sgu_final": sf.sgu_final,
                         "conv3x3_seg": seg.conv3x3_seg}
        self.plain = {"correlation": corr.correlation_plain,
                      "feature_warp": fw.feature_warp_plain,
                      "corr_norm": cn.corr_norm_plain,
                      "warp": warp.warp_plain,
                      "sgu_blend": sb.sgu_blend_plain,
                      "sgu_final": sf.sgu_final_plain,
                      "conv3x3_seg": seg.conv3x3_seg_plain}
        # each kernel op's autograd Function (its backward is the JAX
        # package's gradient rule)
        self.functions = {"correlation": corr.CorrelationFn,
                          "feature_warp": fw.FeatureWarpFn,
                          "corr_norm": cn.CorrNormFn, "warp": warp.WarpFn,
                          "sgu_blend_pair": sb.SguBlendPairFn,
                          "sgu_blend": sb.SguBlendFn,
                          "sgu_final": sf.SguFinalFn,
                          "conv3x3_seg": seg.Conv3x3SegFn}


SOURCES = {
    "correlation": ("upflow_pytorch_tpu_torch/csrc/correlation.cu",
                    "upflow_pytorch_tpu/ops/pallas/correlation.py:90"),
    "feature_warp": ("upflow_pytorch_tpu_torch/csrc/feature_warp.cu",
                     "upflow_pytorch_tpu/ops/pallas/feature_warp.py:208"),
    "corr_norm": ("upflow_pytorch_tpu_torch/csrc/corr_norm.cu",
                  "upflow_pytorch_tpu/ops/pallas/corr_norm.py:122"),
    "warp": ("upflow_pytorch_tpu_torch/csrc/warp.cu",
             "upflow_pytorch_tpu/ops/pallas/warp.py:368"),
    "warp_window": ("upflow_pytorch_tpu_torch/csrc/warp.cu",
                    "upflow_pytorch_tpu/ops/pallas/warp.py:214"),
    "sgu_blend": ("upflow_pytorch_tpu_torch/csrc/sgu_blend.cu",
                  "upflow_pytorch_tpu/ops/pallas/blend.py:114"),
    "sgu_final": ("upflow_pytorch_tpu_torch/csrc/sgu_final.cu",
                  "upflow_pytorch_tpu/ops/pallas/sgu_final.py:155"),
    "conv3x3_seg": ("upflow_pytorch_tpu_torch/csrc/conv3x3_seg.cu",
                    "upflow_pytorch_tpu/ops/pallas/conv.py:382"),
}
SOURCES.update({row: SOURCES[kernel] for row, kernel in SERVED_BY.items()
                if row != "warp_window"})
# the rows that the bf16 path runs: their launches are counted there
BF16_ROWS = ("conv3x3_seg", "correlation_bf16", "feature_warp_bf16",
             "corr_norm_bf16", "sgu_blend_bf16")


RAFT_LOOKUPS = (("b1_375x1242", 2, 47, 156, 20.0),  # the cell's grid
                ("odd_17x45", 3, 17, 45, 60.0),  # a ragged edge, 3 items
                ("b2_384x1280", 4, 48, 160, 30.0))
RAFT_FRAME = (375, 1242)
RAFT_GRID = (47, 156)  # the 1/8 grid of the frame padded to 376x1248
# the request through the plain lookup and conv3x3_seg against the kernels'
# (flow EPE, px, the worse direction): both round at the same points and
# part by summation order alone, 0.031 px on the H100 over 24 iterations;
# a kernel that drops a bias, a ReLU or a channel range moves the flow by
# pixels
RAFT_PLAIN_EPE = 0.1
RAFT_FORWARDS = 20
RAFT_SPANS = ("upflow.raft.encoders", "upflow.raft.corr_volume",
              "upflow.raft.lookup", "upflow.raft.update",
              "upflow.raft.upsample", "upflow.kernel.corr_lookup")
# the lookup's bar: the kernel skips grid_sample's normalising round trip,
# which moves a coordinate by a few fp32 ulps of ~150 px (<1e-4 px), so a
# value by less than 1e-4 of the volume's largest; at bf16 the two round
# that to bf16, so they may also part by one bf16 ulp (at most 2^-7 of
# the value)
RAFT_LOOKUP_REL = 1e-4


def lookup_case(k, n, h, w, amp, seed):
    """A random bf16 feature pair's pyramid and coordinates around the
    grid, some pixels pushed partly or wholly outside every level."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    f1 = torch.randn(n, 256, h, w, device=DEV, generator=g).bfloat16()
    f2 = torch.randn(n, 256, h, w, device=DEV, generator=g).bfloat16()
    pyramid = k.raft.corr_pyramid(f1, f2)
    rng = np.random.RandomState(seed)
    coords = k.raft.coords_grid(n, h, w, DEV) + make_flow(rng, n, h, w, amp)
    coords[:, 0, 0, :5] = torch.tensor([-6.5, w + 3.2, -1e7, 1e7, w - 1.0])
    return pyramid, coords.contiguous()


def phase_raft(k):
    """RAFT (``models/raft.py``): the lookup kernel against its plain
    version, ``conv3x3_seg`` at RAFT's shapes and buffer ranges, and the
    entry at 375x1242 eagerly, from its graph and on the plain versions.
    Returns the phase's numbers."""
    out = {"lookup": [], "card": nvidia_smi_line()}
    for name, n, h, w, amp in RAFT_LOOKUPS:
        pyramid, coords = lookup_case(k, n, h, w, amp, len(out["lookup"]))
        scale = pyramid[0].abs().max().item()
        row = {"case": name, "n": n, "grid": [h, w],
               "levels": [list(v.shape[2:]) for v in pyramid]}
        for dtype in (torch.float32, torch.bfloat16):
            got = k.cl.corr_lookup_cuda(pyramid, coords, dtype).float()
            ref = k.cl.corr_lookup_plain(pyramid, coords, dtype).float()
            diff = (got - ref).abs()
            bar = RAFT_LOOKUP_REL * scale
            if dtype == torch.bfloat16:
                bar = bar + 2.0 ** -7 * ref.abs()
            ok = bool((diff <= bar).all()) and bool(torch.isfinite(got).all())
            check(ok, "corr_lookup %s %s: max |kernel - plain| %.3e (volume "
                  "max %.3f)" % (name, str(dtype)[6:], diff.max().item(),
                                 scale))
            row["max_abs_err_" + str(dtype)[6:]] = diff.max().item()
        # a second call gives the same bits
        a = k.cl.corr_lookup_cuda(pyramid, coords, torch.bfloat16)
        b = k.cl.corr_lookup_cuda(pyramid, coords, torch.bfloat16)
        check(torch.equal(a, b), "corr_lookup %s: the same bits twice" % name)
        px = n * h * w
        # a pixel's 10x10 footprint on each level, as much as it holds
        nbytes = px * (8 + sum(4 * min(10, v.shape[2]) * min(10, v.shape[3])
                               for v in pyramid) + 324 * 2)
        row["ms"] = time_ms(lambda: k.cl.corr_lookup_cuda(
            pyramid, coords, torch.bfloat16))
        row["device_ms"], _ = device_ms(lambda: k.cl.corr_lookup_cuda(
            pyramid, coords, torch.bfloat16), "corr_lookup_kernel")
        row["plain_ms"] = time_ms(lambda: k.cl.corr_lookup_plain(
            pyramid, coords, torch.bfloat16), reps=5, inner=2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, px * 324 * 7)
        print("  info corr_lookup %s: kernel %s ms (device %s), plain %s, "
              "bound %s ms (%s)" % (name, fmt(row["ms"]),
                                    fmt(row["device_ms"]),
                                    fmt(row["plain_ms"]), fmt(row["bound_ms"]),
                                    row["bound_by"]), flush=True)
        out["lookup"].append(row)
        del pyramid
    # conv3x3_seg at every shape and buffer range a RAFT request gives it
    for what, ok in raft_conv_cases(k):
        check(ok[0], "conv3x3_seg %s: %s" % (what, ok[1]))

    # the entry at 375x1242, bf16
    conf = k.RAFTConfig(compute_dtype="bfloat16")
    model = k.entry.build_model(conf, seed=5)
    h, w = RAFT_FRAME
    im1, im2 = textured_pair(1, h, w, 31)
    im1, im2 = im1 * 255.0, im2 * 255.0
    with k.entry.eager_entry():
        zero_counts(k)
        k.cl.corr_lookup.launches = 0
        k.cl.corr_lookup_plain.cuda_calls = 0
        iters0 = k.raft.RAFTNet.iterations
        eager = k.entry.forward(model, im1, im2)
        torch.cuda.synchronize()
        launches = {"corr_lookup": k.cl.corr_lookup.launches,
                    "conv3x3_seg": k.seg.conv3x3_seg.launches,
                    "iterations": k.raft.RAFTNet.iterations - iters0}
    check(launches["corr_lookup"] == conf.iters
          and launches["iterations"] == conf.iters
          and k.cl.corr_lookup_plain.cuda_calls == 0
          and k.seg.conv3x3_seg_plain.cuda_calls == 0,
          "RAFT request: %s, no plain version on the card" % launches)
    check(all(bool(torch.isfinite(eager[key]).all())
              for key in ("flow_f_out", "flow_b_out")),
          "RAFT flows finite (mean |flow| %.2f px)"
          % eager["flow_f_out"].norm(dim=-1).mean().item())
    f = k.entry.forward
    c0, r0 = f.graph_captures, f.graph_replays
    outs = [k.entry.forward(model, im1, im2) for _ in range(4)]
    torch.cuda.synchronize()
    check(f.graph_captures - c0 == 1 and f.graph_replays - r0 == 2,
          "RAFT entry: one capture and two replays after the key's first "
          "call (%d, %d)" % (f.graph_captures - c0, f.graph_replays - r0))
    same = all(torch.equal(o[key], eager[key]) for o in outs[1:]
               for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw"))
    check(same, "RAFT graph replays bit for bit the eager request")
    out["launches"] = launches
    out["forward_ms"] = wall_ms(lambda: k.entry.forward(model, im1, im2),
                                reps=RAFT_FORWARDS)
    out["eager_forward_ms"] = wall_ms(lambda: eager_call(k, model, im1, im2),
                                      reps=3)
    out["device_ms"] = time_ms(lambda: k.entry.forward(model, im1, im2),
                               reps=5, inner=4)
    # the whole request through the plain lookup and conv
    with raft_plain(k):
        plain = k.entry.forward(model, im1, im2)
    out["plain_path_epe_px"] = epe = max(
        (eager[key] - plain[key]).norm(dim=-1).mean().item()
        for key in ("flow_f_out", "flow_b_out"))
    check(epe <= RAFT_PLAIN_EPE, "RAFT request through the plain lookup and "
          "conv3x3_seg: %.4f px EPE from the kernels' (bar %.2f)"
          % (epe, RAFT_PLAIN_EPE))
    # a profiled request: the spans and the lookup kernel under its span
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        k.entry.forward(model, im1, im2)
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events if e.device_type == DeviceType.CPU]
    out["device_ops"] = sum(1 for e in events
                            if e.device_type == DeviceType.CUDA)
    spans = {s: names.count(s) for s in RAFT_SPANS}
    check(all(spans.values()) and spans["upflow.raft.lookup"] == conf.iters
          and spans["upflow.raft.update"] == conf.iters,
          "RAFT spans in a profiled request: %s" % spans)
    by_span = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        parent, anc = e, []
        while parent is not None:
            anc.append(parent.name)
            parent = parent.cpu_parent
        top = next((a for a in anc if a.startswith("upflow.raft.")), "other")
        by_span[top] = by_span.get(top, 0.0) + sum(
            kk.duration for kk in e.kernels) / 1e3
    out["device_ms_by_span"] = by_span
    out["spans"] = spans
    print("  info RAFT 375x1242 bf16: forward %s ms from the graph (eager "
          "%s), device %s ms, %d device operations; by span %s" % (
              fmt(out["forward_ms"]), fmt(out["eager_forward_ms"]),
              fmt(out["device_ms"]), out["device_ops"],
              {s: round(v, 3) for s, v in by_span.items()}), flush=True)
    return out


def raft_conv_cases(k):
    """``conv3x3_seg`` against its plain version at each 3x3 stride-1 conv
    of a bf16 RAFT request at 375x1242 (two items: both directions), on
    the buffers the request gives it: the encoders' convs without an
    activation (a norm follows), and the update block's with ReLU or none,
    reading and writing channel ranges of ``cf`` (256 channels), ``hx``
    (384) and the heads' map (512) as ``BasicUpdateBlock.step`` does.  A
    write into a range leaves the buffer's other channels as they were.
    Yields (what, (ok, description))."""
    rng = np.random.RandomState(12)
    h, w = RAFT_GRID

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(DEV)

    def case(what, x, cout, relu, buf=None, chans=None):
        cin = x.shape[1]
        wt = rand(cout, cin, 3, 3) / np.sqrt(9 * cin)
        bias = rand(cout) * 0.1
        before = None if buf is None else buf.clone()
        got = k.seg.conv3x3_seg_cuda(x, wt, bias, 1, relu,
                                     None if buf is None else buf[:, chans])
        ref = k.seg.conv3x3_seg_plain(x, wt, bias, 1, relu).float()
        _, (ok, desc) = conv_agreement(got.float(), ref)
        if relu:
            ok = ok and bool((got >= 0).all())
        if buf is not None:
            keep = torch.ones(buf.shape[1], dtype=torch.bool, device=DEV)
            keep[chans] = False
            ok = ok and torch.equal(buf[:, keep], before[:, keep])
        return "%s, %d->%d at %dx%dx%d" % (what, cin, cout, x.shape[0],
                                           x.shape[2], x.shape[3]), (ok, desc)

    for cin, (hh, ww) in ((64, (4 * h, 4 * w)), (96, (2 * h, 2 * w)),
                          (128, (h, w))):
        yield case("encoder, no activation", rand(2, cin, hh, ww).bfloat16(),
                   cin, False)
    relu = k.seg.RELU
    cf = rand(2, 256, h, w).bfloat16()
    hx = rand(2, 384, h, w).bfloat16()
    heads = rand(2, 512, h, w).bfloat16()
    yield case("convc2 ReLU into cf[:, :192]", rand(2, 256, h, w).bfloat16(),
               192, relu, cf, slice(0, 192))
    yield case("convf2 ReLU into cf[:, 192:]", rand(2, 128, h, w).bfloat16(),
               64, relu, cf, slice(192, 256))
    yield case("conv ReLU of cf into hx[:, 256:382]", cf, 126, relu, hx,
               slice(256, 382))
    yield case("heads ReLU of hx[:, :128]", hx[:, :128], 512, relu)
    yield case("flow head of heads[:, :256]", heads[:, :256], 2, False)


def eager_call(k, model, im1, im2):
    with k.entry.eager_entry():
        return k.entry.forward(model, im1, im2)


@contextlib.contextmanager
def raft_plain(k):
    """RAFT's lookup and ``conv3x3_seg`` on their plain versions."""
    swaps = [(k.raft, "corr_lookup", k.cl.corr_lookup_plain),
             (k.conv_ops, "conv3x3_seg", k.seg.conv3x3_seg_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        with k.entry.eager_entry():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# the global matching kernel's cases: (name, N, L, S), the cell's first
GMFLOW_MATCHES = (("b1_48x156", 2, 7488, 7488),  # both directions
                  ("ragged_100x77", 3, 100, 77),
                  ("one_key", 1, 64, 1))
GMFLOW_FRAME = (375, 1242)
GMFLOW_GRID = (48, 156)  # the 1/8 grid of the frame padded to 384x1248
# the kernel's bar: it sums the same bf16 products as the plain version in
# fp32 in another order, with exp2 of the log2(e)-scaled scores: outputs
# agree within 1e-3 of v's largest magnitude
GMFLOW_MATCH_REL = 1e-3
# the request through the plain matching against the kernel's (flow EPE,
# px): the two part after the Transformer, by fp32 summation order alone
GMFLOW_PLAIN_MATCH_EPE = 0.05
GMFLOW_FORWARDS = 20
GMFLOW_SPANS = ("upflow.gmflow.encoder", "upflow.gmflow.transformer",
                "upflow.gmflow.match", "upflow.gmflow.propagate",
                "upflow.gmflow.upsample", "upflow.kernel.global_match")


def match_case(n, length, keys, seed):
    """Random bf16 features of the scale GMFlow's Transformer gives and a
    grid-like v of up to 156 px."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = (4 * torch.randn(n, length, 128, device=DEV, generator=g)).bfloat16()
    k = (4 * torch.randn(n, keys, 128, device=DEV, generator=g)).bfloat16()
    v = 156 * torch.rand(n, keys, 2, device=DEV, generator=g)
    return q, k, v


def phase_gmflow(k):
    """GMFlow (``models/gmflow.py``): the global matching kernel against
    its plain version, ``conv3x3_seg`` without a bias at the backbone's
    shapes, and the entry at 375x1242 eagerly, from its graph and on the
    plain matching.  Returns the phase's numbers."""
    sys.path.insert(0, str(ROOT))
    from benchmark.ops import global_match as op

    out = {"match": [], "card": nvidia_smi_line()}
    scale = 1 / math.sqrt(128)
    for name, n, length, keys in GMFLOW_MATCHES:
        q, kk, v = match_case(n, length, keys, len(out["match"]))
        got = k.gm.global_match_cuda(q, kk, v, scale)
        ref = k.gm.global_match_plain(q, kk, v, scale)
        diff = (got - ref).abs().max().item()
        bar = GMFLOW_MATCH_REL * v.abs().max().item()
        check(diff <= bar and bool(torch.isfinite(got).all()),
              "global_match %s: max |kernel - plain| %.3e (bar %.3e)"
              % (name, diff, bar))
        check(torch.equal(got, k.gm.global_match_cuda(q, kk, v, scale)),
              "global_match %s: the same bits twice" % name)
        nbytes, ops, kind = op.cost(q, kk, v, scale)
        row = {"case": name, "n": n, "queries": length, "keys": keys,
               "max_abs_err": diff}
        row["ms"] = time_ms(lambda: k.gm.global_match_cuda(q, kk, v, scale))
        row["device_ms"], _ = device_ms(
            lambda: k.gm.global_match_cuda(q, kk, v, scale),
            "global_match_kernel")
        row["plain_ms"] = time_ms(lambda: k.gm.global_match_plain(
            q, kk, v, scale), reps=5, inner=2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops,
                                                    BF16_OPS_PER_S)
        assert kind == "bfloat16"
        if row["device_ms"]:
            row["roofline_pct"] = 100 * row["bound_ms"] / row["device_ms"]
        print("  info global_match %s: kernel %s ms (device %s), plain %s, "
              "bound %s ms (%s)" % (name, fmt(row["ms"]),
                                    fmt(row["device_ms"]),
                                    fmt(row["plain_ms"]),
                                    fmt(row["bound_ms"]), row["bound_by"]),
              flush=True)
        out["match"].append(row)
    cell = out["match"][0]
    check(cell["ms"] < cell["plain_ms"], "global_match at the cell's shape: "
          "kernel %.3f ms, plain %.3f ms" % (cell["ms"], cell["plain_ms"]))
    for what, ok in gmflow_conv_cases(k):
        check(ok[0], "conv3x3_seg %s: %s" % (what, ok[1]))

    # the entry at 375x1242, bf16
    conf = k.GMFlowConfig(compute_dtype="bfloat16")
    model = k.entry.build_model(conf, seed=5)
    h, w = GMFLOW_FRAME
    im1, im2 = textured_pair(1, h, w, 33)
    im1, im2 = im1 * 255.0, im2 * 255.0
    calls = k.gmflow.GMFlowNet.attention_calls
    with k.entry.eager_entry():
        zero_counts(k)
        k.gm.global_match.launches = 0
        k.gm.global_match_plain.cuda_calls = 0
        calls0 = dict(calls)
        eager = k.entry.forward(model, im1, im2)
        torch.cuda.synchronize()
        launches = {"global_match": k.gm.global_match.launches,
                    "conv3x3_seg": k.seg.conv3x3_seg.launches,
                    "attention": {c: calls[c] - calls0[c] for c in calls}}
    check(launches["global_match"] == 2
          and launches["attention"] == {"window": 6, "shifted_window": 6,
                                        "global_match": 1, "propagate": 1}
          and k.gm.global_match_plain.cuda_calls == 0
          and k.seg.conv3x3_seg_plain.cuda_calls == 0,
          "GMFlow request: %s, no plain version on the card" % launches)
    check(all(bool(torch.isfinite(eager[key]).all())
              for key in ("flow_f_out", "flow_b_out")),
          "GMFlow flows finite (mean |flow| %.2f px)"
          % eager["flow_f_out"].norm(dim=-1).mean().item())
    f = k.entry.forward
    c0, r0 = f.graph_captures, f.graph_replays
    outs = [k.entry.forward(model, im1, im2) for _ in range(4)]
    torch.cuda.synchronize()
    check(f.graph_captures - c0 == 1 and f.graph_replays - r0 == 2,
          "GMFlow entry: one capture and two replays after the key's first "
          "call (%d, %d)" % (f.graph_captures - c0, f.graph_replays - r0))
    same = all(torch.equal(o[key], eager[key]) for o in outs[1:]
               for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw"))
    check(same, "GMFlow graph replays bit for bit the eager request")
    out["launches"] = launches
    out["forward_ms"] = wall_ms(lambda: k.entry.forward(model, im1, im2),
                                reps=GMFLOW_FORWARDS)
    out["eager_forward_ms"] = wall_ms(lambda: eager_call(k, model, im1, im2),
                                      reps=3)
    out["device_ms"] = time_ms(lambda: k.entry.forward(model, im1, im2),
                               reps=5, inner=4)
    torch.cuda.reset_peak_memory_stats()
    k.entry.forward(model, im1, im2)
    torch.cuda.synchronize()
    out["replay_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    def epe(a, b):
        return max((a[key] - b[key]).norm(dim=-1).mean().item()
                   for key in ("flow_f_out", "flow_b_out"))

    # the request through the plain matching, then the plain conv too
    with gmflow_plain(k, conv=False):
        plain = k.entry.forward(model, im1, im2)
    out["plain_match_epe_px"] = e = epe(eager, plain)
    check(e <= GMFLOW_PLAIN_MATCH_EPE, "GMFlow request through the plain "
          "matching: %.4f px EPE from the kernel's (bar %.2f)"
          % (e, GMFLOW_PLAIN_MATCH_EPE))
    with gmflow_plain(k, conv=True):
        plain = k.entry.forward(model, im1, im2)
    out["plain_path_epe_px"] = epe(eager, plain)
    print("  info GMFlow request through the plain matching and conv3x3_seg:"
          " %.4f px EPE from the kernels' (the global softmax turns the "
          "conv's summation order into flow)" % out["plain_path_epe_px"])
    # a profiled request: the spans and the kernel under its span
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        k.entry.forward(model, im1, im2)
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events if e.device_type == DeviceType.CPU]
    out["device_ops"] = sum(1 for e in events
                            if e.device_type == DeviceType.CUDA)
    spans = {s: names.count(s) for s in GMFLOW_SPANS}
    check(all(v == 1 for s, v in spans.items()
              if s != "upflow.kernel.global_match")
          and spans["upflow.kernel.global_match"] == 2,
          "GMFlow spans in a profiled request: %s" % spans)
    by_span, by_kernel = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        parent, anc = e, []
        while parent is not None:
            anc.append(parent.name)
            parent = parent.cpu_parent
        top = next((a for a in anc if a.startswith("upflow.gmflow.")),
                   "other")
        by_span[top] = by_span.get(top, 0.0) + sum(
            kk.duration for kk in e.kernels) / 1e3
    out["device_ms_by_span"] = by_span
    out["top_kernels_ms"] = sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1])[:15]
    out["spans"] = spans
    print("  info GMFlow 375x1242 bf16: forward %s ms from the graph (eager "
          "%s), device %s ms, %d device operations; by span %s" % (
              fmt(out["forward_ms"]), fmt(out["eager_forward_ms"]),
              fmt(out["device_ms"]), out["device_ops"],
              {s: round(v, 3) for s, v in by_span.items()}), flush=True)
    for kname, ms in out["top_kernels_ms"]:
        print("  info   %8.3f ms  %s" % (ms, kname[:110]))
    return out


def gmflow_conv_cases(k):
    """``conv3x3_seg`` against its plain version at each 3x3 stride-1 conv
    of a bf16 GMFlow request at 375x1242 (two items: both frames) that
    takes the kernel: the backbone's, without a bias or an activation (a
    norm follows), and the upsampler's, 130 -> 256 with a bias and ReLU.
    Yields (what, (ok, description))."""
    rng = np.random.RandomState(13)
    h, w = GMFLOW_GRID

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(DEV)

    cases = [(64, 64, 4, False, False), (96, 96, 2, False, False),
             (128, 128, 1, False, False), (130, 256, 1, True, k.seg.RELU)]
    for cin, cout, up, bias, relu in cases:
        x = rand(2, cin, up * h, up * w).bfloat16()
        wt = rand(cout, cin, 3, 3) / np.sqrt(9 * cin)
        b = rand(cout) * 0.1 if bias else None
        got = k.seg.conv3x3_seg_cuda(x, wt, b, 1, relu)
        ref = k.seg.conv3x3_seg_plain(x, wt, b, 1, relu).float()
        _, (ok, desc) = conv_agreement(got.float(), ref)
        yield ("%s, %d->%d at 2x%dx%d" % (
            "upsampler, bias and ReLU" if bias else "backbone, no bias",
            cin, cout, up * h, up * w), (ok, desc))


@contextlib.contextmanager
def gmflow_plain(k, conv: bool):
    """GMFlow's matching (and with ``conv`` ``conv3x3_seg``) on their plain
    versions."""
    swaps = [(k.gmflow, "global_match", k.gm.global_match_plain)]
    if conv:
        swaps.append((k.conv_ops, "conv3x3_seg", k.seg.conv3x3_seg_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        with k.entry.eager_entry():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kernels_line(rows, launches, one_rank, spatial, bench):
    """One entry per kernel and row; times are per forward at B=4,
    384x1280 on the SGU path (the bf16 rows on the bf16 SGU path): the sum
    over the kernel's calls in one forward (two directions per level);
    ``warp_window`` (row 5) is per call.  ``ms`` is CUDA-event time per
    call, ``device_ms`` the profiler's device time of the same calls.
    ``launches`` counts the run of that path (``path``);
    ``sharded_step_launches`` phase 9a's one-rank sharded step at that
    path's precision; ``width_cases`` the cases phase 10a held the row at
    on a rank's columns (the warp kernels at a column offset, the others
    on windows), and
    ``width_sharded_launches`` a forward's launches on rank 0 of phase
    10b at that path's precision (B=2 384x1280); ``bench_launches`` a
    chained forward's of the port's bench (bf16 rows) or one step's of
    its train lane (fp32 rows), phase 11a; ``sweep_cases`` the cases 11b
    held the kernel at (both precisions) at the sweep's batches that no
    earlier phase holds (B=8 and 16, 384x1280)."""
    out = []
    for name, shapes in rows.items():
        def total(key):
            if any(r[key] is None for r in shapes):
                return None
            return sum(r[key] * r["per_forward"] for r in shapes)
        lib = total("library_ms")
        by = ("bytes" if all(r["bound_by"] == "bytes" for r in shapes)
              else "operations")
        path = "sgu-bf16" if name in BF16_ROWS else "sgu"
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name][0],
            replaces=SOURCES[name][1], path=path,
            launches=launches[path][SERVED_BY.get(name, name)],
            sharded_step_launches=one_rank[
                "bf16" if path == "sgu-bf16" else "fp32"]["launches"][
                    SERVED_BY.get(name, name)],
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by=by, library_ms=lib, device_ms=total("device_ms"),
            library_device_ms=total("library_device_ms"), per_call=shapes))
        out[-1]["width_cases"] = spatial.get("10a", {}).get(name, 0)
        out[-1]["bench_launches"] = bench["11a"][
            "forward_launches" if path == "sgu-bf16"
            else "train_step_launches"][SERVED_BY.get(name, name)]
        out[-1]["sweep_cases"] = bench["sweep_held"]["shapes_held"].get(
            SERVED_BY.get(name, name), 0)
        sharded = spatial.get("10b", {}).get("%s b2_384x1280" % path)
        out[-1]["width_sharded_launches"] = (
            None if sharded is None
            else sharded["launches"][SERVED_BY.get(name, name)])
        if name in SERVED_BY:
            out[-1]["served_by"] = SERVED_BY[name]
    return {"kernels": out}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "upflow_pytorch_tpu_torch").is_dir() or not NPZ.exists():
        print("chip_smoke: run from a checkout of the repository (the "
              "package and assets/ are missing)", file=sys.stderr)
        return 2
    if argv[:1] == ["--parallel-rank"]:  # one rank of phase 9b
        return parallel_rank(int(argv[1]), argv[2], argv[3])
    if argv[:1] == ["--spatial-rank"]:  # one rank of phase 10b-d
        return spatial_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
    k = Port()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print("device: %s (torch %s, CUDA %s)" % (name, torch.__version__,
                                               torch.version.cuda))
    print("nvidia-smi: %s" % smi)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib = k.build.build()
    print("  built %s in %.1f s" % (lib.name, time.perf_counter() - t0))
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'|Used \d+ registers"
                      r".*|\d+ bytes spill.*", line)
        if m:
            print("  ptxas " + m.group(0))

    # the plain resizes are fp32 matrix products: TF32 would change them
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 matrix products run in full fp32 (allow_tf32 %s, precision "
          "%s)" % (torch.backends.cuda.matmul.allow_tf32,
                   torch.get_float32_matmul_precision()))
    if argv[:1] == ["--raft"]:  # phases 1 and 12 alone
        print("phase 12: RAFT", flush=True)
        print(json.dumps({"raft": phase_raft(k)}), flush=True)
        return finish(name)
    if argv[:1] == ["--gmflow"]:  # phases 1 and 13 alone
        print("phase 13: GMFlow", flush=True)
        print(json.dumps({"gmflow": phase_gmflow(k)}), flush=True)
        return finish(name)
    print("phase 2: kernels against their plain versions", flush=True)
    rows = phase_kernels(k)
    if argv[:1] == ["--kernels"]:  # phases 1 and 2 alone
        print(json.dumps({"conv3x3_seg": rows["conv3x3_seg"]}), flush=True)
        return finish(name)
    print("phase 3: serve requests", flush=True)
    launches, timing, models, pairs = {}, [], {}, {}
    for tag in PATHS:
        launches[tag], t, models[tag], pairs[tag] = phase_serve(
            k, tag, models["sgu"] if tag == "sgu-bf16" else None)
        timing += t
    phase_tf32_request(k, models["sgu"], pairs["sgu"])
    print("phase 4: profile one forward of each path", flush=True)
    kernels_per_forward = {tag: phase_profile(k, models[tag], pairs[tag], tag)
                           for tag in PATHS}
    # phases 5-11 count launches over whole evaluations, CLIs, runs and
    # steps, and the counters count at a graph's capture, not its replay:
    # the entry runs eagerly from here on
    with k.entry.eager_entry():
        print("phase 5: evaluate against ground truth", flush=True)
        phase_eval(k, models)
        del models, pairs
        print("phase 6: train", flush=True)
        train = phase_train(k)
        print("phase 7: the Trainer", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            trainer_c, pair, train["trainer"] = phase_trainer(
                k, Path(tmp), train["fp32"]["profiled_step"]["device_ms"])
            train["trainer"]["pth"] = phase_pth(k, trainer_c.model, pair,
                                                Path(tmp))
            del trainer_c
        train["trainer"]["learning"] = phase_learn(k)
        print("phase 8: KITTI and Sintel data, the native decoder, the CLIs",
              flush=True)
        t0 = time.perf_counter()
        print("phase 8a", flush=True)
        print(json.dumps({"phase_8a": phase_shapes(k)}), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            root, pth = phase_data(k, Path(tmp))
            print("  info phase 8 took %.1f s" % (time.perf_counter() - t0))
            print("phase 9: data parallelism on the card", flush=True)
            t0 = time.perf_counter()
            parallel = phase_parallel(k, root, Path(tmp), pth, train)
            print("  info phase 9 took %.1f s" % (time.perf_counter() - t0))
            print("phase 10: width sharding on the card", flush=True)
            spatial = phase_spatial(k, Path(tmp))
        print("phase 11: the port's bench and its batch sweep", flush=True)
        bench = phase_bench(k)
    print("phase 12: RAFT", flush=True)
    raft = phase_raft(k)
    print("phase 13: GMFlow", flush=True)
    gmflow = phase_gmflow(k)

    print(json.dumps({"forward_ms": timing,
                      "device_kernels_per_forward": kernels_per_forward}))
    print(json.dumps({"train": train}))
    print(json.dumps({"raft": raft}))
    print(json.dumps({"gmflow": gmflow}))
    print(json.dumps(kernels_line(rows, launches, parallel["9a"], spatial,
                                  bench)))
    print(smi)
    return finish(name)


def finish(name: str) -> int:
    if failures:
        print("chip_smoke: %d check(s) failed:\n  %s"
              % (len(failures), "\n  ".join(failures)), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
