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
   ``conv3x3_seg`` at every distinct conv shape of a bf16 forward (and two
   ragged shapes of 375x1242), the correlations and the feature warp at
   bf16 inputs.  The plain correlation is held at every decode level of
   both request sizes (B=4 384x1280, B=1 375x1242), must give the same
   bits on a second call, and prints its grid and its device ms beside
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
   staging route (TMA or cp.async), device ms, cuDNN's device ms, its
   bound and the host's share of a call (CUDA-event time beyond device
   time); the image warp prints the same beside ``grid_sample``.  The SGU
   blend runs both directions of a level in one launch from raw heads
   (fp32 and bf16) at decode levels 1-4 of both sizes and three
   inter-flow magnitudes, bit for bit against its plain version, and
   prints device ms, bound and wrapper-inclusive ms per level and per
   forward.
3. Serve requests through ``build_model`` / ``forward`` with the
   checkpoint ``assets/synthetic_trained.npz``, on three paths: the eval
   recipe without SGU (slice 1), with SGU (the served configuration), and
   with SGU at bf16.  For each path: count the kernel launches of each
   forward (``conv3x3_seg`` by staging route, and its weight packs: none
   after a model's first forward), then hold the kernel path against the
   plain path on the card and time both.  Then one SGU request under
   ``torch.set_float32_matmul_precision("high")`` keeps the SGU bars, and
   the caller's setting reads the same afterwards.
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
   at fp32 (one warm-up step and 5 timed) and bf16 (one and 3).  Every
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

The line before the last is the card's name and power limit; the line
before that holds the kernels' numbers as JSON, and the one before that
the training step's.  The last line,
``{"ok": true, "device": ...}``, is printed only when every check passed;
any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
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


def conv_shapes():
    """Every conv3x3_seg call of one bf16 SGU forward at B=4, 384x1280, and
    two ragged ones of 375x1242 (B=1): (what, b, h, w, cin, cout,
    dilation, relu, calls per forward, buffer).  ``buffer`` is
    (channels, start) of the dense buffer whose range [start, start + cin)
    is the conv's input and [start - cout, start) its output slot, or None
    for a standalone tensor."""
    out = []

    def stack(tag, b, h, w, feat, fs, head, per_forward, extra):
        start = sum(fs)  # the input fills [start, feat)
        for i, f in enumerate(fs):
            out.append(("%s conv%d" % (tag, i + 1), b, h, w, feat - start, f,
                        1, True, per_forward, (feat + extra, start)))
            start -= f
        out.append(("%s head" % tag, b, h, w, feat, head, 1, False,
                    per_forward, (feat + extra, 0)))

    levels = pyramid_hw(MAIN_H, MAIN_W)
    for level in (3, 4):
        h, w = levels[level]
        tag = "L%d" % level
        stack("estimator " + tag, MAIN_B, h, w, 563, (128, 128, 96, 64, 32),
              2, 2, 2)
        cin = 565
        for i, (f, d) in enumerate(zip((128, 128, 128, 96, 64, 32),
                                       (1, 2, 4, 8, 16, 1))):
            out.append(("context %s conv%d" % (tag, i), MAIN_B, h, w, cin, f,
                        d, True, 2, (565, 0) if i == 0 else None))
            cin = f
        # the SGU estimator runs at level 3, and at 96 x 320 for level 4
        # and for the final stage
        stack("sgu " + tag, MAIN_B, h, w, 184, (32, 32, 32, 16, 8), 3,
              2 if level == 3 else 4, 0)
    h, w = levels[3]
    out.append(("pyramid level2_conv1", MAIN_B, h, w, 64, 64, 1, True, 2,
                None))
    h, w = pyramid_hw(375, 1242)[4]
    out.append(("ragged estimator conv1", 1, h, w, 115, 128, 1, True, 0,
                (565, 448)))
    out.append(("ragged context conv4", 1, h, w, 96, 64, 16, True, 0, None))
    return out


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
    # and writing channel ranges of a dense buffer where the model does.
    # Bar: within 1 bf16 ulp of the plain value, or, where |plain| < 1e-3
    # of max|plain| (sums that cancel), within 1e-5 of max|plain|.
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
        want = "cp.async" if what.startswith("ragged") else "tma"
        before = dict(k.seg.conv3x3_seg.route_launches)
        got = k.seg.conv3x3_seg(x, weight, bias, d, relu, out=out).float()
        ran = {r: n - before[r]
               for r, n in k.seg.conv3x3_seg.route_launches.items()}
        other = "tma" if want == "cp.async" else "cp.async"
        check(route == want and ran == {want: 1, other: 0},
              "conv3x3_seg %s staged by the %s route (launches %s)"
              % (what, route, ran))
        ref = k.seg.conv3x3_seg_plain(x, weight, bias, d, relu).float()
        scale = ref.abs().max().item()
        diff = (got - ref).abs()
        mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
        ulps = diff / torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok = (ulps <= 1.0) | ((ref.abs() < 1e-3 * scale)
                              & (diff <= 1e-5 * scale))
        big = ref.abs() >= 1e-3 * scale
        check(bool(ok.all()) and bool(torch.isfinite(got).all()),
              "conv3x3_seg %s (%d, %d->%d, %dx%d, d=%d): %.2e of values "
              "differ from the plain version, max %.2f bf16 ulp where "
              "|plain| >= 1e-3 max, %d outside the bar"
              % (what, b, cin, cout, h, w, d,
                 (diff > 0).float().mean().item(),
                 ulps[big].max().item(), int((~ok).sum().item())))
        wb, bb = weight.bfloat16(), bias.bfloat16()
        px = b * h * w
        # timed as the model calls it (weights packed once), and packing
        # on every call
        packed = k.seg.packed_params(torch.nn.Module(), weight, bias)
        row = record(
            "conv3x3_seg", [b, cin, h, w, cout, d], diff.max().item(),
            lambda: k.seg.conv3x3_seg(x, weight, bias, d, relu, out=out,
                                      packed=packed),
            lambda: k.seg.conv3x3_seg_plain(x, weight, bias, d, relu),
            2 * px * (cin + cout) + 2 * 9 * cin * cout + 4 * cout,
            2 * 9 * px * cin * cout, per_forward=per_forward,
            library=lambda: F.conv2d(x, wb, bb, padding=d, dilation=d),
            ops_per_s=BF16_OPS_PER_S, reps=11, inner=5, route=route,
            pack_per_call_ms=time_ms(
                lambda: k.seg.conv3x3_seg(x, weight, bias, d, relu,
                                          out=out), 11, 5))
        print("  info conv3x3_seg %s: route %s, device ms %s, cuDNN device "
              "ms %s, bound %.4f; events %.4f ms prepacked, %.4f packing "
              "per call, host %s ms"
              % (what, route, fmt(row["device_ms"]),
                 fmt(row["library_device_ms"]), row["bound_ms"], row["ms"],
                 row["pack_per_call_ms"], fmt(row["host_ms"])))
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
    model = k.upflow.build_model(conf, weights=str(NPZ))
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
    routes.update({"tma": 0, "cp.async": 0})
    cn_routes.update({"vec": 0, "word": 0})
    for i, ((b, h, w, seed), (im1, im2)) in enumerate(zip(requests, pairs)):
        before = {n: fn.launches for n, fn in k.dispatch.items()}
        routes_before = dict(routes)
        cn_before = dict(cn_routes)
        packs_before = k.seg.pack_weight.calls
        out = k.upflow.forward(model, im1, im2)
        torch.cuda.synchronize()
        delta = {n: fn.launches - before[n] for n, fn in k.dispatch.items()}
        what = "%s request %dx%dx%d" % (tag, b, h, w)
        check(delta == per_forward, "%s: launches %s" % (what, delta))
        # conv3x3_seg: TMA staging on the aligned 384x1280 pyramid,
        # cp.async copies on 375x1242's; weights packed at the model's
        # first call only
        convs = per_forward["conv3x3_seg"]
        aligned = h % 64 == 0 and w % 64 == 0
        ran = {r: n - routes_before[r] for r, n in routes.items()}
        packs = k.seg.pack_weight.calls - packs_before
        check(ran == {"tma": convs if aligned else 0,
                      "cp.async": 0 if aligned else convs},
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
            fast = k.upflow.forward(model, im1, im2)
            if hook is not None:
                hook.remove()
                print("  info %s: max |inter-flow| (u, v) px per SGU stage, "
                      "levels 1-4 then final (rate-scaled): %s"
                      % (what, sgu_extrema(heads, (h, w))))
            before = {n: fn.launches for n, fn in k.dispatch.items()}
            with plain_path(k):
                plain = k.upflow.forward(model, im1, im2)
            torch.cuda.synchronize()
            check(all(fn.launches == before[n]
                      for n, fn in k.dispatch.items()),
                  "%s: the plain path launched no kernel" % what)
            if knobs.get("compute_dtype") == "bfloat16":
                with plain_path(k), library_route(k):
                    lib = k.upflow.forward(model, im1, im2)
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
                    fast, k.upflow.forward(ref_model, im1, im2))
                print("  info %s: against the fp32 SGU kernel path, flow "
                      "|diff| mean %.3e px, p99.9 %.3e px" % (what, mean,
                                                              p999))
            fast_ms = wall_ms(lambda: k.upflow.forward(model, im1, im2))
            with plain_path(k):
                plain_ms = wall_ms(lambda: k.upflow.forward(model, im1, im2))
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
        exact = k.upflow.forward(model, im1, im2)
        with plain_path(k):
            plain = k.upflow.forward(model, im1, im2)
        torch.set_float32_matmul_precision("high")
        try:
            fast = k.upflow.forward(model, im1, im2)
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
    k.upflow.forward(model, im1, im2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k.upflow.forward(model, im1, im2)
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
    model = k.upflow.build_model(conf, weights=str(NPZ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = k.upflow.forward_with_loss(model, batch)
    torch.cuda.synchronize()
    forward_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with k.upflow.fp32_numerics():
        out["total_loss"].backward()
    torch.cuda.synchronize()
    return ({n: p.grad for n, p in model.named_parameters()},
            {key: float(out[key].detach()) for key in k.step.METRICS},
            (forward_peak, torch.cuda.max_memory_allocated() / 2 ** 30))


@contextlib.contextmanager
def backward_ranges(k):
    """Wraps each kernel op's backward rule in a profiler range
    ``upflow_bwd::<op>``, so a profile attributes its device time."""
    saved = {name: fn.backward for name, fn in k.functions.items()}

    def ranged(name, backward):
        def run(ctx, *grads):
            with torch.profiler.record_function("upflow_bwd::" + name):
                return backward(ctx, *grads)
        return staticmethod(run)

    for name, fn in k.functions.items():
        fn.backward = ranged(name, saved[name])
    try:
        yield
    finally:
        for name, fn in k.functions.items():
            fn.backward = staticmethod(saved[name])


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


def profile_train_step(k, step_fn, state, batch, tag):
    """One training step under torch.profiler: device time split by kind
    and by backward rule.  Every device kernel counts by its name
    (``kernel_kind``), except those that the profiler links to a host op
    inside a backward rule's range (``backward_ranges``) or the
    optimizer's step, which count there.  Returns (state, split, rules,
    busy ms, wall ms); the split and rules are None when the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with backward_ranges(k), profile(
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
        # the profiler mirrors each host range on the device's timeline
        # as a user annotation: a span, not a kernel
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(("upflow_bwd::", "Optimizer."))):
            us = e.time_range.elapsed_us()
            kinds[kernel_kind(e.name)] += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        scope, parent = None, e
        while parent is not None and scope is None:
            if parent.name.startswith("upflow_bwd::"):
                scope = parent.name[len("upflow_bwd::"):]
            elif parent.name.startswith("Optimizer.step"):
                scope = "optimizer"
            parent = parent.cpu_parent
        if scope is None:
            continue
        for kern in e.kernels:
            kinds[kernel_kind(kern.name)] -= kern.duration
            if scope == "optimizer":
                kinds["optimizer"] += kern.duration
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


class Port:
    """The port's modules, imported once the card is known to be there."""

    def __init__(self):
        sys.path.insert(0, str(ROOT))
        from upflow_pytorch_tpu_torch import _build
        from upflow_pytorch_tpu_torch.config import UPFlowConfig
        from upflow_pytorch_tpu_torch.data import synthetic
        from upflow_pytorch_tpu_torch.eval import bench
        from upflow_pytorch_tpu_torch.models import upflow
        from upflow_pytorch_tpu_torch.ops import conv as conv_ops
        from upflow_pytorch_tpu_torch.ops import warp as warp_ops
        from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg
        from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as cn
        from upflow_pytorch_tpu_torch.ops.kernels import correlation as corr
        from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as fw
        from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as sb
        from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as sf
        from upflow_pytorch_tpu_torch.ops.kernels import warp
        from upflow_pytorch_tpu_torch.train import step, trainer
        from upflow_pytorch_tpu_torch.config import TrainerConfig

        self.build, self.UPFlowConfig = _build, UPFlowConfig
        self.step, self.TrainerConfig = step, TrainerConfig
        self.upflow = upflow
        self.warp_ops, self.cn, self.corr, self.fw, self.warp = (
            warp_ops, cn, corr, fw, warp)
        self.sb, self.sf, self.conv_ops, self.seg = sb, sf, conv_ops, seg
        self.synthetic, self.bench, self.trainer = synthetic, bench, trainer
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


def kernels_line(rows, launches):
    """One entry per kernel and row; times are per forward at B=4,
    384x1280 on the SGU path (the bf16 rows on the bf16 SGU path): the sum
    over the kernel's calls in one forward (two directions per level);
    ``warp_window`` (row 5) is per call.  ``ms`` is CUDA-event time per
    call, ``device_ms`` the profiler's device time of the same calls.
    ``launches`` counts the run of that path (``path``)."""
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
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by=by, library_ms=lib, device_ms=total("device_ms"),
            library_device_ms=total("library_device_ms"), per_call=shapes))
        if name in SERVED_BY:
            out[-1]["served_by"] = SERVED_BY[name]
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "upflow_pytorch_tpu_torch").is_dir() or not NPZ.exists():
        print("chip_smoke: run from a checkout of the repository (the "
              "package and assets/ are missing)", file=sys.stderr)
        return 2
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
    print("phase 2: kernels against their plain versions", flush=True)
    rows = phase_kernels(k)
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
    print("phase 5: evaluate against ground truth", flush=True)
    phase_eval(k, models)
    del models, pairs
    print("phase 6: train", flush=True)
    train = phase_train(k)

    print(json.dumps({"forward_ms": timing,
                      "device_kernels_per_forward": kernels_per_forward}))
    print(json.dumps({"train": train}))
    print(json.dumps(kernels_line(rows, launches)))
    print(smi)
    if failures:
        print("chip_smoke: %d check(s) failed:\n  %s"
              % (len(failures), "\n  ".join(failures)), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
