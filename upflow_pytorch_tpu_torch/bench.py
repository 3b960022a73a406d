"""The port's headline bench: bidirectional pairs/s of the eval recipe at
bf16 on one GPU, timed as a chained loop, beside its flow quality and the
fp32 training rate.

    python -m upflow_pytorch_tpu_torch.bench [--device cpu] [--batch N]
        [--size HxW] [--iters N] [--train-iters N] [--no-train]

Port of the JAX package's root ``bench.py``: the port measured the way
that script measures the JAX package, with its defaults (B=4 384x1280,
20 forwards a timed run, the median of 3 timed runs after a warm-up
run).  It runs on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` it raises, as ``build_model`` does.  It prints
ONE JSON line.

Method.  One timed run enqueues ``iters`` forwards of ``UPFlowNet`` back
to back (NCHW, under ``torch.no_grad()`` and ``fp32_numerics``: the
network without the occlusion check, as the JAX bench applies it) with
no host sync between them, and stops the clock at one ``.item()``.  Each
forward reads ``im1 + salt * 1e-9 + acc * 1e-12``, where ``acc`` is the
device-side running sum of ``flow_f.sum() + flow_b.sum()``: every forward
depends on the one before, and nothing is cached.  Beside the network a
forward launches one elementwise kernel (the perturbed input) and the
reduction into ``acc`` (two sums, two adds).  The host enqueues every
launch, and that host time is the port's, so the number includes it (no
CUDA graph).  The no-op loop (``iters`` dependent scalar adds on the
device, one ``.item()``) is timed the same way and subtracted, floored at
1e-9 s.

Weights: ``assets/synthetic_trained.npz`` when it exists ("weights":
"synthetic_trained"), else the seeded init with the SGU head's
``conv_last`` weight times 0.02 ("kaiming+sgu_scale"), the JAX bench's
surrogate for the trained regime.

The JAX bench's fields and the port's counterparts:

- ``metric``, ``value``, ``vs_baseline``: the same, at bf16 with every
  kernel (``compute_dtype="bfloat16"``, ``if_use_cor_pytorch=False``);
  ``value`` / 25.0, the JAX bench's V100 estimate.
- ``unit``: "pairs/sec/gpu" ("pairs/sec/cpu" with ``--device cpu``).
- ``sgu_fallback_pairs_per_sec``: the JAX bench pins its exact-XLA SGU
  tier.  The port has no tier: one ``sgu_final`` kernel serves every
  flow magnitude, and a tap beyond its 40-px halo (``csrc/sgu_final.cu``
  ``kHalo``) takes the slow path.  So the same loop is timed with the SGU
  head's ``conv_last`` weight scaled by the least power of two that puts
  the final stage's median inter-flow beyond the halo;
  ``sgu_fallback_head_scale`` is that scale and
  ``sgu_fallback_median_inter_flow_px`` that median (over pixels and both
  directions, of max(|u|, |v|) in px at full resolution).
- ``degraded``: dropped.  The port has no degradation guard: a kernel
  that fails to build or launch raises.
- ``loop_dispatch_overhead_s``, ``weights``: the same.
- ``epe_vs_gt_bf16_px``, ``epe_vs_gt_fp32_px``,
  ``bf16_vs_fp32_mean_epe_px``, ``bf16_vs_fp32_frac_gt_1px``,
  ``bf16_vs_fp32_max_epe_px``: the same expressions (``accuracy_fields``)
  on the pairs of ``make_dataset(batch, seed=7)`` (rendered on threads by
  ``render_pairs``, the same arrays), the fp32 flow from the
  unfused route (``if_use_cor_pytorch=True``), the JAX bench's oracle.
- ``fused_on_off_fp32_mean_epe_px``, ``chaos_floor_fp32_mean_epe_px``:
  the same (``ab_fields``) at fp32 with ``if_use_cor_pytorch=False``: the
  flow through the ``feature_warp`` kernel against the flow through its
  plain version on the same device (``plain_feature_warp``), and against
  the flow for ``im1 * (1 + 1e-7)``.
- ``train_pairs_per_sec_fp32_256x832``: the JAX bench's recipe
  (photometric + census 1.0, 'upup' distillation 0.01 with occlusion,
  SGU, boundary-dilated warp, fp32) on ``make_dataset(batch, seed=11)``
  256x832 crops of 320x896, ``train_iters`` steps of ``make_train_step``
  back to back, one sync at the end, the median of 3 runs after a warm-up
  run; "skipped" with ``--no-train``.  The weights are the port's seeded
  init (``create_train_state`` with ``TrainerConfig()``), whose values are
  not the JAX package's ``PRNGKey(0)`` init: only the time compares.
  Each run goes on from the state the last one left.
- Added: ``device`` and ``power_limit`` (``nvidia-smi``'s name and power
  limit; "cpu" and null on the CPU), ``batch``, ``hw``, ``iters`` and
  ``train_iters``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (
    Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple)

import numpy as np
import torch

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.synthetic import make_pair
from upflow_pytorch_tpu_torch.models.entry import build_model
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw
from upflow_pytorch_tpu_torch.ops.resize import fp32_numerics
from upflow_pytorch_tpu_torch.train.step import (
    create_train_state, make_train_step)
from upflow_pytorch_tpu_torch.utils.misc import as_nchw, resolve_device

BASELINE_V100_PAIRS_PER_SEC = 25.0

BATCH = 4
HEIGHT, WIDTH = 384, 1280
ITERS = 20
TIMED_RUNS = 3
TRAIN_ITERS = 8
TRAIN_CROP_HW, TRAIN_RAW_HW = (256, 832), (320, 896)
SGU_HALO_PX = 40  # csrc/sgu_final.cu kHalo
SURROGATE_SGU_SCALE = 0.02
BORDER = 8  # px cropped from each side for the interior EPE

BENCH_CKPT = str(Path(__file__).resolve().parents[1] / "assets"
                 / "synthetic_trained.npz")

_EVAL = dict(if_norm_before_cost_volume=True,
             norm_moments_across_channels=False,
             norm_moments_across_images=False, if_sgu_upsample=True)
# the headline path (bf16, every kernel), the fp32 oracle (the unfused
# cost volume), the fused fp32 path of the A/B, and the train lane
CONF = UPFlowConfig().updated(dict(_EVAL, compute_dtype="bfloat16",
                                   if_use_cor_pytorch=False))
CONF_FP32 = UPFlowConfig().updated(dict(_EVAL, if_use_cor_pytorch=True))
CONF_AB = UPFlowConfig().updated(dict(_EVAL, if_use_cor_pytorch=False))
TRAIN_CONF = UPFlowConfig().updated(dict(
    _EVAL, if_use_cor_pytorch=False, photo_loss_census_weight=1.0,
    multi_scale_distillation_weight=0.01,
    multi_scale_distillation_style="upup",
    multi_scale_distillation_occ=True, if_use_boundary_warp=True))

Run = Callable[[float], float]


def load_model(conf: UPFlowConfig, device) -> Tuple[UPFlowNet, bool]:
    """(model, used_ckpt): the network on ``device`` from ``BENCH_CKPT``
    when it exists, else from the seeded init with the SGU head's
    ``conv_last`` weight times ``SURROGATE_SGU_SCALE``."""
    used_ckpt = os.path.exists(BENCH_CKPT)
    model = build_model(conf, device,
                        weights=BENCH_CKPT if used_ckpt else None)
    if not used_ckpt:
        with torch.no_grad():
            sgu_head_weight(model).mul_(SURROGATE_SGU_SCALE)
    return model, used_ckpt


def sgu_head_weight(model: UPFlowNet) -> torch.Tensor:
    """The SGU estimator's ``conv_last`` weight (inter-flow and mask
    logit), the JAX package's ``sgu_dense_estimator/dense/conv_last``."""
    return model.sgi_model.dense_estimator_mask.conv_last[0].weight


def render_pairs(n_pairs: int, seed: int, hw: Tuple[int, int],
                 raw_hw: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, np.ndarray]:
    """The arrays of ``make_dataset(n_pairs, seed, raw_hw=raw_hw or hw,
    crop_hw=hw)``, the pairs rendered on threads (numpy's loops release
    the GIL; a 384x1280 pair takes seconds alone), each from its own seed
    ``seed * 1000 + i`` as there, so the arrays are the same."""
    def pair(i: int) -> Dict[str, np.ndarray]:
        return make_pair(seed * 1000 + i, raw_hw=raw_hw or hw, crop_hw=hw)

    with ThreadPoolExecutor(min(n_pairs, os.cpu_count() or 1)) as pool:
        items = list(pool.map(pair, range(n_pairs)))
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def chain_input(base: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The chained forward's first image: one elementwise kernel."""
    return torch.add(base, acc, alpha=1e-12)


def accumulate(acc: torch.Tensor, flow_f: torch.Tensor,
               flow_b: torch.Tensor) -> torch.Tensor:
    return acc + flow_f.sum() + flow_b.sum()


def chained_loop(model: UPFlowNet, im1: torch.Tensor, im2: torch.Tensor,
                 iters: int = ITERS) -> Run:
    """``run(salt)``: ``iters`` dependent forwards of ``model`` on NCHW
    ``im1``, ``im2`` enqueued back to back, one ``.item()`` at the end."""
    def run(salt: float) -> float:
        acc = im1.new_zeros(())
        base = im1 + salt * 1e-9
        with torch.no_grad(), fp32_numerics():
            for _ in range(iters):
                flow_f, flow_b, _ = model(chain_input(base, acc), im2)
                acc = accumulate(acc, flow_f, flow_b)
        return acc.item()
    return run


def noop_loop(device, iters: int = ITERS) -> Run:
    """``run(salt)``: ``iters`` dependent scalar adds on ``device``, one
    ``.item()`` at the end: the loop's launch and sync cost without the
    forwards."""
    def run(salt: float) -> float:
        acc = torch.zeros((), device=device)
        step = torch.full((), salt * 1e-9, device=device)
        for _ in range(iters):
            acc = acc + step
        return acc.item()
    return run


def timed_runs(run: Run, clock: Callable[[], float] = time.perf_counter
               ) -> Tuple[float, List[float]]:
    """The wall, in seconds, of a first (warm-up) call of ``run`` and of
    ``TIMED_RUNS`` timed calls, each with its own salt."""
    walls = []
    for i in range(1 + TIMED_RUNS):
        t0 = clock()
        run(1.0 + i)
        walls.append(clock() - t0)
    return walls[0], walls[1:]


def net_seconds(times: Sequence[float], overhead: float = 0.0) -> float:
    """The median of ``times`` less ``overhead``, floored at 1e-9."""
    return max(sorted(times)[len(times) // 2] - overhead, 1e-9)


def _measure(run: Run, overhead: float = 0.0,
             clock: Callable[[], float] = time.perf_counter) -> float:
    """Median seconds of ``TIMED_RUNS`` calls of ``run`` after a warm-up
    call, less ``overhead``, floored at 1e-9."""
    return net_seconds(timed_runs(run, clock)[1], overhead)


def _dispatch_overhead(device, iters: int = ITERS) -> float:
    """Seconds of one no-op loop (``noop_loop``), measured as the chained
    loop is."""
    return _measure(noop_loop(device, iters))


def forward_flow(model: UPFlowNet, im1: torch.Tensor,
                 im2: torch.Tensor) -> torch.Tensor:
    """The forward flow (B, 2, H, W), fp32, of one inference forward."""
    with torch.no_grad(), fp32_numerics():
        return model(im1, im2)[0].float()


def final_inter_flow_px(model: UPFlowNet, im1: torch.Tensor,
                        im2: torch.Tensor) -> float:
    """The median, over pixels and both directions, of max(|u|, |v|) of
    the final SGU stage's inter-flow, in px at full resolution (the head
    output rate-scaled as ``sgu_final`` scales it)."""
    heads = []
    hook = model.sgi_model.dense_estimator_mask.register_forward_hook(
        lambda mod, args, out: heads.append(out[1]))
    try:
        forward_flow(model, im1, im2)
    finally:
        hook.remove()
    x = torch.cat(heads[-2:])[:, :2].float()
    su, sv = im1.shape[3] / x.shape[3], im1.shape[2] / x.shape[2]
    return float(torch.maximum(x[:, 0].abs() * su,
                               x[:, 1].abs() * sv).median())


def scale_beyond_halo(model: UPFlowNet, im1: torch.Tensor,
                      im2: torch.Tensor) -> Tuple[float, float]:
    """Scales ``model``'s SGU head weight in place by the least power of
    two that puts ``final_inter_flow_px`` beyond ``SGU_HALO_PX``;
    returns (scale, median)."""
    weight = sgu_head_weight(model)
    scale, median = 1.0, final_inter_flow_px(model, im1, im2)
    for _ in range(32):
        if median > SGU_HALO_PX:
            return scale, median
        with torch.no_grad():
            weight.mul_(2.0)
        scale *= 2.0
        median = final_inter_flow_px(model, im1, im2)
    raise RuntimeError("the SGU head at scale %g leaves the final stage's "
                       "median inter-flow at %.3f px, inside the %d-px halo"
                       % (scale, median, SGU_HALO_PX))


def accuracy_fields(f16: torch.Tensor, f32: torch.Tensor,
                    gt: torch.Tensor) -> Dict[str, float]:
    """The JAX bench's ``flows_pair`` on NCHW flows: the bf16 flow against
    the fp32 flow, and each against the ground truth on the interior."""
    d = torch.linalg.vector_norm(f16 - f32, dim=1)
    e16 = torch.linalg.vector_norm(f16 - gt, dim=1)
    e32 = torch.linalg.vector_norm(f32 - gt, dim=1)
    interior = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    return {"epe_vs_gt_bf16_px": float(e16[interior].mean()),
            "epe_vs_gt_fp32_px": float(e32[interior].mean()),
            "bf16_vs_fp32_mean_epe_px": float(d.mean()),
            "bf16_vs_fp32_frac_gt_1px": float((d > 1.0).float().mean()),
            "bf16_vs_fp32_max_epe_px": float(d.max())}


def ab_fields(on: torch.Tensor, off: torch.Tensor,
              perturbed: torch.Tensor) -> Dict[str, float]:
    """The fused A/B and the chaos floor on NCHW flows: the mean EPE of
    the kernel path's flow against the plain feature warp's, and against
    its own flow for a 1-ulp input perturbation."""
    return {"fused_on_off_fp32_mean_epe_px": float(
                torch.linalg.vector_norm(on - off, dim=1).mean()),
            "chaos_floor_fp32_mean_epe_px": float(
                torch.linalg.vector_norm(on - perturbed, dim=1).mean())}


@contextlib.contextmanager
def plain_feature_warp() -> Iterator[None]:
    """The model's feature warps through ``feature_warp``'s plain version
    on any device for the block (the A/B's off side); the kernel stays
    untouched."""
    saved = kfw.feature_warp
    kfw.feature_warp = kfw.feature_warp_plain
    try:
        yield
    finally:
        kfw.feature_warp = saved


def bench_train_step(device, batch: int = BATCH,
                     iters: int = TRAIN_ITERS) -> float:
    """Training pairs/s of ``TRAIN_CONF`` at fp32: ``iters`` steps of
    ``make_train_step`` back to back a run, one sync at the end, the
    median of ``TIMED_RUNS`` runs after a warm-up run."""
    model, state, optimizer = create_train_state(TRAIN_CONF, TrainerConfig(),
                                                 device=device)
    step_fn = make_train_step(model, optimizer)
    data = render_pairs(batch, 11, TRAIN_CROP_HW, TRAIN_RAW_HW)
    tensors = {k: torch.from_numpy(v).to(device) for k, v in data.items()
               if k != "gt_flow"}
    weight = model.flow_estimators.conv_last[0].weight

    def run(salt: float) -> float:
        nonlocal state
        for _ in range(iters):
            state, _ = step_fn(state, tensors)
        return weight.sum().item()

    return batch * iters / _measure(run)


def card(device: torch.device) -> Tuple[str, Optional[str]]:
    """(name, power limit) of the card as ``nvidia-smi`` gives them, or
    ("cpu", None)."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = out.strip().splitlines()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name, limit = (s.strip() for s in lines[index].split(","))
    return name, limit


def run_bench(device=None, batch: int = BATCH, hw=(HEIGHT, WIDTH),
          iters: int = ITERS, train_iters: int = TRAIN_ITERS,
          train: bool = True) -> Dict[str, Any]:
    """Every lane of the bench on ``device`` (the card unless ``"cpu"``
    is asked for); returns the JSON line's object."""
    device = resolve_device(device)
    h, w = hw
    model, used_ckpt = load_model(CONF, device)
    data = render_pairs(batch, 7, (h, w))
    im1, im2, gt = (as_nchw(data[k], device)
                    for k in ("im1", "im2", "gt_flow"))

    overhead = _dispatch_overhead(device, iters)
    dt_in = _measure(chained_loop(model, im1, im2, iters), overhead)
    model_out, _ = load_model(CONF, device)
    scale, median = scale_beyond_halo(model_out, im1, im2)
    dt_out = _measure(chained_loop(model_out, im1, im2, iters), overhead)
    del model_out

    model_fp32, _ = load_model(CONF_FP32, device)
    fields = accuracy_fields(forward_flow(model, im1, im2),
                             forward_flow(model_fp32, im1, im2), gt)
    del model_fp32
    model_ab, _ = load_model(CONF_AB, device)
    on = forward_flow(model_ab, im1, im2)
    perturbed = forward_flow(model_ab, im1 * (1 + 1e-7), im2)
    with plain_feature_warp():
        off = forward_flow(model_ab, im1, im2)
    fields.update(ab_fields(on, off, perturbed))
    del model_ab

    train_pps: Any = "skipped"
    if train:
        train_pps = bench_train_step(device, batch, train_iters)
    pairs_per_sec = batch * iters / dt_in
    name, power_limit = card(device)
    return dict(
        metric="kitti2015_inference_throughput_%dx%d_bf16_bidir" % (h, w),
        value=pairs_per_sec,
        unit="pairs/sec/%s" % ("gpu" if device.type == "cuda" else "cpu"),
        vs_baseline=pairs_per_sec / BASELINE_V100_PAIRS_PER_SEC,
        sgu_fallback_pairs_per_sec=batch * iters / dt_out,
        sgu_fallback_head_scale=scale,
        sgu_fallback_median_inter_flow_px=median,
        loop_dispatch_overhead_s=overhead,
        weights="synthetic_trained" if used_ckpt else "kaiming+sgu_scale",
        **fields,
        train_pairs_per_sec_fp32_256x832=train_pps,
        device=name, power_limit=power_limit, batch=batch, hw=[h, w],
        iters=iters, train_iters=train_iters)


def parse_hw(text: str) -> Tuple[int, int]:
    h, _, w = text.lower().partition("x")
    return int(h), int(w)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--size", type=parse_hw, default=(HEIGHT, WIDTH),
                    metavar="HxW")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="forwards a timed run")
    ap.add_argument("--train-iters", type=int, default=TRAIN_ITERS,
                    help="training steps a timed run")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the train lane")
    args = ap.parse_args(argv)
    result = run_bench(args.device, args.batch, args.size, args.iters,
                   args.train_iters, not args.no_train)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
