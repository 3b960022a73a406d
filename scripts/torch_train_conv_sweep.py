#!/usr/bin/env python3
"""The PyTorch port's training step on one GPU: where the convolutions'
backward time goes, and what cuDNN's algorithm choice costs.

    python3 scripts/torch_train_conv_sweep.py

1. At every ``conv3x3_seg`` shape of the bf16 training step (B=4,
   256x832, ``chip_smoke.py::conv_shapes`` at that size), CUDA-event ms
   of the backward rule's parts: the bf16 data gradient (cuDNN), the fp32
   weight gradient by cuDNN with its heuristic algorithm and with
   ``cudnn.benchmark`` (TF32 off in both), and the weight gradient as one
   bf16 GEMM with fp32 sums over the unfolded input
   (``torch.bmm(..., out_dtype=torch.float32)``), each held against the
   first weight gradient; and the whole rule
   (``conv3x3_seg_vjp``).  Sums over one step's calls.  All of it under
   ``train/step.py::deterministic_numerics``, as the step runs them.
2. The training step of ``chip_smoke.py`` phase 6, fp32 and bf16, with
   ``cudnn.benchmark`` off and on in turns (off, on, on, off): median
   step ms of 3 steps after 2 warm-up steps, and the peak memory.
"""

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dw_gemm(x, wshape, gb, d):
    """The weight gradient as one bf16 GEMM per batch item with fp32 sums
    over the unfolded input, summed over the batch in fp32."""
    b, _, h, w = x.shape
    cols = F.unfold(x, 3, dilation=d, padding=d)
    out = torch.bmm(gb.reshape(b, gb.shape[1], h * w), cols.transpose(1, 2),
                    out_dtype=torch.float32)
    return out.sum(0).reshape(wshape)


def conv_sweep(k):
    cudnn = torch.backends.cudnn
    totals = dict(dx=0.0, dw_heuristic=0.0, dw_benchmark=0.0, dw_gemm=0.0,
                  rule=0.0)
    cs.MAIN_H, cs.MAIN_W = 256, 832
    for (what, b, h, w, cin, cout, d, relu, per_step, _) in cs.conv_shapes():
        if per_step == 0:
            continue
        g = torch.Generator(device="cuda").manual_seed(cin + cout + d)
        x = torch.randn(b, cin, h, w, device="cuda", generator=g).bfloat16()
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=g) * 0.05
        gb = torch.randn(b, cout, h, w, device="cuda", generator=g
                         ).bfloat16()
        out = torch.randn(b, cout, h, w, device="cuda", generator=g
                          ).bfloat16()
        wb = wt.bfloat16()

        def dw():
            return torch.nn.grad.conv2d_weight(
                x.float(), wt.shape, gb.float(), padding=d, dilation=d)

        row = {}
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                         allow_tf32=False):
            row["dx"] = event_ms(lambda: torch.nn.grad.conv2d_input(
                x.shape, wb, gb, padding=d, dilation=d))
            row["dw_heuristic"] = event_ms(dw)
            ref = dw()
            row["rule"] = event_ms(lambda: k.seg.conv3x3_seg_vjp(
                x, wt, out if relu else None, d, gb.float()))
        with cudnn.flags(enabled=True, benchmark=True, deterministic=True,
                         allow_tf32=False):
            row["dw_benchmark"] = event_ms(dw)
            err_b = float((dw() - ref).abs().max() / ref.abs().max())
        row["dw_gemm"] = event_ms(lambda: dw_gemm(x, wt.shape, gb, d))
        err_g = float((dw_gemm(x, wt.shape, gb, d) - ref).abs().max()
                      / ref.abs().max())
        for key, v in row.items():
            totals[key] += v * per_step
        print("  %-24s d=%2d x%d: %s; benchmark err %.1e, gemm err %.1e"
              % (what, d, per_step,
                 " ".join("%s %.3f" % kv for kv in row.items()), err_b,
                 err_g), flush=True)
    print("conv3x3_seg backward, ms a bf16 step (sum over calls): %s"
          % {key: round(v, 3) for key, v in totals.items()}, flush=True)


def step_ab(k):
    batch = cs.train_batch(k)
    cudnn = torch.backends.cudnn
    for tag, (knobs, *_rest) in cs.TRAIN_PATHS.items():
        model, state, opt = k.step.create_train_state(
            k.UPFlowConfig().updated(knobs), k.TrainerConfig(),
            weights=str(cs.NPZ))
        step_fn = k.step.make_train_step(model, opt)
        for mode in (False, True, True, False):
            cudnn.benchmark = mode
            for _ in range(2):
                state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                state, _ = step_fn(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            print("train %s, cudnn.benchmark %-5s: step %.1f ms median "
                  "(%.1f-%.1f), peak memory %.2f GiB"
                  % (tag, mode, statistics.median(times), min(times),
                     max(times), torch.cuda.max_memory_allocated() / 2 ** 30),
                  flush=True)
        cudnn.benchmark = False


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    k = cs.Port()
    print("device: %s; torch %s" % (cs.nvidia_smi_line(), torch.__version__))
    k.build.build()
    with k.step.deterministic_numerics():
        conv_sweep(k)
    step_ab(k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
