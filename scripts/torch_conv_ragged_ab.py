#!/usr/bin/env python3
"""Device time of ``conv3x3_seg`` at every call of a B=1 375x1242 request,
in one checkout, on one GPU.

    python3 scripts/torch_conv_ragged_ab.py CHECKOUT [REPEATS]

Builds the kernels of the checkout at CHECKOUT (a directory holding
``chip_smoke.py``, ``benchmark/configs/`` and ``upflow_pytorch_tpu_torch/``)
and records every ``conv3x3_seg`` call of one eager request of each of the
benchmark's B=1 serving configurations at KITTI's 375x1242: UPFlow
(``upflow_sgu_bf16_eval``, its snapshot's weights) and RAFT
(``raft_kitti_bf16_eval``, seeded weights).  A call is recorded with the
layout the model gives it: the input's and the output's shapes, strides and
storage offsets, the output channels, the dilation and the activation.
Each distinct call is then timed on buffers of that layout by
``chip_smoke.py::device_ms`` (the profiler's device time), REPEATS times in
turns (default 2):

- ``all_ms``: the call as the checkout stages it (``staging_route``), every
  device kernel it launches; ``kernel_ms``: the conv kernel alone.  Their
  difference is the staging copy, where the route makes one.
- ``tma_ext_ms``: the conv kernel on the TMA route over the same input
  zero-extended to ``Wp`` columns (the least multiple of 8 that is at
  least W + d) in a contiguous map, the output cropped to W columns.

Each call's output must equal the zero-extended one's, cropped, bit for bit
(``bit_equal``).  The script prints one JSON line: each distinct call with
its route, calls a request and readings (medians over the repeats), each
model's sums a request weighted by calls, and the card's name and power
limit.  To compare two commits, unpack both and run this for each in turns
on one card (parent, change, change, parent).
"""

import json
import os
import statistics
import sys

FRAME = (375, 1242)
KERNEL_KEY = "conv3x3_seg_kernel"


def layout(t):
    """(shape, stride, storage offset, storage elements) of a tensor, or
    None."""
    if t is None:
        return None
    return (tuple(t.shape), tuple(t.stride()), t.storage_offset(),
            t.untyped_storage().nbytes() // t.element_size())


def record_calls(seg, run):
    """{call: count} of the ``conv3x3_seg_cuda`` calls that ``run()``
    makes; a call is (x layout, out layout, cout, dilation, relu)."""
    calls = {}
    inner = seg.conv3x3_seg_cuda

    def spy(x, weight, bias, dilation, relu, out=None, packed=None):
        key = (layout(x), layout(out), int(weight.shape[0]), int(dilation),
               relu)
        calls[key] = calls.get(key, 0) + 1
        return inner(x, weight, bias, dilation, relu, out, packed)

    seg.conv3x3_seg_cuda = spy
    try:
        run()
    finally:
        seg.conv3x3_seg_cuda = inner
    return calls


def request_calls(root, torch, np):
    """{model: {call: count}} over one eager request of each model."""
    from upflow_pytorch_tpu_torch.config import RAFTConfig, UPFlowConfig
    from upflow_pytorch_tpu_torch.models import upflow
    from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg

    def config(name):
        with open(os.path.join(root, "benchmark", "configs",
                               name + ".json")) as f:
            return json.load(f)

    rng = np.random.RandomState(0)
    h, w = FRAME
    im1, im2 = (rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2))
    out = {}
    model = upflow.build_model(
        UPFlowConfig().updated(config("upflow_sgu_bf16_eval")["upflow"]),
        weights=os.path.join(root, "assets", "synthetic_trained.npz"))
    with upflow.eager_entry():
        out["upflow"] = record_calls(
            seg, lambda: upflow.forward(model, im1, im2))
    model = upflow.build_model(
        RAFTConfig().updated(config("raft_kitti_bf16_eval")["raft"]), seed=5)
    with upflow.eager_entry():
        out["raft"] = record_calls(
            seg, lambda: upflow.forward(model, im1 * 255.0, im2 * 255.0))
    del model
    torch.cuda.synchronize()
    return out


def buffers(call, torch, gen):
    """Input, output, weight and bias of a recorded call on fresh buffers
    of its layout."""
    (xs, xst, xoff, xn), out_l, cout, _, _ = call

    def view(lay, fill):
        shape, stride, off, n = lay
        buf = torch.empty(n, dtype=torch.bfloat16, device="cuda")
        if fill:
            buf.copy_(torch.randn(n, generator=gen, device="cuda"))
        return buf.as_strided(shape, stride, off)

    x = view((xs, xst, xoff, xn), True)
    out = (view(out_l, False) if out_l is not None else
           torch.empty((xs[0], cout, xs[2], xs[3]), dtype=torch.bfloat16,
                       device="cuda"))
    cin = xs[1]
    weight = torch.randn((cout, cin, 3, 3), generator=gen,
                         device="cuda") * (2.0 / (9 * cin)) ** 0.5
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    return x, out, weight, bias


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    repeats = int(sys.argv[2]) if len(sys.argv) == 3 else 2
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_conv_ragged_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from upflow_pytorch_tpu_torch import _build
    from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as seg

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for model, calls in request_calls(root, torch, np).items():
        for call, count in calls.items():
            x, out, weight, bias = buffers(call, torch, gen)
            _, _, _, d, relu = call
            b, cin, h, w = x.shape
            wp = -(-(w + d) // 8) * 8
            x_ext = F.pad(x, (0, wp - w))
            out_ext = torch.empty((b, out.shape[1], h, wp),
                                  dtype=torch.bfloat16, device="cuda")
            packed = seg.packed_params(torch.nn.Module(), weight, bias)

            def staged(x=x, weight=weight, bias=bias, d=d, relu=relu,
                       out=out, packed=packed):
                seg.conv3x3_seg_cuda(x, weight, bias, d, relu, out, packed)

            def extended(x_ext=x_ext, weight=weight, bias=bias, d=d,
                         relu=relu, out_ext=out_ext, packed=packed):
                seg.conv3x3_seg_cuda(x_ext, weight, bias, d, relu, out_ext,
                                     packed)

            staged()
            extended()
            torch.cuda.synchronize()
            cases.append(dict(
                model=model, calls=count, shape=[b, cin, h, w],
                cout=out.shape[1], dilation=d, relu=str(relu),
                x_batch_stride=x.stride(0), wp=wp,
                route=seg.staging_route(w, x.stride(0), x.data_ptr()),
                ext_route=seg.staging_route(wp, x_ext.stride(0),
                                            x_ext.data_ptr()),
                bit_equal=bool(torch.equal(out, out_ext[..., :w])),
                fns=(staged, extended), readings={}))
    for _ in range(repeats):
        for case in cases:
            staged, extended = case["fns"]
            for name, fn, key in (("all_ms", staged, None),
                                  ("kernel_ms", staged, KERNEL_KEY),
                                  ("tma_ext_ms", extended, KERNEL_KEY)):
                ms, _ = cs.device_ms(fn, key)
                case["readings"].setdefault(name, []).append(ms)
    sums = {}
    for case in cases:
        del case["fns"]
        for name, vals in case.pop("readings").items():
            vals = [v for v in vals if v is not None]
            case[name] = statistics.median(vals) if vals else None
            key = "%s.%s.%s" % (case["model"], case["route"], name)
            if case[name] is not None:
                sums[key] = sums.get(key, 0.0) + case[name] * case["calls"]
        key = "%s.%s.calls" % (case["model"], case["route"])
        sums[key] = sums.get(key, 0) + case["calls"]
    print(json.dumps({"checkout": root, "frame": list(FRAME),
                      "per_request": sums, "calls": cases,
                      "gpu": cs.nvidia_smi_line()}))
    return 0 if all(c["bit_equal"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
