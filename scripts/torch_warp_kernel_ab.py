#!/usr/bin/env python3
"""Device time of the port's four warp kernels in one checkout, on one GPU.

    python3 scripts/torch_warp_kernel_ab.py CHECKOUT [REPEATS]

Builds the kernels of the checkout at CHECKOUT (a directory holding
``chip_smoke.py`` and ``upflow_pytorch_tpu_torch/``) and times, by
``chip_smoke.py::device_ms`` (the profiler's device time), the rows of
``chip_smoke.py``'s kernels line that the four warp kernels serve, at
phase 2's shapes of a B=4 384x1280 SGU forward and summed over a
forward's calls as that line sums them: ``feature_warp`` (the 18 calls,
fp32 and bf16 maps), ``warp`` (the occlusion check's (4, 2, 384, 1280)
call), ``sgu_blend`` (one launch a level, levels 1-4, fp32 and bf16 heads)
and ``sgu_final`` ((4, 3, 96, 320) -> 384x1280).  The inputs are made from
fixed seeds and each wrapper is called at its whole-frame defaults, so a
checkout from before the kernels took a column offset times the same
work.  Each row is timed REPEATS times (default 3), in turns; the script
prints one JSON line with every reading and the card's name and power
limit.  To compare two commits, unpack both and run this for each in
turns on one card (parent, change, change, parent).
"""

import json
import os
import sys


def rows_of(k, cs, torch, np):
    """{row: [(fn, per_forward)]} at phase 2's shapes."""
    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uniform(shape, amp):
        return torch.from_numpy(((rng.rand(*shape) - 0.5) * 2 * amp).astype(
            np.float32)).to("cuda")

    b, h, w = cs.MAIN_B, cs.MAIN_H, cs.MAIN_W
    levels = cs.pyramid_hw(h, w)
    rows = {name: [] for name in ("feature_warp", "feature_warp_bf16", "warp",
                                  "sgu_blend", "sgu_blend_bf16", "sgu_final")}
    # the 8 cost-volume warps (levels 1-4) and the SGU's 10 warps of the
    # 32-channel features (levels 1-4 and the final stage)
    for level in range(1, 6):
        hl, wl = levels[min(level, 4)]
        amp = max(2.0, min(40.0, wl / 4))
        chans = [32] if level == 5 else [cs.PYRAMID_CHS[level], 32]
        for c in chans:
            x = randn(b, c, hl, wl) * 2 + 0.5
            flow = cs.make_flow(rng, b, hl, wl, amp)
            for dtype, suffix in ((torch.float32, ""),
                                  (torch.bfloat16, "_bf16")):
                xd = x.to(dtype)
                rows["feature_warp" + suffix].append(
                    (lambda xd=xd, flow=flow: k.fw.feature_warp(xd, flow, 1.0),
                     2))
    src = cs.make_flow(rng, b, h, w, 40.0)
    flow = cs.make_flow(rng, b, h, w, 40.0)
    rows["warp"].append((lambda: k.warp.warp(src, flow), 1))
    for level in range(1, 5):
        hl, wl = levels[level]
        amp = max(2.0, min(40.0, wl / 4))
        flows = [cs.make_flow(rng, b, hl, wl, amp) for _ in range(2)]
        heads = [torch.cat([uniform((b, 1, hl, wl), 30.0),
                            uniform((b, 1, hl, wl), 15.0),
                            uniform((b, 1, hl, wl), 6.0)], dim=1)
                 for _ in range(2)]
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            args = (flows[0], heads[0].to(dtype), flows[1],
                    heads[1].to(dtype))
            rows["sgu_blend" + suffix].append(
                (lambda args=args: k.sb.sgu_blend_pair(*args), 1))
    hq, wq = levels[4]
    flow_q = cs.make_flow(rng, b, hq, wq, 10.0)
    x_out = torch.cat([uniform((b, 2, hq, wq), 9.0),
                       uniform((b, 1, hq, wq), 3.0)], dim=1)
    rows["sgu_final"].append(
        (lambda: k.sf.sgu_final(flow_q, x_out, (h, w)), 2))
    return rows


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    repeats = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_warp_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    k = cs.Port()
    k.build.build()
    rows = rows_of(k, cs, torch, np)
    out = {name: [] for name in rows}
    for _ in range(repeats):
        for name, calls in rows.items():
            key = cs.KERNEL_KEY[name]
            total = 0.0
            for fn, per_forward in calls:
                ms, _ = cs.device_ms(fn, key)
                total = None if ms is None or total is None \
                    else total + ms * per_forward
            out[name].append(total)
    print(json.dumps({"checkout": root, "device_ms": out,
                      "gpu": cs.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
