#!/usr/bin/env python3
"""Wall time and device kernel count of the PyTorch port's SGU forwards on
one GPU.

    python3 scripts/torch_forward_wall.py CHECKOUT

Builds the kernels of the checkout at CHECKOUT (a directory holding
``chip_smoke.py`` and ``upflow_pytorch_tpu_torch/``), then times the
bf16 and the fp32 SGU forward at B=4, 384x1280 on ``chip_smoke.py``'s
first request: two medians of 9 forwards each, host clock up to
``torch.cuda.synchronize()``.  It then counts the device kernels of one
forward of each under ``torch.profiler`` (host-device transfers and
memsets apart), as ``chip_smoke.py`` phase 4 does, so that a checkout
older than that count can be counted too.  To compare two commits,
unpack both and run this for each in turns on one card (parent, change,
change, parent): the host's noise between processes is of the same
order as the differences a kernel change makes.
"""

import os
import sys


def kernel_count(fn):
    """(device kernels, transfers and memsets) of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name.lower() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    transfers = sum(n.startswith(("memcpy", "memset")) for n in names)
    return len(names) - transfers, transfers


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_forward_wall: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    k = cs.Port()
    k.build.build()
    b, h, w, seed = cs.REQUESTS[0]
    im1, im2 = cs.textured_pair(b, h, w, seed)
    for tag in ("sgu-bf16", "sgu"):
        model = k.entry.build_model(
            k.UPFlowConfig().updated(cs.PATHS[tag][0]), weights=str(cs.NPZ))
        ms = [cs.wall_ms(lambda: k.entry.forward(model, im1, im2), reps=9)
              for _ in range(2)]
        print("%s %s forward ms %s" % (root, tag,
                                       ", ".join("%.2f" % m for m in ms)))
        print("%s %s forward: %d device kernels, %d transfers and memsets"
              % ((root, tag) + kernel_count(
                  lambda: k.entry.forward(model, im1, im2))))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
