#!/usr/bin/env python3
"""Launch-configuration sweeps of three kernels of the PyTorch/CUDA port.

    python3 scripts/torch_kernel_sweep.py

Run from the repository root on a machine with an NVIDIA GPU.  For each
configuration the kernel is called through its C entry point, held
against its plain PyTorch version (it must be within 1e-5 x max|out| for
the correlation, 1e-4 px for the final SGU stage) and timed by the
profiler's device time (``chip_smoke.device_ms``); configurations are
taken in turns (a, b, ..., b, a) so that a drift of the card shows.

- ``correlation`` (``csrc/correlation.cu``) at decode level 0, (4, 196,
  6, 20) and (1, 196, 6, 20), fp32 and bf16: every tile of
  ``ops/kernels/correlation.py::TILES`` with 8 and 16 channel splits,
  beside ``corr_norm`` in the configuration the wrapper takes.
- ``sgu_final`` (``csrc/sgu_final.cu``) at B=4 384x1280 and B=1 375x1242:
  tiles of 16 and 32 rows at quarter-resolution inter-flows of +-0.4, +-9
  and +-75 px.
- ``sgu_blend`` (``csrc/sgu_blend.cu``) at decode levels 1-4 of B=4
  384x1280, both directions a launch, fp32 heads: 1 and 2 pixels a
  thread, blocks of 1, 2, 4 and 8 rows, at inter-flows of +-1.5 px and
  +-30/+-15 px, each bit for bit against its plain version, beside the
  configuration ``ops/kernels/sgu_blend.py::launch_config`` takes.

Before the sweeps it checks the final SGU stage's division
(``csrc/warp_common.cuh::div_rn``) and the coordinate roundtrip built on
it against ``__fdiv_rn`` bit for bit, on every nonzero float of magnitude
up to 2^14 for the divisors the sizes give.
``--sgu-final-only`` skips the correlation sweep; ``--sgu-blend-only``
runs the ``sgu_blend`` sweep alone.

Prints one line a reading and, last, the card's name and power limit.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from upflow_pytorch_tpu_torch import _build  # noqa: E402
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as kcn  # noqa
from upflow_pytorch_tpu_torch.ops.kernels import correlation as kc  # noqa
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as ksb  # noqa
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as ksf  # noqa
from upflow_pytorch_tpu_torch.ops.kernels._common import (  # noqa: E402
    FLOAT, INT, LONG, PTR, launch)
from upflow_pytorch_tpu_torch.ops.resize import interp_taps  # noqa: E402

COUNT = types.SimpleNamespace(launches=0)


def corr_fn(dtype):
    return _build.kernel_fn(
        "upflow_correlation" + ("_bf16" if dtype == torch.bfloat16 else ""),
        [PTR, PTR, PTR] + [INT] * 8 + [PTR])


def sweep_correlation():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (4, 1):
        c, h, w = 196, 6, 20
        f1 = torch.randn((b, c, h, w), generator=gen, device="cuda")
        f2 = torch.randn((b, c, h, w), generator=gen, device="cuda")
        aff = kcn.affine_pair(*kcn.moments(f1, False),
                              *kcn.moments(f2, False), cs.NORM_KW)
        for dtype in (torch.float32, torch.bfloat16):
            a1, a2 = f1.to(dtype), f2.to(dtype)
            ref = kc.correlation_plain(a1, a2)
            bar = 1e-5 * ref.abs().max().item()
            out = torch.empty_like(ref)
            fn = corr_fn(dtype)
            configs = [(r, cols, s) for r, cols in kc.TILES for s in (8, 16)
                       if b * -(-w // cols) * -(-h // r) * s >= 24]
            order = configs + configs[::-1]
            for rows, cols, splits in order:
                def call(rows=rows, cols=cols, splits=splits):
                    launch("correlation", COUNT, a1, fn, a1.data_ptr(),
                           a2.data_ptr(), out.data_ptr(), b, c, h, w, rows,
                           cols, splits, 1)
                call()
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                first = out.clone()
                call()
                same = torch.equal(first, out)
                dev, _ = cs.device_ms(call, "corr_plain_kernel", 51)
                blocks = b * -(-w // cols) * -(-h // rows) * splits
                print("correlation %s (%d,%d,%d,%d) tile %dx%d splits %d "
                      "(%d blocks): err %.3e (bar %.3e, %s), same bits %s, "
                      "device %s ms"
                      % (str(dtype)[6:], b, c, h, w, rows, cols, splits,
                         blocks, err, bar, "ok" if err <= bar else "FAIL",
                         same, cs.fmt(dev)), flush=True)
            dev, _ = cs.device_ms(
                lambda: kcn.corr_norm(a1, a2, aff, 0.1), "corr_norm_kernel",
                51)
            print("corr_norm %s (%d,%d,%d,%d) config %s: device %s ms"
                  % (str(dtype)[6:], b, c, h, w, kc.launch_config(b, c, h, w),
                     cs.fmt(dev)), flush=True)


def sweep_sgu_final():
    rng = np.random.RandomState(1)
    fn = _build.kernel_fn("upflow_sgu_final",
                          [PTR] * 8 + [INT] * 7 + [FLOAT, FLOAT, INT, PTR])
    for b, h, w in ((4, 384, 1280), (1, 375, 1242)):
        hq, wq = cs.pyramid_hw(h, w)[4]
        flow_q = cs.make_flow(rng, b, hq, wq, 10.0)
        ri, rw = interp_taps(h, hq, flow_q.device)
        ci, cw = interp_taps(w, wq, flow_q.device)
        for amp in (0.4, 9.0, 75.0):
            x_out = torch.from_numpy(np.concatenate(
                [(rng.rand(b, 2, hq, wq) - 0.5) * 2 * amp,
                 (rng.rand(b, 1, hq, wq) - 0.5) * 6], axis=1
            ).astype(np.float32)).cuda()
            mask_q = torch.sigmoid(x_out[:, 2:3]).contiguous()
            ref = ksf.sgu_final_plain(flow_q, x_out, (h, w))
            out = torch.empty_like(ref)
            for ty in (16, 32, 32, 16):
                def call(ty=ty):
                    launch("sgu_final", COUNT, flow_q, fn, flow_q.data_ptr(),
                           x_out.data_ptr(), mask_q.data_ptr(), ri.data_ptr(),
                           rw.data_ptr(), ci.data_ptr(), cw.data_ptr(),
                           out.data_ptr(), b, hq, wq, h, w, w, 0, w / wq,
                           h / hq, ty)
                call()
                torch.cuda.synchronize()
                d = (out - ref).abs()
                dev, _ = cs.device_ms(call, "sgu_final_kernel", 21)
                print("sgu_final (%d,%d,%d,%d) -> (%d,%d), inter-flow +-%g "
                      "px, tile %dx128: max err %.3e px (%s), %d of %d "
                      "differ, device %s ms"
                      % (b, 3, hq, wq, h, w, amp, ty, d.max().item(),
                         "ok" if d.max().item() <= 1e-4 else "FAIL",
                         int((d > 0).sum().item()), d.numel(),
                         cs.fmt(dev)), flush=True)


def sweep_sgu_blend():
    rng = np.random.RandomState(2)
    fn = _build.kernel_fn("upflow_sgu_blend",
                          [PTR] * 8 + [INT, LONG, LONG] + [INT] * 9 + [PTR])
    configs = [(pix, rows) for pix in (1, 2) for rows in (1, 2, 4, 8)]
    for level, (h, w) in enumerate(cs.pyramid_hw(cs.MAIN_H, cs.MAIN_W)):
        if level == 0:
            continue
        b = cs.MAIN_B
        flows = [cs.make_flow(rng, b, h, w, max(2.0, min(40.0, w / 4)))
                 for _ in range(2)]
        chosen = ksb.launch_config(2, b, h, w)[:2]
        for amp_u, amp_v in ((1.5, 1.5), (30.0, 15.0)):
            heads = [torch.from_numpy(np.concatenate(
                [(rng.rand(b, 1, h, w) - 0.5) * 2 * amp_u,
                 (rng.rand(b, 1, h, w) - 0.5) * 2 * amp_v,
                 (rng.rand(b, 1, h, w) - 0.5) * 12], axis=1
            ).astype(np.float32)).cuda() for _ in range(2)]
            ref = ksb.sgu_blend_pair_plain(flows[0], heads[0], flows[1],
                                           heads[1])
            outs = [torch.empty_like(r) for r in ref]
            plane = 4 * h * w
            for pix, rows in configs + configs[::-1]:
                def call(pix=pix, rows=rows):
                    launch("sgu_blend", COUNT, flows[0], fn,
                           flows[0].data_ptr(), heads[0].data_ptr(),
                           heads[0].data_ptr() + 2 * plane,
                           outs[0].data_ptr(), flows[1].data_ptr(),
                           heads[1].data_ptr(),
                           heads[1].data_ptr() + 2 * plane,
                           outs[1].data_ptr(), 2, 3 * h * w, 3 * h * w, b,
                           h, w, w, 0, 0, 1, pix, rows)
                call()
                torch.cuda.synchronize()
                differ = sum(int((o != r).sum().item())
                             for o, r in zip(outs, ref))
                dev, _ = cs.device_ms(call, "sgu_blend_kernel", 21)
                print("sgu_blend L%d (2,%d,3,%d,%d), inter-flow +-%g/+-%g px,"
                      " %d pixels a thread, %d-row blocks%s: %d values "
                      "differ (%s), device %s ms"
                      % (level, b, h, w, amp_u, amp_v, pix, rows,
                         " (launch_config)" if (pix, rows) == chosen else "",
                         differ, "ok" if differ == 0 else "FAIL",
                         cs.fmt(dev)), flush=True)


DIV_CHECK = r"""
#include <cuda_runtime.h>
#include "warp_common.cuh"

// One correction step after q = RN(a / d) from the reciprocal.
__device__ __forceinline__ float div_one_step(float a, float d, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, d, a), r, q);
}

// For a = bits(lo + k), k < n, and -a, counts in bad[0..4]: quotients by
// d of one correction step that differ from __fdiv_rn's in any bit, all
// and for |a| >= 2^-24; the same of upflow::div_rn; and the values of
// grid_roundtrip(a, size) with the precomputed divisor that differ from
// those with __fdiv_rn, where size = d + 1.
__global__ void div_check(float d, unsigned lo, unsigned n,
                          unsigned long long* bad) {
  const upflow::Divisor v = upflow::roundtrip_divisor(static_cast<int>(d) + 1);
  unsigned long long c[5] = {0, 0, 0, 0, 0};
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float m = __uint_as_float(lo + k);
    for (int s = 0; s < 2; ++s) {
      const float a = s ? -m : m;
      const unsigned want = __float_as_uint(__fdiv_rn(a, d));
      const bool one = __float_as_uint(div_one_step(a, d, v.r)) != want;
      const bool two = __float_as_uint(upflow::div_rn(a, v)) != want;
      const bool big = m >= 5.9604645e-8f;  // 2^-24
      c[0] += one;
      c[1] += one && big;
      c[2] += two;
      c[3] += two && big;
      const int size = static_cast<int>(d) + 1;
      c[4] += __float_as_uint(upflow::grid_roundtrip(a, size, v)) !=
              __float_as_uint(upflow::grid_roundtrip(a, size));
    }
  }
  for (int i = 0; i < 5; ++i)
    if (c[i]) atomicAdd(bad + i, c[i]);
}

extern "C" int run_div_check(float d, unsigned lo, unsigned n,
                             unsigned long long* bad) {
  div_check<<<132 * 8, 256>>>(d, lo, n, bad);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def check_division():
    """``warp_common.cuh::div_rn`` (and a single correction step) against
    ``__fdiv_rn``, and ``grid_roundtrip`` with the precomputed divisor
    against it with ``__fdiv_rn``: every nonzero float of magnitude up to
    2^14 (both signs), for each image size less one of the main path
    (383, 1279, 374, 1241), the quarter-resolution ones (95, 319, 93, 310)
    and 1-64."""
    out = ROOT / "upflow_pytorch_tpu_torch" / "_build" / "divcheck"
    out.mkdir(parents=True, exist_ok=True)
    (out / "div_check.cu").write_text(DIV_CHECK)
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                      str(_build.SRC_DIR), "-o", str(out / "lib.so"),
                      str(out / "div_check.cu")]])
    import ctypes
    fn = ctypes.CDLL(str(out / "lib.so")).run_div_check
    fn.argtypes = [ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the nonzero floats up to 2^14: a zero quotient may differ in its sign,
    # which the roundtrip's next step (- 1) drops
    n = int(np.float32(2.0 ** 14).view(np.uint32))
    divisors = [383, 1279, 374, 1241, 95, 319, 93, 310] + list(range(1, 65))
    total = np.zeros(5, np.int64)
    for d in divisors:
        bad = torch.zeros(5, dtype=torch.int64, device="cuda")
        assert fn(float(d), 1, n, bad.data_ptr()) == 0
        got = bad.cpu().numpy()
        total += got
        if d in divisors[:8]:
            print("  divisor %d: %s" % (d, got.tolist()))
    print("division check over %d divisors x %d floats x 2 signs: one step "
          "differs from __fdiv_rn on %d (%d with |a| >= 2^-24); div_rn on "
          "%d (%d); grid_roundtrip values differ on %d"
          % ((len(divisors), n) + tuple(int(v) for v in total)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    lib = _build.build()
    for line in (lib.parent / "build.log").read_text().splitlines():
        if ("Used" in line or "spill" in line or "Compiling entry" in line):
            print("ptxas " + line.strip())
    if "--sgu-blend-only" in sys.argv:
        sweep_sgu_blend()
        print(cs.nvidia_smi_line())
        return 0
    check_division()
    if "--sgu-final-only" not in sys.argv:
        sweep_correlation()
    sweep_sgu_final()
    sweep_sgu_blend()
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
