#!/usr/bin/env python3
"""Ablations of the final SGU stage kernel (``csrc/sgu_final.cu``).

    python3 scripts/torch_sgu_final_ablate.py

Run from the repository root on a machine with an NVIDIA GPU and nvcc.
Each variant is the kernel's source with one part cut out by a text
substitution (its results are wrong on purpose; only its time counts),
built alone into ``upflow_pytorch_tpu_torch/_build/ablate/<variant>/`` and
timed by the profiler's device time at B=4 384x1280, quarter-resolution
inter-flow +-9 px, in turns (forward, then backward through the list).
The unchanged kernel's SASS is summarised by opcode (``cuobjdump``), so
the instruction count of a pixel can be read beside the times.

Variants: ``full`` (unchanged); ``no-precompute`` (the raw patches
staged, no row lerps computed from them); ``no-main`` (staging and row
lerps only); ``no-taps`` (the warp's taps read nothing); ``raw-only``
(the raw patches and tables staged, nothing computed); ``empty`` (the
launch and the staged box's bounds alone); ``no-div`` (the coordinate
roundtrip's division without its correction steps); ``timed`` (the
unchanged kernel with clock64 stamps: the cycles a block spends staging,
lerping rows and computing pixels).  Alternatives, exact: ``two-blocks``
(registers for two blocks an SM instead of three) and ``raw-taps`` (no
row lerps of u and v staged: the taps lerp the raw patch, 4 loads a tap
instead of 2).
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from upflow_pytorch_tpu_torch import _build  # noqa: E402
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as ksf  # noqa
from upflow_pytorch_tpu_torch.ops.resize import interp_taps  # noqa: E402

SRC = ROOT / "upflow_pytorch_tpu_torch" / "csrc"
OUT = ROOT / "upflow_pytorch_tpu_torch" / "_build" / "ablate"

VARIANTS = {
    "full": {},
    "no-precompute": {
        "sgu_final.cu": [
            ("i = warp; i < n_rows; i += kWarps", "i = warp; i < 0; i += 1")]},
    "no-main": {
        "sgu_final.cu": [("i = warp; i < own_rows; i += kWarps",
                          "i = warp; i < 0; i += kWarps")]},
    "no-taps": {
        "sgu_final.cu": [("const float2 v = uv_at((k < 2 ? ya : yb) - yr0, "
                          "k % 2 ? cb : ca);",
                          "const float2 v = make_float2(ca.w0, cb.w1);")]},
    "raw-only": {
        "sgu_final.cu": [
            ("i = warp; i < n_rows; i += kWarps", "i = warp; i < 0; i += 1"),
            ("i = warp; i < own_rows; i += kWarps",
             "i = warp; i < 0; i += kWarps")]},
    "empty": {
        "sgu_final.cu": [("  if (nq > kQC || no > kQO",
                          "  if (b >= 0) return;\n  if (nq > kQC || no > kQO")]},
    "raw-taps": {
        "sgu_final.cu": [
            ("i = warp; i < n_rows; i += kWarps", "i = warp; i < 0; i += 1"),
            ("""    const float2* r = r_uv + i * kQC - cq0;
    const float2 a = r[c.i0], bb = r[c.i1];""",
             """    const Lerp rl = unpack(row_tab[i]);
    const float2* a0 = raw_uv + (rl.i0 - qr0) * kQC - cq0;
    const float2* a1 = raw_uv + (rl.i1 - qr0) * kQC - cq0;
    const float2 p0 = a0[c.i0], p1 = a1[c.i0], q0 = a0[c.i1], q1 = a1[c.i1];
    const float2 a = make_float2(mix(p0.x, p1.x, rl), mix(p0.y, p1.y, rl));
    const float2 bb = make_float2(mix(q0.x, q1.x, rl), mix(q0.y, q1.y, rl));""")]},
    "two-blocks": {
        "sgu_final.cu": [("__launch_bounds__(kThreads, 3)",
                          "__launch_bounds__(kThreads, 2)")]},
    # phase times of a block by clock64: staging until the raw patches
    # arrived, the row lerps, the pixels; summed over blocks
    "timed": {
        "sgu_final.cu": [
            ("template <int TY>\n__global__", "__device__ unsigned long long "
             "g_phase[4];\n\ntemplate <int TY>\n__global__"),
            ("  const int tid = threadIdx.x;\n",
             "  const int tid = threadIdx.x;\n  const long long t_start = "
             "clock64();\n  long long t_raw = t_start, t_lerp = t_start;\n"),
            ("  __syncthreads();  // the tables and the raw patches\n",
             "  __syncthreads();  // the tables and the raw patches\n"
             "  t_raw = clock64();\n"),
            ("  __syncthreads();\n\n  // u and v resized",
             "  __syncthreads();\n  t_lerp = clock64();\n\n  // u and v resized"),
            ("    store(y, res);\n  }\n}\n\ntemplate <int TY>\nint launch(",
             "    store(y, res);\n  }\n  __syncthreads();\n  if (tid == 0) {\n"
             "    atomicAdd(&g_phase[0], t_raw - t_start);\n"
             "    atomicAdd(&g_phase[1], t_lerp - t_raw);\n"
             "    atomicAdd(&g_phase[2], clock64() - t_lerp);\n"
             "    atomicAdd(&g_phase[3], 1ull);\n  }\n}\n\n"
             "template <int TY>\nint launch("),
            ("      return static_cast<int>(cudaErrorInvalidValue);\n  }\n}\n",
             "      return static_cast<int>(cudaErrorInvalidValue);\n  }\n}\n"
             "\nextern \"C\" int sgu_final_phases(unsigned long long* h) {\n"
             "  cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n"
             "  const unsigned long long z[4] = {0, 0, 0, 0};\n"
             "  return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, "
             "sizeof(z)));\n}\n")]},
    "no-div": {
        "warp_common.cuh": [("  q = __fmaf_rn(__fmaf_rn(-q, v.d, a), v.r, "
                             "q);\n  return __fmaf_rn(__fmaf_rn(-q, v.d, a), "
                             "v.r, q);", "  return q;")]},
}
FILES = ("sgu_final.cu", "common.cu", "warp_common.cuh", "per_device.cuh")


def build(name, subs):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in FILES:
        text = (SRC / f).read_text()
        for old, new in subs.get(f, []):
            if old not in text:
                raise RuntimeError("%s: %r not in %s" % (name, old, f))
            text = text.replace(old, new)
        (d / f).write_text(text)
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sgu_final_ablate: no CUDA device", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    dirs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "sgu_final.cu"), str(d / "common.cu")]
            for d in dirs.values()]
    log = _build._run_all(cmds)
    for line in log.splitlines():
        if "sgu_final_kernel" in line or "Used" in line:
            print("ptxas " + line.strip())

    # SASS of the unchanged kernel, by opcode
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(dirs["full"] / "lib.so")],
                          capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.splitlines()[0].strip()
        if "sgu_final_kernel" not in name or "Li32E" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_.]+)", fn))
        print("SASS %s: %d instructions; %s" % (
            name[:60], sum(ops.values()),
            ", ".join("%s %d" % kv for kv in ops.most_common(30))))

    rng = np.random.RandomState(1)
    b, h, w = 4, 384, 1280
    hq, wq = cs.pyramid_hw(h, w)[4]
    flow_q = cs.make_flow(rng, b, hq, wq, 10.0)
    x_out = torch.from_numpy(np.concatenate(
        [(rng.rand(b, 2, hq, wq) - 0.5) * 18,
         (rng.rand(b, 1, hq, wq) - 0.5) * 6], axis=1).astype(np.float32)
    ).cuda()
    mask_q = torch.sigmoid(x_out[:, 2:3]).contiguous()
    ri, rw = interp_taps(h, hq, flow_q.device)
    ci, cw = interp_taps(w, wq, flow_q.device)
    out = torch.empty((b, 2, h, w), device="cuda")
    ref = ksf.sgu_final_plain(flow_q, x_out, (h, w))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for name, d in dirs.items():
        fn = ctypes.CDLL(str(d / "lib.so")).upflow_sgu_final
        fn.argtypes = [P] * 8 + [I] * 7 + [F, F, I, P]
        fn.restype = I
        fns[name] = fn
    for ty in (32, 16):
        for name in list(fns) + list(fns)[::-1]:
            def call(fn=fns[name]):
                code = fn(flow_q.data_ptr(), x_out.data_ptr(),
                          mask_q.data_ptr(), ri.data_ptr(), rw.data_ptr(),
                          ci.data_ptr(), cw.data_ptr(), out.data_ptr(), b,
                          hq, wq, h, w, w, 0, w / wq, h / hq, ty,
                          torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            dev, _ = cs.device_ms(call, "sgu_final_kernel", 21)
            print("sgu_final %-14s tile %dx128: device %s ms (max err %.2e)"
                  % (name, ty, cs.fmt(dev), err), flush=True)
        phases = ctypes.CDLL(str(dirs["timed"] / "lib.so")).sgu_final_phases
        phases.argtypes = [P]
        acc = np.zeros(4, np.uint64)
        phases(acc.ctypes.data)
        call = (lambda fn=fns["timed"]: fn(
            flow_q.data_ptr(), x_out.data_ptr(), mask_q.data_ptr(),
            ri.data_ptr(), rw.data_ptr(), ci.data_ptr(), cw.data_ptr(),
            out.data_ptr(), b, hq, wq, h, w, w, 0, w / wq, h / hq, ty,
            torch.cuda.current_stream().cuda_stream))
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        phases(acc.ctypes.data)
        print("tile %dx128: cycles a block: staging %.0f, row lerps %.0f, "
              "pixels %.0f (%d blocks)" % ((ty,) + tuple(acc[:3] / acc[3])
                                         + (int(acc[3]) // 10,)), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
