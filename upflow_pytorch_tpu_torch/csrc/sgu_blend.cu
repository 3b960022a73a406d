// SGU blend at the decode levels for Hopper:
//     out = warp(flow, inter_flow) * (1 - m) + flow * m
// with warp = tools.torch_warp (zero-padded bilinear, no mask).
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/blend.py
// (sgu_blend_pallas, the +-2 px fused tier) and, with it, the medium tier
// of ops/warp.py::_sgu_blend_tpu_impl (the windowed planar warp of
// ops/pallas/warp.py::_window_warp_resident) and its XLA gather fallback.
//
// Bound on the H100: bytes.  Per pixel it reads 5 values (flow u, v,
// inter-flow u, v, mask) plus 2 x 4 taps of the flow planes, and writes 2;
// at level 4 (B=4, 96x320) that is 7 planes, 3.4 MB, a bound of about
// 1 us, for a few dozen operations per pixel.  Design: one thread per
// output pixel, taps and weights computed once for both planes
// (warp_common.cuh), neighbouring threads on neighbouring addresses; the
// taps of a smooth inter-flow share cache lines.  A GPU thread gathers
// directly, so one kernel serves every inter-flow magnitude: the TPU's
// three tiers, its displacement windows and its lax.cond are gone.  Every
// step is a correctly rounded intrinsic in the plain version's op order,
// so kernel and plain version agree bit for bit.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sgu_blend_kernel(const float* __restrict__ flow,
                 const float* __restrict__ inter_flow,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int H, int W) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  if (pix >= plane) return;
  const int y = pix / W;
  const int x = pix - y * W;
  const float* fb = flow + static_cast<size_t>(b) * 2 * plane;
  const float* ib = inter_flow + static_cast<size_t>(b) * 2 * plane;
  const upflow::Taps t =
      upflow::bilinear_taps(ib[pix], ib[plane + pix], x, y, H, W);
  const float m = mask[b * plane + pix];
  float* ob = out + static_cast<size_t>(b) * 2 * plane;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* src = fb + c * plane;
    ob[c * plane + pix] =
        upflow::blend(upflow::sample_plane(src, t), src[pix], m);
  }
}

}  // namespace

// flow, inter_flow: (B, 2, H, W) fp32, mask: (B, 1, H, W) fp32,
// out: (B, 2, H, W).  All contiguous on the current device.
extern "C" int upflow_sgu_blend(const float* flow, const float* inter_flow,
                                const float* mask, float* out, int B, int H,
                                int W, void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (B == 0 || plane == 0) return 0;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), B);
  sgu_blend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      flow, inter_flow, mask, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
