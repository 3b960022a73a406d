// Zero-padded bilinear image warp (tools.torch_warp) for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/warp.py
// (_window_warp_chw, _warp_kernel, through flow_warp_fast): the warp of
// C <= 4 planes (flows in the occlusion check) by a flow, zero outside
// the image, no mask.
//
// Bound on the H100: bytes.  Per pixel it reads two flow values and
// C x 4 taps and writes C values; at (4, 384, 1280, 2) the flow, the
// source and the output are 15.7 MB each, for a few operations per byte.
// Design:
// the feature-warp kernel without the mask, one thread per output pixel,
// weights computed once and reused for the C planes; neighbouring threads
// read neighbouring addresses, and the taps of a smooth flow share cache
// lines.  The TPU design's statically shifted source blocks, displacement
// window and XLA fallback are gone: a GPU thread gathers directly, for
// every flow magnitude.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ x, const float* __restrict__ flow,
            float* __restrict__ out, int C, int H, int W) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  if (pix >= plane) return;
  const int y = pix / W;
  const int xx = pix - y * W;
  const float* fb = flow + static_cast<size_t>(b) * 2 * plane;
  const upflow::Taps t =
      upflow::bilinear_taps(fb[pix], fb[plane + pix], xx, y, H, W);
  const float* xb = x + static_cast<size_t>(b) * C * plane;
  float* ob = out + static_cast<size_t>(b) * C * plane;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) ob[c * plane + pix] = upflow::sample_plane(xb + c * plane, t);
  }
}

}  // namespace

// x: (B, C, H, W) fp32 with C <= 4, flow: (B, 2, H, W) fp32,
// out: (B, C, H, W).  All contiguous on the current device.
extern "C" int upflow_warp(const float* x, const float* flow, float* out,
                           int B, int C, int H, int W, void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (C > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || plane == 0) return 0;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), B);
  warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, flow, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
