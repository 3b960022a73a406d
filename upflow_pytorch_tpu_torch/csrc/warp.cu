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
// Design: one thread per output pixel in blocks of 8 rows x 32 columns, so
// a thread finds its pixel without a division and a warp's taps of a
// smooth flow share cache lines.  The taps are computed once per pixel and
// reused for the C planes, with the correctly rounded arithmetic of
// warp_common.cuh, so the result is bit-equal to the plain version for
// every flow magnitude.  Four pixels a thread with float4 flow loads and
// stores ran slower on the H100 at (4, 2, 384, 1280): it holds more
// registers, so fewer warps hide the gathers' latency.  The TPU design's
// statically shifted source blocks, displacement window and XLA fallback
// are gone: a GPU thread gathers directly.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxChannels = 4;

__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_kernel(const float* __restrict__ x, const float* __restrict__ flow,
            float* __restrict__ out, int C, int H, int W) {
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int xx = blockIdx.x * kBlockX + threadIdx.x;
  if (y >= H || xx >= W) return;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y) * W + xx;
  const float* fb = flow + static_cast<size_t>(b) * 2 * plane;
  const upflow::Taps t = upflow::bilinear_taps(
      __ldg(fb + pix), __ldg(fb + plane + pix), xx, y, H, W);
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
  if (C > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                  B);
  warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, flow, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
