// Masked bilinear feature warp (WarpingLayer_no_div) for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/feature_warp.py
// (feature_warp_window_pallas, _warp_kernel): out = warp(x, flow) * mask,
// mask = (warped all-ones >= thr), zero padding outside the image.
//
// Bound on the H100: bytes.  Per pixel it reads two flow values and
// C x 4 taps and writes C values (plus the mask): a handful of operations
// per byte, far below the card's ~20 fp32 operations per byte of HBM
// traffic.  Design: one thread per output pixel computes the coordinates,
// weights and mask ONCE and loops over the channels of NCHW planes, so
// neighbouring threads read neighbouring addresses of one plane and the
// four taps of a smooth flow hit the same cache lines (L1/L2 serve the
// reuse; HBM sees each input byte about once).  bf16 maps (the bf16
// forward) are read and written as bf16, halving the bytes.  The TPU
// design's staged bands, 128-lane windows and scalar-prefetched offsets
// exist only because a TPU has no vector 2-D gather; a GPU thread gathers
// directly, so they are gone, and so is the window fallback: every flow
// magnitude takes this kernel.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

// T is float or __nv_bfloat16: the map's type, read and written; the
// coordinates, weights and tap sum are fp32 either way.
template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                    T* __restrict__ out, float* __restrict__ mask_out,
                    int C, int H, int W, float thr) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  if (pix >= plane) return;
  const int y = pix / W;
  const int xx = pix - y * W;
  const float* fb = flow + static_cast<size_t>(b) * 2 * plane;
  const upflow::Taps t =
      upflow::bilinear_taps(fb[pix], fb[plane + pix], xx, y, H, W);
  const float m = t.wsum >= thr ? 1.0f : 0.0f;
  if (mask_out != nullptr) mask_out[b * plane + pix] = m;
  const T* xb = x + static_cast<size_t>(b) * C * plane;
  T* ob = out + static_cast<size_t>(b) * C * plane;
  for (int c = 0; c < C; ++c) {
    upflow::store_f32(ob + c * plane + pix,
                      __fmul_rn(upflow::sample_plane(xb + c * plane, t), m));
  }
}

template <typename T>
int launch_feature_warp(const T* x, const float* flow, T* out,
                        float* mask_out, int B, int C, int H, int W,
                        float thr, void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (B == 0 || plane == 0) return 0;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), B);
  feature_warp_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, flow, out, mask_out, C, H, W, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, C, H, W) fp32, flow: (B, 2, H, W) fp32, out: (B, C, H, W),
// mask_out: (B, H, W) or null.  All contiguous on the current device.
extern "C" int upflow_feature_warp(const float* x, const float* flow,
                                   float* out, float* mask_out, int B, int C,
                                   int H, int W, float thr, void* stream) {
  return launch_feature_warp(x, flow, out, mask_out, B, C, H, W, thr, stream);
}

// The same with x and out in bf16: each output value is the fp32 result
// rounded to nearest even.
extern "C" int upflow_feature_warp_bf16(const __nv_bfloat16* x,
                                        const float* flow, __nv_bfloat16* out,
                                        float* mask_out, int B, int C, int H,
                                        int W, float thr, void* stream) {
  return launch_feature_warp(x, flow, out, mask_out, B, C, H, W, thr, stream);
}
