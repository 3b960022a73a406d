// Masked bilinear feature warp (WarpingLayer_no_div) for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/feature_warp.py
// (feature_warp_window_pallas, _warp_kernel): out = warp(x, flow) * mask,
// mask = (warped all-ones >= thr), zero padding outside the image.
//
// Bound on the H100: bytes.  Per pixel it reads two flow values and
// C x 4 taps and writes C values (plus the mask): a handful of operations
// per byte, far below the card's ~20 fp32 operations per byte of HBM
// traffic.  What holds a simple kernel back is latency, not bandwidth: at
// the coarse decode levels (12 x 40, 24 x 80) one thread per pixel gives a
// grid of a few blocks, and each thread walks C channels through chains of
// dependent gathers.  Design: a grid over (pixel block, channel group,
// batch item).  Each thread computes its pixel's taps and mask (about 30
// operations, repeated by every group) and warps its group's channels
// kUnroll at a time, issuing all 4 x kUnroll gathers of a step before the
// first product, so loads overlap.  The wrapper
// (ops/kernels/feature_warp.py::launch_config) chooses the block size and
// the group size from the shape: many small groups where the map is small,
// one group of all channels where the pixels alone fill the card, so each
// input byte is read about once (L1/L2 serve the four taps' reuse) and the
// flow once per group.  Only group 0 writes the mask.  Pixels are indexed
// flat over the plane, so ragged widths (39, 78, 311) need no tail path.
// bf16 maps (the bf16 forward) are read and written as bf16.  Every step's
// arithmetic is warp_common.cuh's, so output and mask stay bit-equal to the
// plain version.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kUnroll = 4;  // channels whose gathers are issued together

// T is float or __nv_bfloat16: the map's type, read and written; the
// coordinates, weights and tap sum are fp32 either way.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
feature_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                    T* __restrict__ out, float* __restrict__ mask_out,
                    int C, int H, int W, float thr, int group) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  if (pix >= plane) return;
  const int y = pix / W;
  const int xx = pix - y * W;
  const float* fb = flow + static_cast<size_t>(b) * 2 * plane;
  const upflow::Taps t =
      upflow::bilinear_taps(fb[pix], fb[plane + pix], xx, y, H, W);
  const float m = t.wsum >= thr ? 1.0f : 0.0f;
  if (mask_out != nullptr && blockIdx.y == 0) mask_out[b * plane + pix] = m;
  const int c0 = blockIdx.y * group;
  const int c1 = min(C, c0 + group);
  const T* xb = x + (static_cast<size_t>(b) * C + c0) * plane;
  T* ob = out + (static_cast<size_t>(b) * C + c0) * plane + pix;
  for (int c = c0; c < c1; c += kUnroll) {
    float p[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* src = xb + static_cast<size_t>(c - c0 + u) * plane;
      const bool live = c + u < c1;
      p[u][0] = live && t.in00 ? upflow::ldg_f32(src + t.i00) : 0.0f;
      p[u][1] = live && t.in01 ? upflow::ldg_f32(src + t.i01) : 0.0f;
      p[u][2] = live && t.in10 ? upflow::ldg_f32(src + t.i10) : 0.0f;
      p[u][3] = live && t.in11 ? upflow::ldg_f32(src + t.i11) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u < c1) {
        upflow::store_f32(
            ob + static_cast<size_t>(c - c0 + u) * plane,
            __fmul_rn(upflow::tap_sum(p[u][0], p[u][1], p[u][2], p[u][3], t),
                      m));
      }
    }
  }
}

template <typename T>
int launch_feature_warp(const T* x, const float* flow, T* out,
                        float* mask_out, int B, int C, int H, int W,
                        float thr, int threads, int groups, int group,
                        void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (B == 0 || plane == 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || groups <= 0 || group <= 0 ||
      static_cast<long long>(groups) * group < C)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((plane + threads - 1) / threads),
                  groups, B);
  feature_warp_kernel<T><<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, flow, out, mask_out, C, H, W, thr, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, C, H, W) fp32, flow: (B, 2, H, W) fp32, out: (B, C, H, W),
// mask_out: (B, H, W) or null.  All contiguous on the current device.
// threads a block, and `groups` channel groups of `group` channels each
// (groups * group >= C), as ops/kernels/feature_warp.py::launch_config
// gives them.
extern "C" int upflow_feature_warp(const float* x, const float* flow,
                                   float* out, float* mask_out, int B, int C,
                                   int H, int W, float thr, int threads,
                                   int groups, int group, void* stream) {
  return launch_feature_warp(x, flow, out, mask_out, B, C, H, W, thr,
                             threads, groups, group, stream);
}

// The same with x and out in bf16: each output value is the fp32 result
// rounded to nearest even.
extern "C" int upflow_feature_warp_bf16(const __nv_bfloat16* x,
                                        const float* flow, __nv_bfloat16* out,
                                        float* mask_out, int B, int C, int H,
                                        int W, float thr, int threads,
                                        int groups, int group, void* stream) {
  return launch_feature_warp(x, flow, out, mask_out, B, C, H, W, thr,
                             threads, groups, group, stream);
}
