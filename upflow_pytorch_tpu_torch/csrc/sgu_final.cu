// Final SGU stage for Hopper: for one direction, from the quarter-
// resolution flow fq (B, 2, Hq, Wq), SGU head output xo (B, 3, Hq, Wq)
// and mask mq = sigmoid(xo[:, 2]) (B, 1, Hq, Wq),
//     flow  = upsample2d_flow_as(fq, (H, W), if_rate=True)
//     iflow = upsample2d_flow_as(xo[:, :2], (H, W), if_rate=True)
//     m     = upsample2d_as(mq, (H, W))
//     out   = warp(flow, iflow) * (1 - m) + flow * m
// with the align_corners=True bilinear resize and warp = tools.torch_warp.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/sgu_final.py
// (sgu_final_pallas, the +-2 px fused tier) and, with it, the medium tier
// of models/upflow.py::_sgu_final_op_impl (planar resizes and the windowed
// warp of ops/pallas/warp.py::_window_warp_resident) and its XLA fallback.
//
// Bound on the H100: bytes.  It writes 2 full-resolution planes and reads
// 5 quarter-resolution ones: at B=4, 384x1280 that is 15.7 + 2.5 MB, a
// bound of about 5.4 us.  Design: one thread per full-resolution output
// pixel, and no full-resolution intermediate in device memory.  Each value
// of the upsampled flow, inter-flow and mask is computed where it is used
// from four quarter-resolution reads (rows first, then columns, with the
// fp32 indices and weights of ops/resize.py's interpolation matrices,
// passed as small tables); the warp's four taps of the upsampled flow are
// each recomputed the same way.  The quarter-resolution planes (0.5 MB
// each at B=4) stay in L2 and are read through __ldg, with no window, so
// every inter-flow magnitude is served: the TPU's tiers, its extended
// patches and its lax.cond are gone.  The rate scales multiply after the
// resize, as upsample2d_flow_as does, and every step is a correctly
// rounded intrinsic in the plain version's op order.  Each two-tap lerp
// rounds as the plain version's matrix product accumulates over the
// source index (w0*a rounded, then one fma of w1*b), because the warp
// turns an ulp of a sample coordinate into ulp x the flow's slope, which
// is steep where a sample leaves the image.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

// One output index of a resize: the two source indices and their weights.
struct Lerp {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Lerp lerp_at(const int* __restrict__ idx,
                                        const float* __restrict__ wt, int o) {
  return Lerp{__ldg(idx + 2 * o), __ldg(idx + 2 * o + 1), __ldg(wt + 2 * o),
              __ldg(wt + 2 * o + 1)};
}

// w0*a + w1*b rounded as a matrix product accumulates it: the first term
// rounded, the second added by one fused multiply-add.
__device__ __forceinline__ float mix(float a, float b, const Lerp& l) {
  return __fmaf_rn(l.w1, b, __fmul_rn(l.w0, a));
}

// The resized (wq-wide) plane q at the output row and column given by
// (r, c): rows first, then columns.
__device__ __forceinline__ float upsample_at(const float* __restrict__ q,
                                             int wq, const Lerp& r,
                                             const Lerp& c) {
  const float* q0 = q + r.i0 * wq;
  const float* q1 = q + r.i1 * wq;
  return mix(mix(__ldg(q0 + c.i0), __ldg(q1 + c.i0), r),
             mix(__ldg(q0 + c.i1), __ldg(q1 + c.i1), r), c);
}

__global__ void __launch_bounds__(kThreads)
sgu_final_kernel(const float* __restrict__ fq, const float* __restrict__ xo,
                 const float* __restrict__ mq, const int* __restrict__ row_idx,
                 const float* __restrict__ row_wt,
                 const int* __restrict__ col_idx,
                 const float* __restrict__ col_wt, float* __restrict__ out,
                 int Hq, int Wq, int H, int W, float su, float sv) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  if (pix >= plane) return;
  const int y = pix / W;
  const int x = pix - y * W;
  const size_t pq = static_cast<size_t>(Hq) * Wq;
  const float* up = fq + static_cast<size_t>(b) * 2 * pq;
  const float* vp = up + pq;
  const float* iup = xo + static_cast<size_t>(b) * 3 * pq;
  const float* ivp = iup + pq;
  const Lerp ry = lerp_at(row_idx, row_wt, y);
  const Lerp cx = lerp_at(col_idx, col_wt, x);
  const float iu = __fmul_rn(upsample_at(iup, Wq, ry, cx), su);
  const float iv = __fmul_rn(upsample_at(ivp, Wq, ry, cx), sv);
  const float m = upsample_at(mq + b * pq, Wq, ry, cx);
  const upflow::Taps t = upflow::bilinear_taps(iu, iv, x, y, H, W);
  const Lerp r0 = lerp_at(row_idx, row_wt, t.yi);
  const Lerp r1 = lerp_at(row_idx, row_wt, t.yj);
  const Lerp c0 = lerp_at(col_idx, col_wt, t.xi);
  const Lerp c1 = lerp_at(col_idx, col_wt, t.xj);
  const float* planes[2] = {up, vp};
  const float scales[2] = {su, sv};
  float* ob = out + static_cast<size_t>(b) * 2 * plane;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* q = planes[c];
    const float s = scales[c];
    const float p00 = t.in00 ? __fmul_rn(upsample_at(q, Wq, r0, c0), s) : 0.0f;
    const float p01 = t.in01 ? __fmul_rn(upsample_at(q, Wq, r0, c1), s) : 0.0f;
    const float p10 = t.in10 ? __fmul_rn(upsample_at(q, Wq, r1, c0), s) : 0.0f;
    const float p11 = t.in11 ? __fmul_rn(upsample_at(q, Wq, r1, c1), s) : 0.0f;
    const float own = __fmul_rn(upsample_at(q, Wq, ry, cx), s);
    ob[c * plane + pix] =
        upflow::blend(upflow::tap_sum(p00, p01, p10, p11, t), own, m);
  }
}

}  // namespace

// fq: (B, 2, Hq, Wq), xo: (B, 3, Hq, Wq), mq: (B, 1, Hq, Wq) fp32;
// row_idx/row_wt: (H, 2) int32/fp32 and col_idx/col_wt: (W, 2), the
// resize's source indices and weights per output row and column;
// su = W / Wq, sv = H / Hq in fp32; out: (B, 2, H, W).  All contiguous on
// the current device.
extern "C" int upflow_sgu_final(const float* fq, const float* xo,
                                const float* mq, const int* row_idx,
                                const float* row_wt, const int* col_idx,
                                const float* col_wt, float* out, int B, int Hq,
                                int Wq, int H, int W, float su, float sv,
                                void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (B == 0 || plane == 0) return 0;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), B);
  sgu_final_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fq, xo, mq, row_idx, row_wt, col_idx, col_wt, out, Hq, Wq, H, W, su, sv);
  return static_cast<int>(cudaGetLastError());
}
