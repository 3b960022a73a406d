// SGU blend at the decode levels for Hopper, both directions of a level in
// one launch:
//     out_d = warp(flow_d, inter_flow_d) * (1 - m_d) + flow_d * m_d
// with warp = tools.torch_warp (zero-padded bilinear, no mask) and, for
// the SGU estimator's raw (B, 3, H, W) head x_d, inter_flow_d = x_d[:, :2]
// and m_d = sigmoid(x_d[:, 2:3]).
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/blend.py
// (sgu_blend_pallas, the +-2 px fused tier) and, with it, the medium tier
// of ops/warp.py::_sgu_blend_tpu_impl (the windowed planar warp of
// ops/pallas/warp.py::_window_warp_resident) and its XLA gather fallback.
//
// Bound on the H100: bytes, and at the coarse levels the launch.  Per pixel
// and direction it reads the flow (8 B), the head (12 B fp32, 6 B bf16)
// and writes 8 B, plus 2 x 4 taps of the flow planes that a smooth
// inter-flow takes from cache lines the row already holds.  At B=4
// 384x1280 a forward's four levels move 9.2 MB (2.7 us at HBM rate), 6.9
// MB of it at level 4; levels 1-3 move at most 1.7 MB each, so a launch's
// own latency sets their time.  Design:
// - one launch a level: the direction is folded into blockIdx.z, so the
//   two directions' pixels share one grid and one launch;
// - the head is read in place, fp32 or bf16 (widened in registers, which
//   is exact), with its batch stride: no slice copy, no separate sigmoid,
//   no cast kernel;
// - 2-D blocks of 32 x R threads; at level 4, where the bytes set the
//   time, 2 pixels a thread with 8-byte loads and stores (even W, aligned
//   pointers), so a warp reads 256 contiguous bytes of each plane; on the
//   smaller levels one pixel a thread, whose shorter chain ends sooner.
//   The wrapper (ops/kernels/sgu_blend.py::launch_config) chooses both,
//   and R to give every SM a block where the pixels allow it and no more.
// Every step is a correctly rounded intrinsic in the plain version's op
// order, so kernel and plain version agree bit for bit: the warp as
// warp_common.cuh computes it, the sigmoid as torch.sigmoid computes it on
// CUDA (1 / (1 + exp(-x)) in fp32: the accurate expf, an IEEE add and
// division; no fast math), 1 - m and the blend in upflow::blend's order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kMaxRows = 8;

// One direction's tensors; the head's two planes (inter-flow, mask) are
// addressed separately, so a raw head (mask = its third channel, a logit)
// and a given inter-flow and mask are read by the same code.
struct Direction {
  const float* flow;   // (B, 2, H, W)
  const void* iflow;   // inter-flow planes u, v; batch stride iflow_bstride
  const void* mask;    // mask plane; batch stride mask_bstride
  float* out;          // (B, 2, H, W)
};

__device__ __forceinline__ void ldg2(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
// two bf16 values in one 4-byte load, widened exactly (little endian: the
// first value is the low half)
__device__ __forceinline__ void ldg2(const __nv_bfloat16* p, float& a,
                                     float& b) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}

// torch.sigmoid on CUDA in fp32: one / (one + std::exp(-a))
__device__ __forceinline__ float sigmoid_rn(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

template <typename T, bool kLogit, int kPix>
__global__ void __launch_bounds__(kBlockX * kMaxRows)
sgu_blend_kernel(Direction d0, Direction d1, long long iflow_bstride,
                 long long mask_bstride, int B, int H, int W) {
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = (blockIdx.x * kBlockX + threadIdx.x) * kPix;
  if (y >= H || x >= W) return;
  const int dir = blockIdx.z >= static_cast<unsigned>(B);
  const int b = blockIdx.z - dir * B;
  const Direction d = dir ? d1 : d0;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y) * W + x;
  const float* fb = d.flow + static_cast<size_t>(b) * 2 * plane;
  const T* ib = static_cast<const T*>(d.iflow) + b * iflow_bstride;
  const T* mb = static_cast<const T*>(d.mask) + b * mask_bstride;
  float* ob = d.out + static_cast<size_t>(b) * 2 * plane;
  float iu[kPix], iv[kPix], m[kPix], fu[kPix], fv[kPix];
  if constexpr (kPix == 2) {
    ldg2(ib + pix, iu[0], iu[1]);
    ldg2(ib + plane + pix, iv[0], iv[1]);
    ldg2(mb + pix, m[0], m[1]);
    ldg2(fb + pix, fu[0], fu[1]);
    ldg2(fb + plane + pix, fv[0], fv[1]);
  } else {
    iu[0] = upflow::ldg_f32(ib + pix);
    iv[0] = upflow::ldg_f32(ib + plane + pix);
    m[0] = upflow::ldg_f32(mb + pix);
    fu[0] = __ldg(fb + pix);
    fv[0] = __ldg(fb + plane + pix);
  }
  float ou[kPix], ov[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const upflow::Taps t = upflow::bilinear_taps(iu[p], iv[p], x + p, y, H, W);
    const float mp = kLogit ? sigmoid_rn(m[p]) : m[p];
    ou[p] = upflow::blend(upflow::sample_plane(fb, t), fu[p], mp);
    ov[p] = upflow::blend(upflow::sample_plane(fb + plane, t), fv[p], mp);
  }
  if constexpr (kPix == 2) {
    *reinterpret_cast<float2*>(ob + pix) = make_float2(ou[0], ou[1]);
    *reinterpret_cast<float2*>(ob + plane + pix) = make_float2(ov[0], ov[1]);
  } else {
    ob[pix] = ou[0];
    ob[plane + pix] = ov[0];
  }
}

template <typename T, bool kLogit>
void launch_typed(const Direction& d0, const Direction& d1, int ndir,
                  long long iflow_bstride, long long mask_bstride, int B,
                  int H, int W, int pix, int rows, cudaStream_t stream) {
  const int cols = kBlockX * pix;
  const dim3 grid((W + cols - 1) / cols, (H + rows - 1) / rows, ndir * B);
  const dim3 block(kBlockX, rows);
  if (pix == 2) {
    sgu_blend_kernel<T, kLogit, 2><<<grid, block, 0, stream>>>(
        d0, d1, iflow_bstride, mask_bstride, B, H, W);
  } else {
    sgu_blend_kernel<T, kLogit, 1><<<grid, block, 0, stream>>>(
        d0, d1, iflow_bstride, mask_bstride, B, H, W);
  }
}

}  // namespace

// ndir (1 or 2) directions of one level, each flow_d / out_d (B, 2, H, W)
// fp32 contiguous, inter-flow planes iflow_d and mask plane mask_d fp32 or
// bf16 (head_bf16), each batch item contiguous, with the batch strides
// given in elements.  logit: the mask plane holds logits (the raw head),
// else the mask itself.  pix: pixels a thread (2 needs an even W, 8-byte
// aligned flows and 2-element aligned head planes and strides); rows:
// block rows, 1..8.  Returns the launch's CUDA error code.
extern "C" int upflow_sgu_blend(const float* flow0, const void* iflow0,
                                const void* mask0, float* out0,
                                const float* flow1, const void* iflow1,
                                const void* mask1, float* out1, int ndir,
                                long long iflow_bstride,
                                long long mask_bstride, int B, int H, int W,
                                int head_bf16, int logit, int pix, int rows,
                                void* stream) {
  if (ndir < 1 || ndir > 2 || (pix != 1 && pix != 2) ||
      (pix == 2 && W % 2 != 0) || rows < 1 || rows > kMaxRows ||
      static_cast<long long>(ndir) * B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const Direction d0{flow0, iflow0, mask0, out0};
  const Direction d1{flow1, iflow1, mask1, out1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_bf16) {
    if (logit)
      launch_typed<__nv_bfloat16, true>(d0, d1, ndir, iflow_bstride,
                                        mask_bstride, B, H, W, pix, rows, s);
    else
      launch_typed<__nv_bfloat16, false>(d0, d1, ndir, iflow_bstride,
                                         mask_bstride, B, H, W, pix, rows, s);
  } else {
    if (logit)
      launch_typed<float, true>(d0, d1, ndir, iflow_bstride, mask_bstride, B,
                                H, W, pix, rows, s);
    else
      launch_typed<float, false>(d0, d1, ndir, iflow_bstride, mask_bstride,
                                 B, H, W, pix, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}
