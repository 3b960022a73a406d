// Normalised 81-tap correlation + LeakyReLU for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/corr_norm.py
// (corr_norm_window_pallas, _corr_norm_kernel):
//   out = leaky(corr((f1 - m1) * rstd1, mask0((f2 - m2) * rstd2)))
//   out[b, k, y, x] = (1/C) sum_c f1n[b, c, y, x] * f2n[b, c, y+dy, x+dx]
//   k = (dy+4)*9 + (dx+4),  dy, dx in [-4, 4]
// where mask0 zeroes taps outside the image after the affine and m, rstd
// are per-(b, c) moments reduced in torch beforehand.
//
// The body, its bound on the H100 and its design are corr_tile.cuh's,
// with the affine and the LeakyReLU (AFF); correlation.cu runs the same
// body without them.
#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

template <typename T, int TH, int TW, bool VEC>
__global__ void __launch_bounds__(upflow::corr::Tile<TH, TW>::kThreads,
                                  upflow::corr::Tile<TH, TW>::kMinBlocks)
corr_norm_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                 const float* __restrict__ aff, float* __restrict__ out,
                 int C, int H, int W, float slope, int ks, int vec_out) {
  upflow::corr::corr_tile<T, TH, TW, VEC, true>(f1, f2, aff, out, C, H, W,
                                                slope, ks, vec_out);
}

struct NormKernels {
  template <typename T, int TH, int TW, bool VEC>
  static auto get() {
    return &corr_norm_kernel<T, TH, TW, VEC>;
  }
};

}  // namespace

// f1, f2: (B, C, H, W) fp32; aff: (B, 4, C) fp32 rows m1, rstd1, m2,
// rstd2; out: (B, 81, H, W).  Contiguous, current device.  th x tw: the
// tile (8, 4 or 1 x 32, or 1 x 16); ks: blocks of a cluster splitting the
// channels (1-16); vec: stage 4-pixel slots by 16-byte copies (W a
// multiple of 4, both maps 16-byte aligned), else 4-byte words; as
// ops/kernels/correlation.py's launch_config and staging_route give them.
extern "C" int upflow_corr_norm(const float* f1, const float* f2,
                                const float* aff, float* out, int B, int C,
                                int H, int W, float slope, int th, int tw,
                                int ks, int vec, void* stream) {
  return upflow::corr::launch<NormKernels, true>(
      f1, f2, aff, out, B, C, H, W, slope, th, tw, ks, vec, stream);
}

// The same with bf16 maps, each 4-byte aligned (8-byte with vec, which
// copies 8 bytes a slot): the affine and everything after it in fp32.
extern "C" int upflow_corr_norm_bf16(const __nv_bfloat16* f1,
                                     const __nv_bfloat16* f2,
                                     const float* aff, float* out, int B,
                                     int C, int H, int W, float slope, int th,
                                     int tw, int ks, int vec, void* stream) {
  return upflow::corr::launch<NormKernels, true>(
      f1, f2, aff, out, B, C, H, W, slope, th, tw, ks, vec, stream);
}
