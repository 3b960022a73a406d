// Normalised 81-tap correlation + LeakyReLU for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/corr_norm.py
// (corr_norm_window_pallas, _corr_norm_kernel):
//   out = leaky(corr((f1 - m1) * rstd1, mask0((f2 - m2) * rstd2)))
// where mask0 zeroes taps outside the image after the affine and m, rstd
// are per-(b, c) moments reduced in torch beforehand.
//
// Bound on the H100: bytes.  At decode level 4 (B=4, C=32, 96 x 320) it
// moves 2 x 15.7 MB in and 39.8 MB out for ~0.64 GFLOP, ~9 operations
// per byte, below the ~20 at which fp32 compute would limit.  Design:
// the correlation body (corr_body.cuh) with the affine applied while
// staging into shared memory and the LeakyReLU in the epilogue, so the
// normalised maps never reach device memory.  The TPU design's aligned
// 8-row window pair, scalar-prefetched affine and iota validity masks are
// gone: the block computes its own halo bounds.
#include "corr_body.cuh"

// f1, f2: (B, C, H, W) fp32; aff: (B, 4, C) fp32 rows m1, rstd1, m2,
// rstd2; out: (B, 81, H, W).  Contiguous, current device.
extern "C" int upflow_corr_norm(const float* f1, const float* f2,
                                const float* aff, float* out, int B, int C,
                                int H, int W, float slope, void* stream) {
  return upflow::launch_corr<true>(f1, f2, aff, out, B, C, H, W, slope,
                                   stream);
}

// The same with bf16 maps: the affine and everything after it in fp32.
extern "C" int upflow_corr_norm_bf16(const __nv_bfloat16* f1,
                                     const __nv_bfloat16* f2,
                                     const float* aff, float* out, int B,
                                     int C, int H, int W, float slope,
                                     void* stream) {
  return upflow::launch_corr<true>(f1, f2, aff, out, B, C, H, W, slope,
                                   stream);
}
