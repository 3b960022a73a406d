// 81-tap cost-volume correlation for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/correlation.py
// (_corr_fwd_pallas, _corr_kernel): out[k] = (1/C) sum_c f1 * f2(shift k),
// zero outside the image; the caller applies the LeakyReLU.
//
// Bound on the H100: bytes.  2*81*C operations per output pixel against
// (2C + 81) * 4 bytes of traffic is ~17 operations per byte at C = 196
// (decode level 0), just below the ~20 fp32 operations per byte at which
// the card's compute would limit.  Design (corr_body.cuh): shared-memory
// tiles of f1 and of
// f2 with its +-4 halo, one channel chunk at a time, so every input byte
// is read from device memory about once and each output once.  The TPU
// design's K row-shifted copies of f2 (built because Mosaic rejected
// dynamic sublane slices) are gone: shared memory takes any offset.
#include "corr_body.cuh"

// f1, f2: (B, C, H, W) fp32; out: (B, 81, H, W).  Contiguous, current device.
extern "C" int upflow_correlation(const float* f1, const float* f2,
                                  float* out, int B, int C, int H, int W,
                                  void* stream) {
  return upflow::launch_corr<false>(f1, f2, nullptr, out, B, C, H, W, 0.0f,
                                    stream);
}

// The same with bf16 maps (fp32 arithmetic, fp32 out).
extern "C" int upflow_correlation_bf16(const __nv_bfloat16* f1,
                                       const __nv_bfloat16* f2, float* out,
                                       int B, int C, int H, int W,
                                       void* stream) {
  return upflow::launch_corr<false>(f1, f2, nullptr, out, B, C, H, W, 0.0f,
                                    stream);
}
