// 81-tap cost-volume correlation for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/correlation.py
// (_corr_fwd_pallas, _corr_kernel): out[k] = (1/C) sum_c f1 * f2(shift k),
// zero outside the image; the caller applies the LeakyReLU.
//
// Bound on the H100: latency on the main path.  It runs at decode level 0
// (B=4, C=196, 6 x 20: 0.75 MB in, 0.16 MB out, a 0.27 us byte bound),
// where one tile a batch item gives 4 blocks for 132 SMs.  Design: the
// body of corr_norm.cu (corr_tile.cuh) without the affine and the
// LeakyReLU, so the channels of a tile are split over a thread-block
// cluster and reduced in rank order through distributed shared memory,
// and the grid comes from ops/kernels/corr_norm.py::launch_config.  fp32
// maps are multiplied straight from the cp.async stages (the copies
// zero-fill outside the image); bf16 maps are widened in one shared-memory
// pass.  The TPU design's K row-shifted copies of f2 (built because Mosaic
// rejected dynamic sublane slices) are gone: shared memory takes any
// offset.
#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

template <typename T, int TH, int TW, bool VEC>
__global__ void __launch_bounds__(upflow::corr::Tile<TH, TW>::kThreads,
                                  upflow::corr::Tile<TH, TW>::kMinBlocks)
corr_plain_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                  const float* __restrict__ aff, float* __restrict__ out,
                  int C, int H, int W, float slope, int ks, int vec_out) {
  upflow::corr::corr_tile<T, TH, TW, VEC, false>(f1, f2, aff, out, C, H, W,
                                                 slope, ks, vec_out);
}

struct PlainKernels {
  template <typename T, int TH, int TW, bool VEC>
  static auto get() {
    return &corr_plain_kernel<T, TH, TW, VEC>;
  }
};

}  // namespace

// f1, f2: (B, C, H, W) fp32; out: (B, 81, H, W).  Contiguous, current
// device.  th, tw, ks and vec as for upflow_corr_norm.
extern "C" int upflow_correlation(const float* f1, const float* f2,
                                  float* out, int B, int C, int H, int W,
                                  int th, int tw, int ks, int vec,
                                  void* stream) {
  return upflow::corr::launch<PlainKernels, false>(
      f1, f2, nullptr, out, B, C, H, W, 1.0f, th, tw, ks, vec, stream);
}

// The same with bf16 maps, each 4-byte aligned (8-byte with vec): fp32
// arithmetic, fp32 out.
extern "C" int upflow_correlation_bf16(const __nv_bfloat16* f1,
                                       const __nv_bfloat16* f2, float* out,
                                       int B, int C, int H, int W, int th,
                                       int tw, int ks, int vec,
                                       void* stream) {
  return upflow::corr::launch<PlainKernels, false>(
      f1, f2, nullptr, out, B, C, H, W, 1.0f, th, tw, ks, vec, stream);
}
