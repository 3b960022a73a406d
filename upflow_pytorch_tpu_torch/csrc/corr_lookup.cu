// RAFT's correlation lookup (CorrBlock.__call__ of princeton-vl/RAFT
// core/corr.py) for Hopper.
//
// Replaces no TPU kernel: the JAX package runs UPFlow alone.  It was added
// for RAFT (models/raft.py), whose every update iteration samples each
// pixel's own rows of the all-pairs volume: for pixel p at coords1 = (x, y)
// and pyramid level l (the volume average-pooled l times over the second
// frame's pixels), the 9 x 9 window of bilinear samples at
// (x / 2^l + dx, y / 2^l + dy), dx, dy in -4..4, zero outside the level
// (grid_sample, align_corners=True, zero padding).  The 4 x 81 = 324
// values go out as the channels of an NCHW map, channel l * 81 + i * 9 + j
// for dx = i - 4, dy = j - 4: corr.py's meshgrid(dy, dx) puts the x offset
// on the slow axis, and published checkpoints' convc1 reads that order.
//
// Bound on the H100: bytes.  Each pixel reads a 10 x 10 footprint of each
// level's row (all 81 taps of a level share one fractional offset, so the
// window's 4 corners fall on 10 x 10 samples), 1,600 bytes of fp32 for
// the 4 levels, and writes 324 outputs, for 7 operations a tap.  At
// KITTI's 47 x 156 grid and both directions that is 23 MB read and 9.5 MB
// written (bf16) an iteration, about 10 us at 3.35 TB/s.
// Design: one block owns 32 neighbouring pixels of one row at one level.
// Its threads first gather the 32 footprints into shared memory (each
// footprint row is 10 contiguous floats, so neighbouring threads read
// neighbouring addresses), then each warp computes one tap for the 32
// pixels from shared memory and writes them as one coalesced row of the
// output channel.  A pixel's footprint is padded to 101 floats, so the 32
// lanes reading 32 pixels' same sample hit 32 different banks.  Every
// pixel's coordinates and fractional offsets are computed once per level.
// Coordinates whose magnitude reaches 2^20 (or that are not finite) sample
// nothing, as grid_sample finds every tap outside the level.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPix = 32;       // pixels of a block: one output row segment
constexpr int kThreads = 256;  // eight warps
constexpr int kRadius = 4;
constexpr int kSide = 2 * kRadius + 1;       // 9 taps a side
constexpr int kFoot = kSide + 1;             // 10 samples a side
constexpr int kFootPitch = kFoot * kFoot + 1;  // 101: no bank conflicts
constexpr int kTaps = kSide * kSide;         // 81 a level
constexpr int kLevels = 4;
constexpr float kFar = 1048576.0f;  // 2^20: beyond it nothing is sampled

struct Levels {
  const float* vol[kLevels];  // each (N * H * W, h_l, w_l) fp32
  int h[kLevels];
  int w[kLevels];
};

__device__ __forceinline__ void store(float* out, size_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// Grid (ceil(W / 32), H, N * 4): blockIdx.z = n * 4 + level.
template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   T* __restrict__ out, int H, int W) {
  __shared__ float foot[kPix * kFootPitch];
  __shared__ float frac_x[kPix], frac_y[kPix];
  __shared__ int left[kPix], top[kPix];
  const int level = blockIdx.z % kLevels;
  const int n = blockIdx.z / kLevels;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kPix;
  const int t = threadIdx.x;
  const int hl = lv.h[level], wl = lv.w[level];
  const size_t plane = static_cast<size_t>(H) * W;
  const int npix = min(kPix, W - x0);

  if (t < kPix) {
    float cx = -kFar, cy = -kFar;
    if (t < npix) {
      const size_t pix = static_cast<size_t>(y) * W + x0 + t;
      const float* c = coords + static_cast<size_t>(n) * 2 * plane;
      // the level's coordinates: a division by 2^level, exact
      const float scale = 1.0f / static_cast<float>(1 << level);
      cx = __ldg(c + pix) * scale;
      cy = __ldg(c + plane + pix) * scale;
    }
    if (!(fabsf(cx) < kFar && fabsf(cy) < kFar)) cx = cy = -kFar;
    const float fx = floorf(cx), fy = floorf(cy);
    frac_x[t] = cx - fx;
    frac_y[t] = cy - fy;
    left[t] = static_cast<int>(fx) - kRadius;
    top[t] = static_cast<int>(fy) - kRadius;
  }
  __syncthreads();

  // the footprints: sample (r, c) of pixel p at (top + r, left + c)
  const float* vol = lv.vol[level];
  const size_t row0 = (static_cast<size_t>(n) * H + y) * W + x0;
  const size_t per_row = static_cast<size_t>(hl) * wl;
  for (int i = t; i < kPix * kFoot * kFoot; i += kThreads) {
    const int p = i / (kFoot * kFoot);
    const int rc = i - p * (kFoot * kFoot);
    const int r = rc / kFoot, c = rc - r * kFoot;
    float v = 0.0f;
    if (p < npix) {
      const int yy = top[p] + r, xx = left[p] + c;
      if (yy >= 0 && yy < hl && xx >= 0 && xx < wl)
        v = __ldg(vol + (row0 + p) * per_row + static_cast<size_t>(yy) * wl +
                  xx);
    }
    foot[p * kFootPitch + rc] = v;
  }
  __syncthreads();

  // tap k = i * 9 + j: x offset i - 4 (footprint column i), y offset j - 4
  // (footprint row j); lane p is the block's pixel p
  const int lane = t % kPix;
  if (lane >= npix) return;
  const float wx1 = frac_x[lane], wy1 = frac_y[lane];
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  const float* f = foot + lane * kFootPitch;
  T* o = out + (static_cast<size_t>(n) * kLevels * kTaps + level * kTaps) *
                   plane + static_cast<size_t>(y) * W + x0 + lane;
  for (int k = t / kPix; k < kTaps; k += kThreads / kPix) {
    const int i = k / kSide, j = k - i * kSide;
    const float* s = f + j * kFoot + i;
    const float v = wy0 * (wx0 * s[0] + wx1 * s[1]) +
                    wy1 * (wx0 * s[kFoot] + wx1 * s[kFoot + 1]);
    store(o, static_cast<size_t>(k) * plane, v);
  }
}

}  // namespace

// vol0..vol3: the pyramid's levels, each (N * H * W, h_l, w_l) fp32
// contiguous; coords: (N, 2, H, W) fp32, x then y, in level-0 pixels;
// out: (N, 324, H, W), bf16 when out_bf16 else fp32.  All on the current
// device.
extern "C" int upflow_corr_lookup(const float* vol0, const float* vol1,
                                  const float* vol2, const float* vol3,
                                  int h0, int w0, int h1, int w1, int h2,
                                  int w2, int h3, int w3,
                                  const float* coords, void* out,
                                  int out_bf16, int N, int H, int W,
                                  void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N * kLevels > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {{vol0, vol1, vol2, vol3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const dim3 grid((W + kPix - 1) / kPix, H, N * kLevels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    corr_lookup_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        lv, coords, static_cast<__nv_bfloat16*>(out), H, W);
  else
    corr_lookup_kernel<float><<<grid, kThreads, 0, s>>>(
        lv, coords, static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
