// 81-tap local correlation body shared by correlation.cu (plain cost
// volume) and corr_norm.cu (normalised cost volume + LeakyReLU).
//
//   out[b, k, y, x] = (1/C) * sum_c f1n[b, c, y, x] * f2n[b, c, y+dy, x+dx]
//   k = (dy+4)*9 + (dx+4),  dy, dx in [-4, 4],  f2n = 0 outside the image.
//
// With NORM the prologue applies the per-(b, c) affine (f - m) * rstd to
// both maps while staging them in shared memory, zeroes out-of-image taps
// AFTER the affine (as the oracle zero-pads the normalised map), and the
// epilogue applies LeakyReLU.
//
// The maps are fp32 or bf16 (T); a bf16 value is widened to fp32 as it is
// staged, and everything after that is fp32, so the bf16 path computes
// what the fp32 path computes on the widened maps.
//
// Layout: NCHW in, NCHW (B, 81, H, W) out.  A block owns an 8 x 32 pixel
// tile.  Its threads are (32, 8, 3): one thread per output pixel and per
// third of the 81 taps (3 displacement rows, 27 accumulators), which keeps
// registers low.  Channels go through shared memory in chunks of 8: the
// f1 tile and the f2 tile with its +-4 halo, so each f2 value read from
// device memory serves up to 81 products.
#pragma once

#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace upflow {

constexpr int kDisp = 4;
constexpr int kTaps1d = 2 * kDisp + 1;  // 9
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kGroups = 3;              // thread groups over tap rows
constexpr int kRowsPerGroup = kTaps1d / kGroups;
constexpr int kChunk = 8;               // channels staged per pass
constexpr int kHaloW = kTileW + 2 * kDisp;
constexpr int kHaloH = kTileH + 2 * kDisp;
constexpr int kCorrThreads = kTileW * kTileH * kGroups;

template <bool NORM, typename T>
__global__ void __launch_bounds__(kCorrThreads)
corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
            const float* __restrict__ aff, float* __restrict__ out, int C,
            int H, int W, float slope) {
  __shared__ float s1[kChunk][kTileH][kTileW];
  __shared__ float s2[kChunk][kHaloH][kHaloW];
  const int tx = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = (g * kTileH + ty) * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const T* f2b = f2 + static_cast<size_t>(b) * C * plane;
  // aff rows per batch item: m1, rstd1, m2, rstd2, each of length C
  const float* ab = NORM ? aff + static_cast<size_t>(b) * 4 * C : nullptr;

  float acc[kRowsPerGroup][kTaps1d];
#pragma unroll
  for (int r = 0; r < kRowsPerGroup; ++r)
#pragma unroll
    for (int k = 0; k < kTaps1d; ++k) acc[r][k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < kChunk * kTileH * kTileW; i += kCorrThreads) {
      const int cc = i / (kTileH * kTileW);
      const int r = (i / kTileW) % kTileH;
      const int col = i % kTileW;
      const int c = c0 + cc, yy = y0 + r, xx = x0 + col;
      float v = 0.0f;
      if (c < C && yy < H && xx < W) {
        v = to_f32(f1b[c * plane + yy * W + xx]);
        if (NORM) v = __fmul_rn(__fsub_rn(v, ab[c]), ab[C + c]);
      }
      s1[cc][r][col] = v;
    }
    for (int i = tid; i < kChunk * kHaloH * kHaloW; i += kCorrThreads) {
      const int cc = i / (kHaloH * kHaloW);
      const int r = (i / kHaloW) % kHaloH;
      const int col = i % kHaloW;
      const int c = c0 + cc, yy = y0 + r - kDisp, xx = x0 + col - kDisp;
      float v = 0.0f;
      if (c < C && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        v = to_f32(f2b[c * plane + yy * W + xx]);
        if (NORM) v = __fmul_rn(__fsub_rn(v, ab[2 * C + c]), ab[3 * C + c]);
      }
      s2[cc][r][col] = v;
    }
    __syncthreads();
    const int n = min(kChunk, C - c0);
    for (int cc = 0; cc < n; ++cc) {
      const float a = s1[cc][ty][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r)
#pragma unroll
        for (int k = 0; k < kTaps1d; ++k)
          acc[r][k] += a * s2[cc][ty + g * kRowsPerGroup + r][tx + k];
    }
  }

  const int yy = y0 + ty, xx = x0 + tx;
  if (yy >= H || xx >= W) return;
  const float fc = static_cast<float>(C);
  float* ob = out + static_cast<size_t>(b) * kTaps1d * kTaps1d * plane +
              yy * W + xx;
#pragma unroll
  for (int r = 0; r < kRowsPerGroup; ++r)
#pragma unroll
    for (int k = 0; k < kTaps1d; ++k) {
      float v = __fdiv_rn(acc[r][k], fc);
      if (NORM) v = v > 0.0f ? v : __fmul_rn(v, slope);
      ob[((g * kRowsPerGroup + r) * kTaps1d + k) * plane] = v;
    }
}

template <bool NORM, typename T>
int launch_corr(const T* f1, const T* f2, const float* aff,
                float* out, int B, int C, int H, int W, float slope,
                void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(kTileW, kTileH, kGroups);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  corr_kernel<NORM, T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f1, f2, aff, out, C, H, W, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace upflow
