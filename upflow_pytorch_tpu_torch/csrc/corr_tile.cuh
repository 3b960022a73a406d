// The 81-tap correlation body shared by corr_norm.cu (normalised cost
// volume + LeakyReLU) and correlation.cu (plain cost volume):
//
//   out[b, k, y, x] = (1/C) sum_c g1[b, c, y, x] * g2[b, c, y+dy, x+dx]
//   k = (dy+4)*9 + (dx+4),  dy, dx in [-4, 4],  g2 = 0 outside the image,
//
// with g = (f - m) * rstd per (b, c) and a LeakyReLU after the sum when
// AFF, and g = f (widened to fp32) otherwise.
//
// Bound on the H100: bytes at the fine levels (at decode level 4, B=4,
// C=32, 96 x 320, it moves 2 x 15.7 MB in and 39.8 MB out for ~0.64 GFLOP),
// latency at the coarse ones (12 x 40 holds 480 pixels a batch item, 6 x
// 20 at level 0 holds 120).
// Design:
// - A block owns a TH x TW pixel tile (8, 4 or 1 x 32, or 1 x 16 where
//   32-column tiles leave SMs idle) and one range of the channels.  Its
//   threads are (TW / 4, TH, 9): each computes 4 adjacent
//   pixels of one row against one of the 9 tap rows, 36 accumulators fed
//   per channel by one 16-byte shared-memory load of f1 and three of f2
//   (12 values), so a value loaded serves 3 to 9 products.
// - Channels go through shared memory in chunks of 8, staged by cp.async
//   two chunks ahead of the one being multiplied (a ring of 3 stages).
//   Each thread copies the same 4-pixel slots of every chunk, whose
//   offsets and image bounds it computes once, so staging divides nothing.
//   Where rows are a multiple of 4 pixels and the maps aligned (the
//   384 x 1280 pyramid) a slot is one copy (16 bytes of fp32, 8 of bf16);
//   elsewhere (375 x 1242's widths 39, 78, 311) it is 4-byte copies of
//   the elements in the image (bf16: of the aligned words that hold them).
// - With AFF, or with bf16 maps, a shared-memory pass over the arrived
//   chunk applies the affine (__fsub_rn, __fmul_rn, from the block's
//   affine rows staged once) to each slot and zeroes every tap outside
//   the image AFTER it, as the oracle zero-pads the normalised map; bf16
//   values widen to fp32 there.  Plain fp32 maps need no pass: the copies
//   zero-fill every element outside the image, so the products read the
//   raw stage, and a chunk's stage is refilled only after the barrier that
//   follows its products.
// - On small maps a thread-block cluster of KS blocks (KS <= 16) shares a
//   tile and splits its channels; each block leaves its partial sums in
//   shared memory and, after a cluster barrier, sums 1/KS of the tile over
//   the KS blocks' shared memory in rank order.  The sum order is fixed,
//   so two calls give the same bits; no atomics, one launch.  More than 8
//   blocks is a non-portable cluster size, allowed per kernel and device.
// ops/kernels/correlation.py::launch_config picks the tile and KS from
// the shape.
// The TPU design's aligned 8-row window pair, scalar-prefetched affine and
// iota validity masks are gone: the block computes its own bounds.
#pragma once

#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"
#include "warp_common.cuh"

namespace upflow {
namespace corr {

namespace cg = cooperative_groups;

constexpr int kDisp = 4;
constexpr int kTaps = 2 * kDisp + 1;         // 9
constexpr int kPx = 4;                       // adjacent pixels of a thread
constexpr int kChunk = 8;                    // channels staged per pass
constexpr int kStages = 3;                   // raw stages: 2 chunks ahead
constexpr int kMaxSplit = 16;                // non-portable above 8
// The most dynamic shared memory a block may ask for on Hopper.
constexpr int kMaxSmem = 227 * 1024;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Whether the products read the raw stages (plain fp32 maps) rather than
// a normalised copy of the chunk.
template <typename T, bool AFF>
constexpr bool kDirect = !AFF && std::is_same<T, float>::value;

// A tile of TH rows x TW columns (32, or 16 for maps too small to give
// every SM a block of 32-column tiles).
template <int TH, int TW>
struct Tile {
  static constexpr int kTileW = TW;
  static constexpr int kQuads = TW / kPx;            // 8 or 4
  static constexpr int kLine = TW + 2 * kDisp;       // an f2 row's columns
  static constexpr int kThreads = kQuads * TH * kTaps;  // 576, 288, 72, 36
  static constexpr int kMinBlocks = kThreads > 288 ? 1 : 2;  // per SM
  static constexpr int kRows2 = TH + 2 * kDisp;  // f2 rows with the halo
  // a channel's values: TH f1 rows of TW, then kRows2 f2 rows of TW + 8;
  // as float4 slots, kSlotsCh of them
  static constexpr int kPerCh = TH * kTileW + kRows2 * kLine;
  static constexpr int kSlotsCh = kPerCh / 4;
  static constexpr int kSlots = kChunk * kSlotsCh;
  static constexpr int kSlotsPerThread = (kSlots + kThreads - 1) / kThreads;
  // shared memory, in 4-byte words: kStages raw stages and, unless the
  // products read the stages, the normalised chunk (16 bytes a slot
  // each), then the block's affine rows; after the channel loop the
  // partial sums reuse the stages and the chunk
  static constexpr int kNorm = kChunk * kPerCh;
  static constexpr int kRed = kTaps * kTaps * TH * kTileW;
  static size_t smem_bytes(int per, bool direct) {
    return 4 * static_cast<size_t>(
                   cmax((kStages + (direct ? 0 : 1)) * kNorm + 4 * per, kRed));
  }
};

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  // src-size 0 reads nothing and fills the word with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// one float4 slot: 16 bytes of fp32 or 8 of bf16
__device__ __forceinline__ void cp_async_slot(unsigned dst, const float* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_slot(unsigned dst,
                                              const __nv_bfloat16* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The word route's copies of one float4 slot whose first element is
// `first` (from the map's base) at column `col`: fp32, the 4 elements that
// lie in the image; bf16, the aligned 4-byte words that hold an element in
// the image, from the word holding the first (the normaliser skips the
// parity), at most 3.  A row outside the image has col = kNoRow.
constexpr int kNoRow = -(1 << 20);
__device__ __forceinline__ void stage_words(unsigned raw, const float* map,
                                            long long first, int col,
                                            int W) {
#pragma unroll
  for (int e = 0; e < kPx; ++e) {
    const bool ok = static_cast<unsigned>(col + e) < static_cast<unsigned>(W);
    cp_async4(raw + 4 * e, ok ? map + first + e : map, ok);
  }
}
__device__ __forceinline__ void stage_words(unsigned raw,
                                            const __nv_bfloat16* map,
                                            long long first, int col,
                                            int W) {
  const int parity = static_cast<int>(first & 1);
  const unsigned* words =
      reinterpret_cast<const unsigned*>(map) + ((first - parity) >> 1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = col - parity + 2 * j;  // the word's first column
    const bool ok = (j < 2 || parity) && c + 1 >= 0 && c < W;
    cp_async4(raw + 4 * j, ok ? words + j : words, ok);
  }
}

// The 4 raw values of slot s, widened to fp32: 16 bytes of fp32, or 4
// bf16 from element `parity` of the slot's 16 bytes.
__device__ __forceinline__ float4 raw_slot(const float* raw, int s, int) {
  return reinterpret_cast<const float4*>(raw)[s];
}
__device__ __forceinline__ float4 raw_slot(const __nv_bfloat16* raw, int s,
                                           int parity) {
  const __nv_bfloat16* h = raw + 8 * s + parity;
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

// One block's tile: the body of corr_norm_kernel (AFF) and
// corr_plain_kernel.  aff (B, 4, C) and slope are read only with AFF.
template <typename T, int TH, int TW, bool VEC, bool AFF>
__device__ __forceinline__ void corr_tile(const T* __restrict__ f1,
                                          const T* __restrict__ f2,
                                          const float* __restrict__ aff,
                                          float* __restrict__ out, int C,
                                          int H, int W, float slope, int ks,
                                          int vec_out) {
  using L = Tile<TH, TW>;
  constexpr int kTileW = TW, kQuads = L::kQuads, kLine = L::kLine;
  constexpr bool kRawProducts = kDirect<T, AFF>;
  extern __shared__ __align__(16) float smem[];
  float* norm = smem + kStages * L::kNorm;
  float* aff_s = norm + (kRawProducts ? 0 : L::kNorm);
  const unsigned smem_s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int qx = tid % kQuads;
  const int ty = (tid / kQuads) % TH;
  const int dy = tid / (kQuads * TH);
  const int rank = blockIdx.x % ks;
  const int x0 = (blockIdx.x / ks) * kTileW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const int per = (C + ks - 1) / ks;
  const int c_begin = rank * per;
  const int n_total = max(0, min(C, c_begin + per) - c_begin);
  const int n_chunks = (n_total + kChunk - 1) / kChunk;

  // the block's affine rows m1, rstd1, m2, rstd2 (stride `per`); the
  // first barrier of the channel loop publishes them
  if (AFF) {
    const float* ab = aff + static_cast<size_t>(b) * 4 * C + c_begin;
    for (int j = 0; j < 4; ++j)
      for (int c = tid; c < n_total; c += L::kThreads)
        aff_s[j * per + c] = __ldg(ab + j * C + c);
  }

  // this thread's float4 slots of a chunk, the same for every chunk: the
  // channel in the chunk times 2, plus 1 for f1 (2 * kChunk past the last
  // slot); the first element's column (kNoRow on a row outside the image)
  // and its offset from the chunk's first plane
  constexpr int S = L::kSlotsPerThread;
  int slot_cf[S], slot_col[S], slot_off[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int s = tid + j * L::kThreads;
    const int cc = s / L::kSlotsCh, r = s - cc * L::kSlotsCh;
    const bool first = r < TH * kQuads;
    const int r2 = r - TH * kQuads;
    const int yy = first ? y0 + r / kQuads : y0 + r2 / (kLine / 4) - kDisp;
    const int col = first ? x0 + kPx * (r % kQuads)
                          : x0 - kDisp + kPx * (r2 % (kLine / 4));
    slot_cf[j] = s < L::kSlots ? 2 * cc + first : 2 * kChunk;
    slot_col[j] = yy >= 0 && yy < H ? col : kNoRow;
    slot_off[j] = cc * static_cast<int>(plane) + yy * W + col;
  }

  // cp.async copies of a chunk into its raw stage: one a slot on the
  // vector route (a slot lies wholly in or out of the image there)
  auto stage = [&](int chunk) {
    const int n = min(kChunk, n_total - chunk * kChunk);
    const long long cbase =
        (static_cast<long long>(b) * C + c_begin + chunk * kChunk) *
        static_cast<long long>(plane);
    const unsigned raw = smem_s + 4 * (chunk % kStages) * L::kNorm;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (slot_cf[j] >= 2 * n) continue;
      const T* map = slot_cf[j] & 1 ? f1 : f2;
      const unsigned dst = raw + 16 * (tid + j * L::kThreads);
      const long long first = cbase + slot_off[j];
      if (VEC) {
        const bool in = static_cast<unsigned>(slot_col[j]) <
                        static_cast<unsigned>(W);
        cp_async_slot(dst, in ? map + first : map, in);
      } else {
        stage_words(dst, map, first, slot_col[j], W);
      }
    }
  };

  // the affine (with AFF) over the arrived chunk, widened to fp32, zero
  // outside the image after it
  auto normalise = [&](int chunk) {
    const int n = min(kChunk, n_total - chunk * kChunk);
    const long long cbase =
        (static_cast<long long>(b) * C + c_begin + chunk * kChunk) *
        static_cast<long long>(plane);
    const T* raw =
        reinterpret_cast<const T*>(smem + (chunk % kStages) * L::kNorm);
    const float* a = aff_s + chunk * kChunk;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int cc = slot_cf[j] >> 1;
      if (cc >= n) continue;
      const int s = tid + j * L::kThreads;
      const int parity =
          VEC ? 0 : static_cast<int>((cbase + slot_off[j]) & 1);
      const float4 u = raw_slot(raw, s, parity);
      const float uv[kPx] = {u.x, u.y, u.z, u.w};
      float m = 0.0f, r = 1.0f;
      if (AFF) {
        const float* ar = a + (slot_cf[j] & 1 ? 0 : 2) * per + cc;
        m = ar[0];
        r = ar[per];
      }
      float v[kPx];
#pragma unroll
      for (int e = 0; e < kPx; ++e) {
        const bool in = static_cast<unsigned>(slot_col[j] + e) <
                        static_cast<unsigned>(W);
        v[e] = !in ? 0.0f : AFF ? __fmul_rn(__fsub_rn(uv[e], m), r) : uv[e];
      }
      reinterpret_cast<float4*>(norm)[s] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[kPx][kTaps];
#pragma unroll
  for (int p = 0; p < kPx; ++p)
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[p][k] = 0.0f;

  for (int chunk = 0; chunk < kStages - 1; ++chunk) {
    if (chunk < n_chunks) stage(chunk);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const float* vals;
    if (kRawProducts) {
      // the products read the stage itself, so the stage of the previous
      // chunk is refilled after the barrier that ends its products
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk arrived; the previous chunk's products done
      if (chunk + kStages - 1 < n_chunks) stage(chunk + kStages - 1);
      cp_async_commit();
      vals = smem + (chunk % kStages) * L::kNorm;
    } else {
      // a chunk's raw stage is refilled kStages - 1 chunks later, after
      // the barrier that follows its normalisation
      if (chunk + kStages - 1 < n_chunks) stage(chunk + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();  // chunk arrived; the previous chunk's products done
      normalise(chunk);
      __syncthreads();  // the chunk is normalised
      vals = norm;
    }
    const int n = min(kChunk, n_total - chunk * kChunk);
    const float* n1 = vals + ty * kTileW + kPx * qx;
    const float* n2 = vals + TH * kTileW + (ty + dy) * kLine + kPx * qx;
#pragma unroll 2
    for (int cc = 0; cc < n; ++cc) {
      const float4 a = *reinterpret_cast<const float4*>(n1 + cc * L::kPerCh);
      const float* s2 = n2 + cc * L::kPerCh;
      const float4 s0 = *reinterpret_cast<const float4*>(s2);
      const float4 s1 = *reinterpret_cast<const float4*>(s2 + 4);
      const float4 s3 = *reinterpret_cast<const float4*>(s2 + 8);
      const float av[kPx] = {a.x, a.y, a.z, a.w};
      const float s[kPx + kTaps - 1] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y,
                                        s1.z, s1.w, s3.x, s3.y, s3.z, s3.w};
#pragma unroll
      for (int p = 0; p < kPx; ++p)
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          acc[p][k] = fmaf(av[p], s[p + k], acc[p][k]);
    }
  }
  cp_async_wait<0>();

  // 1/C as a product, as torch divides a CUDA tensor by a number
  const float inv_c = 1.0f / static_cast<float>(C);
  auto finish = [&](float v) {
    v = __fmul_rn(v, inv_c);
    return !AFF || v > 0.0f ? v : __fmul_rn(v, slope);
  };
  // stores 4 adjacent outputs of tap `tap` at (y, x..x+3): one 16-byte
  // store where the row allows, else one by one up to the right edge
  auto store4 = [&](int tap, int y, int x, float4 v) {
    if (y >= H || x >= W) return;
    float* o = out + ((static_cast<size_t>(b) * kTaps * kTaps + tap) * H + y) *
                         static_cast<size_t>(W) + x;
    v = make_float4(finish(v.x), finish(v.y), finish(v.z), finish(v.w));
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[kPx] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < kPx; ++p)
        if (x + p < W) o[p] = vs[p];
    }
  };

  if (ks == 1) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      store4(dy * kTaps + k, y0 + ty, x0 + kPx * qx,
             make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]));
    return;
  }

  // channel split: partial sums (tap, row, column) in shared memory, then
  // rank r sums its share of the tile over ranks 0..ks-1 in order
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    red[((dy * kTaps + k) * TH + ty) * kQuads + qx] =
        make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
  cluster.sync();
  constexpr int kGroups = kTaps * kTaps * TH * kQuads;
  const int share = (kGroups + ks - 1) / ks;
  const int g_end = min(kGroups, (rank + 1) * share);
  for (int g = rank * share + tid; g < g_end; g += L::kThreads) {
    float4 v = cluster.map_shared_rank(red, 0)[g];
    for (int q = 1; q < ks; ++q) {
      const float4 u = cluster.map_shared_rank(red, q)[g];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int tap = g / (TH * kQuads);
    const int rem = g - tap * TH * kQuads;
    store4(tap, y0 + rem / kQuads, x0 + kPx * (rem % kQuads), v);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Launches Kernels::get<T, TH, TW, VEC>() (a __global__ around corr_tile
// with the signature below) on the grid (tiles x splits, rows, B), a
// cluster of ks blocks along x when ks > 1.
template <typename Kernels, bool AFF, typename T, int TH, int TW, bool VEC>
int launch_tile(const T* f1, const T* f2, const float* aff, float* out,
                int B, int C, int H, int W, float slope, int ks,
                cudaStream_t stream) {
  using L = Tile<TH, TW>;
  const auto kernel = Kernels::template get<T, TH, TW, VEC>();
  static PerDevice attrs;
  const cudaError_t set = attrs.once([&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((W + TW - 1) / TW * ks),
                     static_cast<unsigned>((H + TH - 1) / TH), B);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes =
      L::smem_bytes(AFF ? (C + ks - 1) / ks : 0, kDirect<T, AFF>);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  const int vec_out = W % kPx == 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, f1, f2, aff, out,
                                             C, H, W, slope, ks, vec_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernels, bool AFF, typename T, bool VEC>
int launch_route(const T* f1, const T* f2, const float* aff, float* out,
                 int B, int C, int H, int W, float slope, int th, int tw,
                 int ks, cudaStream_t s) {
  // the tiles of ops/kernels/correlation.py::TILES
  const int tile = th * 100 + tw;
  switch (tile) {
    case 832:
      return launch_tile<Kernels, AFF, T, 8, 32, VEC>(f1, f2, aff, out, B, C,
                                                      H, W, slope, ks, s);
    case 432:
      return launch_tile<Kernels, AFF, T, 4, 32, VEC>(f1, f2, aff, out, B, C,
                                                      H, W, slope, ks, s);
    case 132:
      return launch_tile<Kernels, AFF, T, 1, 32, VEC>(f1, f2, aff, out, B, C,
                                                      H, W, slope, ks, s);
    case 116:
      return launch_tile<Kernels, AFF, T, 1, 16, VEC>(f1, f2, aff, out, B, C,
                                                      H, W, slope, ks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Checks the arguments and launches the tile kernel of `th` rows and `tw`
// columns, `ks` channel splits and the staging route `vec` (as
// ops/kernels/correlation.py's launch_config and staging_route give them).
template <typename Kernels, bool AFF, typename T>
int launch(const T* f1, const T* f2, const float* aff, float* out, int B,
           int C, int H, int W, float slope, int th, int tw, int ks, int vec,
           void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (C <= 0 || ks < 1 || ks > kMaxSplit || ks > C ||
      (vec && W % kPx != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_route<Kernels, AFF, T, true>(f1, f2, aff, out, B, C, H,
                                                   W, slope, th, tw, ks, s)
             : launch_route<Kernels, AFF, T, false>(f1, f2, aff, out, B, C,
                                                    H, W, slope, th, tw, ks,
                                                    s);
}

}  // namespace corr
}  // namespace upflow
