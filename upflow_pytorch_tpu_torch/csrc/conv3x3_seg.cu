// 3x3 stride-1 dilated convolution + bias + LeakyReLU (or ReLU), bf16 in
// and out, fp32 accumulation, for Hopper.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/conv.py
// (_conv3x3_seg_fwd, _seg_kernel / _seg_kernel_stored):
//   out = bf16_rn(leaky_0.1(conv3x3_d(x) + bias))
// with bf16 operands, exact products summed in fp32 over the 9 * Cin
// terms, the bias added and the LeakyReLU applied in fp32, and one
// round-to-nearest-even to bf16.  Zero padding of d on every side (SAME).
//
// Input and output are channel ranges of NCHW buffers: each batch item is
// a contiguous (C, H, W) block, but consecutive batch items may lie
// further apart (their own batch strides).  The decoder's dense stacks
// keep all their features in one buffer and give each conv its input
// range and its output slot in that buffer, so no concatenation is ever
// copied.  One kernel serves every dilation.
//
// Bound on the H100: operations.  The dense-stack convs do 2 * 9 * Cin
// products per output value (up to 565 input channels) against a few
// bytes per value, far above the ~295 bf16 operations per byte at which
// the tensor cores, and not the memory, limit.  Design: an implicit GEMM
// on wgmma, M = pixels, N = output channels, K = 9 taps x Cin.
//
// - A block owns 128 pixels and NB output channels (the whole Cout of
//   every conv up to 128: each input byte is staged once per pixel tile).
//   Two consumer warpgroups, 64 pixels each, run wgmma m64nNBk16 with fp32
//   accumulators in registers.
// - K steps over (64-channel chunk, tap row ky).  A step brings the window
//   of 64 channels that holds all three column taps of the tile's pixels,
//   and the three taps' NB x 64 weights, packed once per model in the
//   order the steps run, K-major and already swizzled (pack_weight in
//   ops/kernels/conv3x3_seg.py), so one bulk copy lands them in wgmma's
//   layout.  Each tap's A operand is the window shifted by p + (kx-1) d
//   pixels (p = d rounded up to 8), stored pixel-major (one 128-byte line
//   per channel, 128-byte swizzle) and read by wgmma as an MN-major
//   operand.
// - The shift is a copy in shared memory: TMA takes a box only from a
//   column that is a multiple of 8 bf16 (16 bytes; any other raises an
//   illegal-instruction fault on the H100), so no box can start at the
//   tap's own column.  Each consumer warpgroup shifts its 64 pixels into
//   one of two A buffers while the tensor cores run the previous tap.  A
//   window serves three taps, so each input byte crosses L2 three times
//   per chunk rather than nine.
// - A ring of 2-3 stages with full/empty mbarriers between the producer
//   thread and the consumers; each consumer keeps one wgmma group in
//   flight and releases a stage once the products that read it are done.
// - One thread loads the windows by TMA, which zero-fills every
//   coordinate outside the tensor or past Cin, negative ones included: the
//   SAME padding and the channel tail cost no code.  A tensor map needs
//   rows, strides and address in multiples of 16 bytes, so the input is
//   tiled one of two ways:
//   - Aligned (such are the input ranges themselves): a tile is 2 rows x 64
//     columns, a warpgroup a row, through a 4-D map over (W, H, Cin, B).
//     A step loads one window a row, the pixels [x0 - p, x0 + 64 + p) of
//     row y + (ky-1) d.
//   - Pitched (any other input, such as KITTI's 375 x 1242 pyramid with
//     rows of 311 or 156 pixels): the caller passes a contiguous copy
//     (B, Cin, H, Wp) whose rows are padded with zeros to Wp, a multiple of
//     8 with Wp >= W + d.  A tile is 128 consecutive flat pixels [f0, f0 +
//     128) of the (H Wp) plane, through a 3-D map over (H Wp, Cin, B).  A
//     step loads one window, the flat pixels [f0 - p, f0 + 128 + p) shifted
//     by (ky-1) d Wp: a row above or below the image lies outside the plane
//     and is zero-filled, and a column tap past either end of a row lands in
//     the zero columns [W, Wp) of that row or of the one before, since Wp -
//     W >= d.  The sums are those of the aligned tiling on the zero-extended
//     map, bit for bit.
// - The epilogue adds the bias, applies the activation (relu 1: the
//   LeakyReLU of slope 0.1; 2: RAFT's ReLU; 0: none), rounds once, stages
//   the tile in shared memory and writes each channel's pixels, masking
//   pixels outside the image and channels past Cout, in 8-pixel groups on
//   the aligned tiling (16-byte stores where the row allows) and 4-pixel
//   groups on the pitched one (8-byte stores where the address allows).
//
// The tensor maps are encoded with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no link to libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTileW = 64;    // pixels a consumer warpgroup computes
constexpr int kTileH = 2;     // consumer warpgroups: rows of an aligned tile
constexpr int kTilePx = kTileH * kTileW;  // pixels of a tile
constexpr int kChunk = 64;    // input channels per K step
constexpr int kThreads = 384; // two consumer warpgroups, one producer
constexpr int kRowBytes = kChunk * kTileW * 2;    // one warpgroup's A: 8 KB
constexpr int kABytes = kTileH * kRowBytes;        // a tap's A: 16 KB
constexpr int kEpiPitch = kTileW + 8;  // bf16 per staged output channel
// A step's window, p = d rounded up to 8 (8 or 16): per channel the pixels
// [x0 - p, x0 + 64 + p) of each of an aligned tile's two rows, or the flat
// pixels [f0 - p, f0 + 128 + p) of a pitched tile; a line of (64 + 2p) * 2
// or (128 + 2p) * 2 bytes.
constexpr int kMaxPad = 16;
constexpr int kWinBytes = kTileH * kChunk * (kTileW + 2 * kMaxPad) * 2;
static_assert(kChunk * (kTilePx + 2 * kMaxPad) * 2 <= kWinBytes,
              "a pitched window fits the stage");
constexpr int kBarBytes = 64;  // the ring's mbarriers

// Depth of the ring for an output width: 2 where a stage's three B tiles
// are large (NB = 128) or where two blocks then fit an SM (NB <= 32), 3
// otherwise.
template <int NB>
struct Pipe {
  static constexpr int kStages = (NB == 128 || NB <= 32) ? 2 : 3;
  static constexpr int kBlocksPerSM = NB <= 32 ? 2 : 1;  // registers too
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity ``parity`` has completed.  A wait that
// outlasts ~2^34 cycles (seconds) traps: a broken pipeline then ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory; completion is
// counted in bytes on ``bar``.  The column coordinate c0 must be a
// multiple of 8 (16 bytes).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The same from a 3-D tensor map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A contiguous bulk copy (16-byte multiple) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Writes 16-byte group q of A line ``line`` (128-byte lines, swizzled as
// TMA and wgmma lay them out).
__device__ __forceinline__ void store_a(unsigned char* dst, int line, int q,
                                        const uint32_t* r) {
  *reinterpret_cast<uint4*>(dst + ((line * 128 + q * 16) ^
                                   ((line & 7) << 4))) =
      make_uint4(r[0], r[1], r[2], r[3]);
}

// The realignment, run by each consumer warpgroup for its 64 pixels: the
// 64 channel lines of the window from pixel offset 8 g + S,
// written as the tap's A.  Each lane moves one 16-byte group of a line
// per pass (8 lanes a line, 4 lines a pass, 16 lines a warp): it reads the
// one or two window groups the shifted group covers and joins them, word
// by word for an even S, half-word by half-word for an odd one.
template <int S>
__device__ __forceinline__ void realign(unsigned char* dst,
                                        const unsigned char* win, int pitch,
                                        int g, int lane, int warp) {
  const int q = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int line = warp * 16 + j * 4 + (lane >> 3);
    const uint4* src =
        reinterpret_cast<const uint4*>(win + line * pitch) + g + q;
    uint32_t r[4];
    const uint4 lo = src[0];
    if constexpr (S == 0) {
      r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
    } else {
      const uint4 hi = src[1];
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w,
                             hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = (S & 1)
                   ? __funnelshift_r(w[k + S / 2], w[k + S / 2 + 1], 16)
                   : w[k + S / 2];
      }
    }
    store_a(dst, line, q, r);
  }
}

__device__ __forceinline__ void realign_at(int offset, unsigned char* dst,
                                           const unsigned char* win,
                                           int pitch, int lane, int warp) {
  const int g = offset >> 3;
  switch (offset & 7) {
    case 0: realign<0>(dst, win, pitch, g, lane, warp); break;
    case 1: realign<1>(dst, win, pitch, g, lane, warp); break;
    case 2: realign<2>(dst, win, pitch, g, lane, warp); break;
    case 3: realign<3>(dst, win, pitch, g, lane, warp); break;
    case 4: realign<4>(dst, win, pitch, g, lane, warp); break;
    case 5: realign<5>(dst, win, pitch, g, lane, warp); break;
    case 6: realign<6>(dst, win, pitch, g, lane, warp); break;
    default: realign<7>(dst, win, pitch, g, lane, warp); break;
  }
}

// The tilings, by the TMA boxes a step loads (the kernel's second template
// argument, so a profile's kernel names tell them apart): an aligned tile
// loads a box for each of its two rows, a pitched one a box of 128 + 2p
// flat pixels.
constexpr int kAligned = 2;
constexpr int kPitched = 1;

// K step i = (64-channel chunk, tap row ky): the window's origin, on the
// aligned tiling (column x0 - p of row y0 + (ky-1) d) or on the pitched
// one (flat pixel f0 - p + (ky-1) d Wp, a multiple of 8 since f0, p and
// Wp are).
struct Step {
  int xw, ys, c0;
};

template <bool kFlat>
__device__ __forceinline__ Step step_at(int i, int x0, int y0, int d,
                                        int pad, int Wp) {
  const int kc = i / 3, ky = i - 3 * kc;
  if (kFlat) return {x0 - pad + (ky - 1) * d * Wp, 0, kc * kChunk};
  return {x0 - pad, y0 + (ky - 1) * d, kc * kChunk};
}

// wmap: the input's tensor map, over a bf16 (B, .., H, W) channel range of
// Cin channels (Aligned) or over a contiguous (B, Cin, H, Wp) copy whose
// columns [W, Wp) are zero (Pitched).  wp: the weights packed as
// (ceil(Cout / NB), ceil(Cin / 64), 9, NB, 64) bf16, 16-byte groups of
// each 128-byte row swizzled, zero where Cin or Cout is padded.  bias:
// (Cout,) fp32.  out: bf16 range of Cout channels, batch stride
// out_bstride; vec_out: its rows take 16-byte stores.  d <= 16.  Grid
// (tiles, ceil(Cout / NB), B): tiles_x * tiles_y 2 x 64 tiles (Aligned) or
// ceil(H Wp / 128) flat tiles (Pitched).
template <int NB, int kBoxes>
__global__ void __launch_bounds__(kThreads, Pipe<NB>::kBlocksPerSM)
conv3x3_seg_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, long long out_bstride,
                   int Cin, int Cout, int H, int W, int Wp, int d, int relu,
                   int tiles_x, int vec_out) {
  constexpr bool kFlat = kBoxes == kPitched;
  constexpr int kBBytes = NB * kChunk * 2;  // one tap's weights
  // a stage: the window and the weights of its three taps
  constexpr int kStageBytes = kWinBytes + 3 * kBBytes;
  constexpr int kAcc = NB / 2;
  constexpr int kStages = Pipe<NB>::kStages;
  extern __shared__ unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kBarBytes + 1023) &
      ~static_cast<uintptr_t>(1023));
  // two A buffers, one per tap in flight; each warpgroup owns its half
  unsigned char* abuf = ring + kStages * kStageBytes;

  // the tile's first pixel: column x0 of row y0, or flat pixel x0
  const int x0 = kFlat ? blockIdx.x * kTilePx
                       : (blockIdx.x % tiles_x) * kTileW;
  const int y0 = kFlat ? 0 : (blockIdx.x / tiles_x) * kTileH;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int n_chunks = (Cin + kChunk - 1) / kChunk;
  const int steps = 3 * n_chunks;
  const int pad = d <= 8 ? 8 : kMaxPad;
  const int pitch = ((kFlat ? kTilePx : kTileW) + 2 * pad) * 2;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const long long plane = static_cast<long long>(H) * W;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival, with its bytes
      mbar_init(empty + s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues the copies ----
    if (t != 0) return;
    const __nv_bfloat16* wblk =
        wp + static_cast<size_t>(blockIdx.y) * 9 * n_chunks * NB * kChunk;
    const int win_bytes = kBoxes * kChunk * pitch;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      const Step st = step_at<kFlat>(i, x0, y0, d, pad, Wp);
      unsigned char* win = ring + s * kStageBytes;
      mbar_arrive_tx(full + s, 3 * kBBytes + win_bytes);
      if (kFlat) {
        tma_load_3d(win, &wmap, full + s, st.xw, st.c0, b);
      } else {
        tma_load_4d(win, &wmap, full + s, st.xw, st.ys, st.c0, b);
        tma_load_4d(win + kChunk * pitch, &wmap, full + s, st.xw, st.ys + 1,
                    st.c0, b);
      }
      // the weights of taps (ky, 0..2) lie together
      bulk_load(win + kWinBytes,
                wblk + static_cast<size_t>(3 * i) * NB * kChunk, 3 * kBBytes,
                full + s);
    }
    return;
  }

  // ---- consumers: warpgroup wg computes the tile's row y0 + wg, or its
  // flat pixels x0 + 64 wg .. ----
  float acc[kAcc];  // written first by the scale-d = 0 product
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    const unsigned char* win =
        ring + s * kStageBytes + (kFlat ? 0 : wg * kChunk * pitch);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      // shift this warpgroup's pixels of the window into the tap's A
      // (while the tensor cores run the previous tap), then multiply
      const int tap = 3 * i + kx;
      unsigned char* a = abuf + (tap & 1) * kABytes + wg * kRowBytes;
      realign_at((kFlat ? wg * kTileW : 0) + pad + (kx - 1) * d, a, win,
                 pitch, lane, warp);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      const uint32_t au = smem_u32(a);
      const uint32_t bu = smem_u32(ring + s * kStageBytes + kWinBytes +
                                   kx * kBBytes);
      fence_regs<kAcc>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        // A: 16 channel lines of 128 bytes from channel 16 kk, 8-line
        // groups 1024 bytes apart; B: bytes 32 kk.. of each 128-byte
        // weight row, 8-row groups 1024 bytes apart
        upflow::Wgmma<NB>::mma(acc, sw128_desc(au + kk * 2048, kRowBytes, 1024),
                               sw128_desc(bu + kk * 32, 16, 1024),
                               tap > 0 || kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous tap's products are done: its A buffer is free, and
      // after a step's first tap so is the previous step's stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kx == 0 && i > 0 && lane == 0) {
        mbar_arrive(empty + (i - 1) % kStages);
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs<kAcc>(acc);

  // ---- epilogue: both warpgroups are done with the ring ----
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(ring) + wg * NB * kEpiPitch;
  // accumulator r: pixel warp*16 + lane/4 (+8 for bit 1 of r), channel
  // (r/4)*8 + 2 (lane%4) (+1 for bit 0 of r)
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int px = warp * 16 + (lane >> 2) + ((r >> 1) & 1) * 8;
    const int col = (r >> 2) * 8 + 2 * (lane & 3) + (r & 1);
    const int co = n0 + col;
    float v = __fadd_rn(acc[r], co < Cout ? __ldg(bias + co) : 0.0f);
    if (relu && !(v >= 0.0f)) v = relu == 2 ? 0.0f : __fmul_rn(v, 0.1f);
    stage[col * kEpiPitch + px] = __float2bfloat16_rn(v);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  __nv_bfloat16* ob = out + b * out_bstride;
  if (kFlat) {
    // thread t writes pixels 4 (t % 16) .. + 3 of every eighth channel
    // from t / 16: those in the image, by one 8-byte store where the
    // destination allows, by 4-byte or 2-byte stores elsewhere
    const int px = 4 * (t & 15);
    const int f = x0 + wg * kTileW + px;
    const int yy = f / Wp, xx = f - yy * Wp;  // 4 pixels of one row
    if (yy >= H || xx >= W) return;
    const int n = W - xx < 4 ? W - xx : 4;
    __nv_bfloat16* dst = ob + static_cast<size_t>(yy) * W + xx;
    for (int col = t >> 4; col < NB && n0 + col < Cout; col += 8) {
      __nv_bfloat16* o = dst + (n0 + col) * plane;
      const __nv_bfloat16* src = stage + col * kEpiPitch + px;
      const int a = static_cast<int>(reinterpret_cast<uintptr_t>(o) & 7);
      if (n == 4 && a == 0) {
        *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(src);
      } else if (n == 4 && a == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        reinterpret_cast<uint32_t*>(o)[0] = v.x;
        reinterpret_cast<uint32_t*>(o)[1] = v.y;
      } else {
        for (int e = 0; e < n; ++e) o[e] = src[e];
      }
    }
    return;
  }
  const int yy = y0 + wg;
  if (yy >= H) return;
  __nv_bfloat16* orow = ob + static_cast<size_t>(yy) * W;
  for (int idx = t; idx < NB * 8; idx += 128) {
    const int col = idx >> 3, px = (idx & 7) * 8;
    const int co = n0 + col, xx = x0 + px;
    if (co >= Cout || xx >= W) continue;
    const __nv_bfloat16* src = stage + col * kEpiPitch + px;
    __nv_bfloat16* dst = orow + co * plane + xx;
    if (vec_out && xx + 8 <= W) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && xx + e < W; ++e) dst[e] = src[e];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The input's tensor map, no swizzle, zero fill out of bounds, boxes of
// ``box_w`` pixels x 64 channels: over (W, H, Cin, B), a row high, where
// the input is the caller's range (row pitch Wp = W); over (H Wp, Cin, B)
// where it is a pitched copy (Wp > W).
int encode_input_map(CUtensorMap* map, const __nv_bfloat16* x,
                     long long x_bstride, int B, int Cin, int H, int W,
                     int Wp, int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = static_cast<cuuint64_t>(Wp) * 2;  // bytes
  const cuuint64_t plane = row * H;
  const cuuint64_t bstride = static_cast<cuuint64_t>(x_bstride) * 2;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const cuuint32_t bw = static_cast<cuuint32_t>(box_w);
  CUresult r;
  if (Wp != W) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * Wp,
                                static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {plane, bstride};
    const cuuint32_t box[3] = {bw, kChunk, 1};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
           const_cast<__nv_bfloat16*>(x), dims, strides, box, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {
        static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
        static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {row, plane, bstride};
    const cuuint32_t box[4] = {bw, 1, kChunk, 1};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
           const_cast<__nv_bfloat16*>(x), dims, strides, box, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NB, int kBoxes>
int launch(const CUtensorMap& wmap, const __nv_bfloat16* wp,
           const float* bias, __nv_bfloat16* out, long long out_bstride,
           int B, int Cin, int Cout, int H, int W, int Wp, int d, int relu,
           int vec_out, cudaStream_t stream) {
  constexpr size_t smem =
      kBarBytes + 1023 +
      Pipe<NB>::kStages * (kWinBytes + 3 * NB * kChunk * 2) + 2 * kABytes;
  static upflow::PerDevice attrs;
  const cudaError_t e = attrs.once([] {
    return cudaFuncSetAttribute(conv3x3_seg_kernel<NB, kBoxes>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = kBoxes == kPitched
                        ? static_cast<int>((static_cast<long long>(H) * Wp +
                                            kTilePx - 1) / kTilePx)
                        : tiles_x * ((H + kTileH - 1) / kTileH);
  const dim3 grid(tiles, (Cout + NB - 1) / NB, B);
  conv3x3_seg_kernel<NB, kBoxes><<<grid, kThreads, smem, stream>>>(
      wmap, wp, bias, out, out_bstride, Cin, Cout, H, W, Wp, d, relu,
      tiles_x, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_tiling(const __nv_bfloat16* x, long long x_bstride,
                  const __nv_bfloat16* wp, const float* bias,
                  __nv_bfloat16* out, long long out_bstride, int B, int Cin,
                  int Cout, int H, int W, int Wp, int d, int relu,
                  int vec_out, cudaStream_t stream) {
  const int pad = d <= 8 ? 8 : kMaxPad;
  CUtensorMap wmap = {};
  const int e = encode_input_map(&wmap, x, x_bstride, B, Cin, H, W, Wp,
                                 (Wp != W ? kTilePx : kTileW) + 2 * pad);
  if (e != 0) return e;
  if (Wp != W) {
    return launch<NB, kPitched>(wmap, wp, bias, out, out_bstride, B, Cin,
                               Cout, H, W, Wp, d, relu, vec_out, stream);
  }
  return launch<NB, kAligned>(wmap, wp, bias, out, out_bstride, B, Cin, Cout,
                             H, W, Wp, d, relu, vec_out, stream);
}

}  // namespace

// x: bf16 (B, Cin, H, Wp), each item contiguous, batch stride x_bstride
// elements, its address, Wp * 2 and x_bstride * 2 multiples of 16 bytes:
// the caller's channel range (Wp = W), or a copy of it whose rows are
// padded with zeros to Wp >= W + d (the pitched route).  wp: weights
// packed for the block width nb (8, 16, 32, 64, 96 or 128 output
// channels); bias: (Cout,) fp32; out: bf16 channel range (B, Cout, H, W)
// with batch stride out_bstride.  relu: 0 none, 1 LeakyReLU 0.1, 2 ReLU.
// vec_out says out's rows take 16-byte stores.  Current device.
extern "C" int upflow_conv3x3_seg(const __nv_bfloat16* x,
                                  long long x_bstride,
                                  const __nv_bfloat16* wp, const float* bias,
                                  __nv_bfloat16* out, long long out_bstride,
                                  int B, int Cin, int Cout, int H, int W,
                                  int Wp, int d, int relu, int nb,
                                  int vec_out, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  if (d < 1 || d > kMaxPad || (Wp != W && Wp < W + d) || Wp % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UPFLOW_CONV_CASE(N)                                                \
  case N:                                                                  \
    return launch_tiling<N>(x, x_bstride, wp, bias, out, out_bstride, B,   \
                            Cin, Cout, H, W, Wp, d, relu, vec_out, s);
  switch (nb) {
    UPFLOW_CONV_CASE(8)
    UPFLOW_CONV_CASE(16)
    UPFLOW_CONV_CASE(32)
    UPFLOW_CONV_CASE(64)
    UPFLOW_CONV_CASE(96)
    UPFLOW_CONV_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UPFLOW_CONV_CASE
}
