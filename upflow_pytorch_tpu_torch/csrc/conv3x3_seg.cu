// 3x3 stride-1 dilated convolution + bias + LeakyReLU, bf16 in and out,
// fp32 accumulation, for Hopper.
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
// - A block owns 2 rows x 64 columns of pixels and NB output channels
//   (the whole Cout of every conv up to 128: each input byte is staged
//   once per pixel tile).  Two consumer warpgroups, one per row, each run
//   wgmma m64nNBk16 with fp32 accumulators in registers.
// - K steps over (64-channel chunk, tap row ky).  A step brings one
//   window per row, the pixels [x0 - p, x0 + 64 + p) of 64 channels at
//   row y + (ky-1) d (p = d rounded up to 8), which holds all three column
//   taps, and the three taps' NB x 64 weights, packed once per model in
//   the order the steps run, K-major and already swizzled (pack_weight in
//   ops/kernels/conv3x3_seg.py), so one bulk copy lands them in wgmma's
//   layout.  Each tap's A operand is the window shifted by p + (kx-1) d
//   pixels, stored pixel-major (one 128-byte line per channel, 128-byte
//   swizzle) and read by wgmma as an MN-major operand.
// - The shift is a copy in shared memory: TMA takes a box only from a
//   column that is a multiple of 8 bf16 (16 bytes; any other raises an
//   illegal-instruction fault on the H100), so no box can start at the
//   tap's own column.  Each consumer warpgroup shifts its row into one of
//   two A buffers while the tensor cores run the previous tap.  A window
//   serves three taps, so each input byte crosses L2 three times per
//   chunk rather than nine.
// - A ring of 2-3 stages with full/empty mbarriers between the producer
//   warpgroup and the consumers; each consumer keeps one wgmma group in
//   flight and releases a stage once the products that read it are done.
// - Two producers fill the same windows.  Where the input's rows, batch
//   stride and address are multiples of 16 bytes, one thread loads them
//   by TMA through a 4-D tensor map over (W, H, Cin, B), which zero-fills
//   every coordinate outside the image or past Cin, negative ones
//   included: the SAME padding and the channel tail cost no code.
//   Elsewhere (KITTI's 375 x 1242 pyramid, rows of 311 or 156 pixels) the
//   producer warpgroup copies each line from the 4-byte word that holds
//   its first pixel with cp.async, and the consumers shift each line by
//   its own half-word offset, zeroing pixels outside the image.
// - The epilogue adds the bias, applies the LeakyReLU, rounds once, stages
//   the tile in shared memory and writes each channel's 64 pixels along W
//   (16-byte stores where the row allows), masking columns past W and
//   channels past Cout.
//
// The tensor map is encoded with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no link to libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTileW = 64;    // pixels of a tile row: one 128-byte line
constexpr int kTileH = 2;     // rows of a tile: one per consumer warpgroup
constexpr int kChunk = 64;    // input channels per K step
constexpr int kThreads = 384; // two consumer warpgroups, one producer
constexpr int kRowBytes = kChunk * kTileW * 2;    // one row's A: 8 KB
constexpr int kABytes = kTileH * kRowBytes;        // a tap's A: 16 KB
constexpr int kEpiPitch = kTileW + 8;  // bf16 per staged output channel
// A step's window: per row and channel the pixels [x0 - p, x0 + 64 + p)
// with p = d rounded up to 8 (8 or 16), which hold all three column taps;
// its line pitch is (64 + 2p) * 2 bytes on the TMA route and 16 bytes more
// on the ragged one, which copies from the 4-byte word left of x0 - p.
constexpr int kMaxPad = 16;
constexpr int kMaxWinPitch = (kTileW + 2 * kMaxPad) * 2 + 16;  // 208 bytes
constexpr int kWinBytes = kTileH * kChunk * kMaxWinPitch;       // 26 KB
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

// The producer of the ragged route: the 128 window lines (row y, channel
// c) of a step, each from the 4-byte word that holds its first pixel
// x0 - p, 33 + p words a line, copied with cp.async.  A word with no pixel
// in the image, and every word of a row outside the image or of a channel
// past Cin, is zero-filled; a word holding one wanted pixel lies inside
// that pixel's aligned word, so no copy leaves the tensor.  Completion is
// counted on ``bar``.
__device__ __forceinline__ void fetch_rows(unsigned char* win, int pitch,
                                           const unsigned short* xb,
                                           uint64_t* bar, int lane, int warp,
                                           int xw, int ys, int c0, int pad,
                                           int Cin, int H, int W,
                                           long long plane) {
  const int n_words = 33 + pad;
  for (int j = 0; j < 32; ++j) {
    const int line = warp * 32 + j;
    const int y = line >> 6, c = line & 63;
    const int yy = ys + y, cc = c0 + c;
    const bool row_ok = yy >= 0 && yy < H && cc < Cin;
    const unsigned short* first =
        xb + (row_ok ? cc * plane + static_cast<long long>(yy) * W + xw : 0);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(first);
    const int odd = static_cast<int>(addr >> 1) & 1;
    const uintptr_t word0 = addr & ~static_cast<uintptr_t>(3);
    unsigned char* dst = win + (y * kChunk + c) * pitch;
    for (int k = lane; k < n_words; k += 32) {
      const int xa = xw - odd + 2 * k;  // the word's first pixel
      const bool any = row_ok && xa + 1 >= 0 && xa < W;
      asm volatile(
          "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
              smem_u32(dst + 4 * k)),
          "l"(any ? word0 + 4 * k : reinterpret_cast<uintptr_t>(xb)),
          "r"(any ? 4 : 0)
          : "memory");
    }
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Writes 16-byte group q of A line ``line`` (128-byte lines, swizzled as
// TMA and wgmma lay them out).
__device__ __forceinline__ void store_a(unsigned char* dst, int line, int q,
                                        const uint32_t* r) {
  *reinterpret_cast<uint4*>(dst + ((line * 128 + q * 16) ^
                                   ((line & 7) << 4))) =
      make_uint4(r[0], r[1], r[2], r[3]);
}

// The TMA route's realignment, run by the consumer warpgroup that reads
// the row: its 64 channel lines of the window from pixel offset 8 g + S,
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

// The ragged route's realignment: line c of the window starts at the word
// that holds pixel x0 - p, one pixel early where that pixel's address is
// odd (``par0``: the parity of the batch item's base, in pixels), so the
// tap's pixels start at ``offset`` plus that pixel.  Pixels outside
// [0, W) are zeroed: a word at the edge of a row holds a pixel of the next
// or the previous one.
__device__ __forceinline__ void realign_rows(unsigned char* dst,
                                             const unsigned char* win,
                                             int pitch, int offset, int par0,
                                             long long plane, int W, int xw,
                                             int xs, int yy, int c0,
                                             int lane, int warp) {
  const int q = lane & 7;
  uint32_t keep[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = xs + 8 * q + 2 * k;
    keep[k] = (x >= 0 && x < W ? 0xFFFFu : 0u) |
              (x + 1 >= 0 && x + 1 < W ? 0xFFFF0000u : 0u);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int line = warp * 16 + j * 4 + (lane >> 3);
    const int odd = static_cast<int>(
        (par0 + (c0 + line) * plane + static_cast<long long>(yy) * W + xw) &
        1);
    const int o = offset + odd;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
                              win + line * pitch) +
                          (o >> 1) + 4 * q;
    uint32_t r[4];
    if (o & 1) {
      uint32_t w[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) w[k] = src[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = __funnelshift_r(w[k], w[k + 1], 16) & keep[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = src[k] & keep[k];
    }
    store_a(dst, line, q, r);
  }
}

// K step i = (64-channel chunk, tap row ky): the window's origin.
struct Step {
  int xw, ys, c0;
};

__device__ __forceinline__ Step step_at(int i, int x0, int y0, int d,
                                        int pad) {
  const int kc = i / 3, ky = i - 3 * kc;
  return {x0 - pad, y0 + (ky - 1) * d, kc * kChunk};
}

// x: bf16 (B, .., H, W) channel range of Cin channels, batch stride
// x_bstride elements (read through ``wmap`` on the TMA route).  wp: the
// weights packed as (ceil(Cout / NB), ceil(Cin / 64), 9, NB, 64) bf16,
// 16-byte groups of each 128-byte row swizzled, zero where Cin or Cout is
// padded.  bias: (Cout,) fp32.  out: bf16 range of Cout channels, batch
// stride out_bstride; vec_out: its rows take 16-byte stores.  d <= 16.
// Grid (tiles_x * tiles_y, ceil(Cout / NB), B).
template <int NB, bool kTma>
__global__ void __launch_bounds__(kThreads, Pipe<NB>::kBlocksPerSM)
conv3x3_seg_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ x, long long x_bstride,
                   const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, long long out_bstride,
                   int Cin, int Cout, int H, int W, int d, int relu,
                   int tiles_x, int vec_out) {
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
  // two A buffers, one per tap in flight; each warpgroup owns its row
  unsigned char* abuf = ring + kStages * kStageBytes;

  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int n_chunks = (Cin + kChunk - 1) / kChunk;
  const int steps = 3 * n_chunks;
  const int pad = d <= 8 ? 8 : kMaxPad;
  const int pitch = (kTileW + 2 * pad) * 2 + (kTma ? 0 : 16);
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const long long plane = static_cast<long long>(H) * W;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + b * x_bstride;

  if (threadIdx.x == 0) {
    if (kTma) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
    }
    for (int s = 0; s < kStages; ++s) {
      // TMA: one arrival, with the bytes the copies bring; ragged: that
      // arrival (the weights) and one from each producer thread when its
      // cp.async copies have landed
      mbar_init(full + s, kTma ? 1 : 129);
      mbar_init(empty + s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues the copies (TMA route), or the
    // warpgroup copies the window (ragged route) ----
    if (kTma && t != 0) return;
    const __nv_bfloat16* wblk =
        wp + static_cast<size_t>(blockIdx.y) * 9 * n_chunks * NB * kChunk;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      const Step st = step_at(i, x0, y0, d, pad);
      unsigned char* win = ring + s * kStageBytes;
      if (t == 0) {
        const int row_bytes = kChunk * pitch;
        mbar_arrive_tx(full + s, 3 * kBBytes + (kTma ? 2 * row_bytes : 0));
        if (kTma) {
          tma_load_4d(win, &wmap, full + s, st.xw, st.ys, st.c0, b);
          tma_load_4d(win + row_bytes, &wmap, full + s, st.xw, st.ys + 1,
                      st.c0, b);
        }
        // the weights of taps (ky, 0..2) lie together
        bulk_load(win + kWinBytes,
                  wblk + static_cast<size_t>(3 * i) * NB * kChunk,
                  3 * kBBytes, full + s);
      }
      if (!kTma) {
        fetch_rows(win, pitch, xb, full + s, lane, warp, st.xw, st.ys,
                   st.c0, pad, Cin, H, W, plane);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes tile row y0 + wg ----
  float acc[kAcc];  // written first by the scale-d = 0 product
  const int par0 = static_cast<int>(reinterpret_cast<uintptr_t>(xb) >> 1) & 1;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    const Step st = step_at(i, x0, y0, d, pad);
    const unsigned char* win = ring + s * kStageBytes + wg * kChunk * pitch;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      // shift this row's window into the tap's A (while the tensor cores
      // run the previous tap), then multiply
      const int tap = 3 * i + kx;
      unsigned char* a = abuf + (tap & 1) * kABytes + wg * kRowBytes;
      const int offset = pad + (kx - 1) * d;
      if (kTma) {
        realign_at(offset, a, win, pitch, lane, warp);
      } else {
        realign_rows(a, win, pitch, offset, par0, plane, W, st.xw,
                     x0 + (kx - 1) * d, st.ys + wg, st.c0, lane, warp);
      }
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
    if (relu && !(v >= 0.0f)) v = __fmul_rn(v, 0.1f);
    stage[col * kEpiPitch + px] = __float2bfloat16_rn(v);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  const int yy = y0 + wg;
  if (yy >= H) return;
  __nv_bfloat16* orow = out + b * out_bstride + static_cast<size_t>(yy) * W;
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

// The input range as a 4-D tensor (W, H, Cin, B) with boxes of ``box_w``
// x 1 x 64 x 1, no swizzle, zero fill out of bounds.
int encode_input_map(CUtensorMap* map, const __nv_bfloat16* x,
                     long long x_bstride, int B, int Cin, int H, int W,
                     int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(Cin),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(W) * 2, static_cast<cuuint64_t>(H) * W * 2,
      static_cast<cuuint64_t>(x_bstride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), 1, kChunk, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<__nv_bfloat16*>(x), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NB, bool kTma>
int launch(const CUtensorMap& wmap, const __nv_bfloat16* x,
           long long x_bstride, const __nv_bfloat16* wp, const float* bias,
           __nv_bfloat16* out, long long out_bstride, int B, int Cin,
           int Cout, int H, int W, int d, int relu, int vec_out,
           cudaStream_t stream) {
  constexpr size_t smem =
      kBarBytes + 1023 +
      Pipe<NB>::kStages * (kWinBytes + 3 * NB * kChunk * 2) + 2 * kABytes;
  static upflow::PerDevice attrs;
  const cudaError_t e = attrs.once([] {
    return cudaFuncSetAttribute(conv3x3_seg_kernel<NB, kTma>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, (Cout + NB - 1) / NB, B);
  conv3x3_seg_kernel<NB, kTma><<<grid, kThreads, smem, stream>>>(
      wmap, x, x_bstride, wp, bias, out, out_bstride, Cin, Cout, H, W, d,
      relu, tiles_x, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_route(const __nv_bfloat16* x, long long x_bstride,
                 const __nv_bfloat16* wp, const float* bias,
                 __nv_bfloat16* out, long long out_bstride, int B, int Cin,
                 int Cout, int H, int W, int d, int relu, int tma,
                 int vec_out, cudaStream_t stream) {
  CUtensorMap wmap = {};
  if (!tma) {
    return launch<NB, false>(wmap, x, x_bstride, wp, bias, out, out_bstride,
                             B, Cin, Cout, H, W, d, relu, vec_out, stream);
  }
  const int pad = d <= 8 ? 8 : kMaxPad;
  const int e = encode_input_map(&wmap, x, x_bstride, B, Cin, H, W,
                                 kTileW + 2 * pad);
  if (e != 0) return e;
  return launch<NB, true>(wmap, x, x_bstride, wp, bias, out, out_bstride, B,
                          Cin, Cout, H, W, d, relu, vec_out, stream);
}

}  // namespace

// x: bf16 channel range (B, Cin, H, W), each item contiguous, batch stride
// x_bstride elements; wp: weights packed for the block width nb (8, 16,
// 32, 64, 96 or 128 output channels); bias: (Cout,) fp32; out: bf16
// channel range (B, Cout, H, W) with batch stride out_bstride.  tma picks
// the TMA producer (W * 2, x_bstride * 2 and x multiples of 16 bytes) or
// the ragged one; vec_out says out's rows take 16-byte stores.  Current
// device.
extern "C" int upflow_conv3x3_seg(const __nv_bfloat16* x,
                                  long long x_bstride,
                                  const __nv_bfloat16* wp, const float* bias,
                                  __nv_bfloat16* out, long long out_bstride,
                                  int B, int Cin, int Cout, int H, int W,
                                  int d, int relu, int nb, int tma,
                                  int vec_out, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  if (d < 1 || d > kMaxPad) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UPFLOW_CONV_CASE(N)                                                \
  case N:                                                                  \
    return launch_route<N>(x, x_bstride, wp, bias, out, out_bstride, B,    \
                           Cin, Cout, H, W, d, relu, tma, vec_out, s);
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
