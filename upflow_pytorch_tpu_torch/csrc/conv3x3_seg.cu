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
// copied.  That is what the TPU kernel's segment list and stored layout
// bought; here a pointer and a batch stride do it, and the TPU machinery
// (128-aligned segment groups, garbage tails, tap packing, VMEM tiling,
// the staged path for d > 8) is gone.  One kernel serves every dilation.
//
// Bound on the H100: operations.  The dense-stack convs do 2 * 9 * Cin
// products per output value (up to 565 input channels) against a few
// bytes per value, far above the ~295 bf16 operations per byte at which
// the card's tensor cores, and not its memory, limit.  Design: an implicit
// GEMM on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate).  A block owns an 8 x 32 pixel tile and NB output channels;
// each of its 8 warps owns one pixel row (two 16-pixel MMA rows) and all
// NB channels.  Input channels go through shared memory 16 at a time: the
// (8 + 2d) x (32 + 2d) slab with its halo (zeros outside the image) and
// the 9 x NB x 16 weights; each of the 9 taps then reads its A fragments
// from the slab at the tap's offset, so the slab is the im2col matrix
// without being copied.  Positions and weight rows are 24 bf16 apart in
// shared memory (16 used), which makes the 32-bit fragment loads free of
// bank conflicts.  No wgmma, TMA or pipelining yet: the stages are loaded
// and then computed, one after the other.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;    // output rows per block: one per warp
constexpr int kTileW = 32;   // output columns per block: two MMA rows of 16
constexpr int kThreads = 32 * kTileH;
constexpr int kChunk = 16;   // input channels per stage: the MMA's k
constexpr int kPitch = 24;   // bf16 per staged position and weight row

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x: bf16 (B, .., H, W) channel range of Cin channels, batch stride
// x_bstride elements.  wp: the weights packed as
// (Cout / NB, ceil(Cin / 16), 9, NB, 16) bf16, zero where Cin or Cout is
// padded.  bias: (Cout,) fp32.  out: bf16 range of Cout channels, batch
// stride out_bstride.  Grid (tiles_x * tiles_y, ceil(Cout / NB), B).
template <int NB>
__global__ void __launch_bounds__(kThreads)
conv3x3_seg_kernel(const __nv_bfloat16* __restrict__ x, long long x_bstride,
                   const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, long long out_bstride,
                   int Cin, int Cout, int H, int W, int d, int relu,
                   int tiles_x) {
  constexpr int NT = NB / 8;  // MMA column tiles of 8 output channels
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);  // [9*NB][kPitch]
  __nv_bfloat16* sx = sw + 9 * NB * kPitch;                     // [pos][kPitch]
  const int SW = kTileW + 2 * d;
  const int npos = (kTileH + 2 * d) * SW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + b * x_bstride;
  const int n_chunks = (Cin + kChunk - 1) / kChunk;
  const uint4* wblk = reinterpret_cast<const uint4*>(
      wp + static_cast<size_t>(blockIdx.y) * n_chunks * 9 * NB * kChunk);

  float acc[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][n][j] = 0.0f;

  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();
    // the chunk's weights: 9 * NB rows of 16 bf16, two 16-byte words each
    const uint4* wsrc = wblk + static_cast<size_t>(kc) * 9 * NB * 2;
    for (int i = tid; i < 9 * NB * 2; i += kThreads) {
      *reinterpret_cast<uint4*>(sw + (i >> 1) * kPitch + (i & 1) * 8) =
          __ldg(wsrc + i);
    }
    // the input slab: 16 channels of every position, zeros outside the
    // image and beyond Cin; neighbouring threads read neighbouring columns
    const int c0 = kc * kChunk;
    for (int pos = tid; pos < npos; pos += kThreads) {
      const int r = pos / SW, col = pos - r * SW;
      const int yy = y0 - d + r, xx = x0 - d + col;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const unsigned short* src =
          xb + static_cast<size_t>(c0) * plane + (in ? yy * W + xx : 0);
      uint32_t word[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 2 * j;
        const uint32_t lo =
            in && c < Cin ? __ldg(src + static_cast<size_t>(2 * j) * plane)
                          : 0u;
        const uint32_t hi =
            in && c + 1 < Cin
                ? __ldg(src + static_cast<size_t>(2 * j + 1) * plane)
                : 0u;
        word[j] = lo | (hi << 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(sx + pos * kPitch);
      dst[0] = make_uint4(word[0], word[1], word[2], word[3]);
      dst[1] = make_uint4(word[4], word[5], word[6], word[7]);
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A (16 pixels x 16 channels): rows g and g + 8, channel pairs
        // 2 tig and 2 tig + 8 of the tap's shifted slab position
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (warp + ky * d) * SW + h * 16 + g + kx * d;
          const uint32_t* lo =
              reinterpret_cast<const uint32_t*>(sx + p * kPitch) + tig;
          const uint32_t* hi =
              reinterpret_cast<const uint32_t*>(sx + (p + 8) * kPitch) + tig;
          a[h][0] = lo[0];
          a[h][1] = hi[0];
          a[h][2] = lo[4];
          a[h][3] = hi[4];
        }
        // B (16 channels x 8 outputs): output g, channel pairs 2 tig and
        // 2 tig + 8 of the tap's weights
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t* wr = reinterpret_cast<const uint32_t*>(
                                   sw + ((ky * 3 + kx) * NB + n * 8 + g) *
                                            kPitch) +
                               tig;
          const uint32_t bf[2] = {wr[0], wr[4]};
          mma_bf16(acc[0][n], a[0], bf);
          mma_bf16(acc[1][n], a[1], bf);
        }
      }
    }
  }

  // epilogue: accumulator j of MMA row h holds pixel h*16 + g (+8 for
  // j >= 2) and output channel n*8 + 2 tig (+1 for odd j)
  const int yy = y0 + warp;
  if (yy >= H) return;
  __nv_bfloat16* ob = out + b * out_bstride + static_cast<size_t>(yy) * W;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xx = x0 + h * 16 + g + (j >= 2 ? 8 : 0);
        const int co = n0 + n * 8 + 2 * tig + (j & 1);
        if (xx >= W || co >= Cout) continue;
        float v = __fadd_rn(acc[h][n][j], bias[co]);
        if (relu && !(v >= 0.0f)) v = __fmul_rn(v, 0.1f);
        ob[co * plane + xx] = __float2bfloat16_rn(v);
      }
}

template <int NB>
int launch(const __nv_bfloat16* x, long long x_bstride,
           const __nv_bfloat16* wp, const float* bias, __nv_bfloat16* out,
           long long out_bstride, int B, int Cin, int Cout, int H, int W,
           int d, int relu, cudaStream_t stream) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const size_t smem = static_cast<size_t>(
                          9 * NB + (kTileH + 2 * d) * (kTileW + 2 * d)) *
                      kPitch * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_seg_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(tiles_x * tiles_y, (Cout + NB - 1) / NB, B);
  conv3x3_seg_kernel<NB><<<grid, kThreads, smem, stream>>>(
      x, x_bstride, wp, bias, out, out_bstride, Cin, Cout, H, W, d, relu,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 channel range (B, Cin, H, W), each item contiguous, batch stride
// x_bstride elements; wp: packed weights for the block width nb (8, 16, 32
// or 64 output channels); bias: (Cout,) fp32; out: bf16 channel range
// (B, Cout, H, W) with batch stride out_bstride.  Current device.
extern "C" int upflow_conv3x3_seg(const __nv_bfloat16* x,
                                  long long x_bstride,
                                  const __nv_bfloat16* wp, const float* bias,
                                  __nv_bfloat16* out, long long out_bstride,
                                  int B, int Cin, int Cout, int H, int W,
                                  int d, int relu, int nb, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8:
      return launch<8>(x, x_bstride, wp, bias, out, out_bstride, B, Cin,
                       Cout, H, W, d, relu, s);
    case 16:
      return launch<16>(x, x_bstride, wp, bias, out, out_bstride, B, Cin,
                        Cout, H, W, d, relu, s);
    case 32:
      return launch<32>(x, x_bstride, wp, bias, out, out_bstride, B, Cin,
                        Cout, H, W, d, relu, s);
    case 64:
      return launch<64>(x, x_bstride, wp, bias, out, out_bstride, B, Cin,
                        Cout, H, W, d, relu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
