// GMFlow's global softmax matching and flow propagation
// (matching.py::global_correlation_softmax and gmflow.py::
// FeatureFlowAttention of haofeixu/gmflow) for Hopper.
//
// Replaces no TPU kernel: the JAX package runs UPFlow alone.  It was added
// for GMFlow (models/gmflow.py), which twice a request takes, for every
// position of the 1/8 grid, a softmax over all positions of the other (or
// its own) frame and its weighted sum of a value two channels wide: the key
// pixels' (x, y) for the matching, the flow for the propagation.
//   out[n, i] = sum_j softmax_j(q[n, i] . k[n, j] * scale) v[n, j]
// q (N, L, 128) and k (N, S, 128) bf16, v (N, S, 2) and out (N, L, 2)
// fp32, all contiguous.
//
// Bound on the H100: operations.  At KITTI's 48 x 156 grid, both
// directions (N = 2) and L = S = 7,488, a call is 28.7 GFLOP of q.k
// products (29 us at the bf16 tensor-core peak) against 7.8 MB of inputs
// and outputs (2.3 us at 3.35 TB/s), and 112 M exponentials (~30 us on the
// 132 SMs' MUFU units).  The published code stores the 7,488 x 7,488
// scores (224 MB fp32 a direction), concatenates them with their transpose
// and normalises them.
// Design, flash attention's: a block owns 64 query rows (16 a warp) and
// walks every key in tiles of 64, double-buffered in shared memory by
// cp.async.  A warp keeps its 16 q rows in registers as mma A fragments;
// a tile's scores come from mma.sync m16n8k16 (bf16 operands, fp32 sums)
// over B fragments read by ldmatrix (key rows padded to 272 bytes, so the
// eight rows of a matrix fall on distinct banks).  The softmax is online,
// in fp32, with log2(e) folded into the scale for exp2: a running row max
// shared by the four lanes that hold a row, and in registers the sums of
// p, p * v.x and p * v.y, which the four lanes add at the end.  Nothing of
// the L x S matrix leaves the registers.  Keys past S score -inf (no
// weight; their v is zero-filled); rows past L are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;              // q and k channels
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows a block
constexpr int kKeys = 64;            // keys a tile
constexpr int kPitch = kC + 8;       // bf16 a key row in shared memory
constexpr int kSteps = kC / 16;      // mma k steps of 16 channels
constexpr int kNTiles = kKeys / 8;   // mma n tiles of 8 keys
constexpr unsigned kFull = 0xffffffffu;

struct Stage {
  __nv_bfloat16 k[kKeys * kPitch];
  float v[kKeys * 2];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// keys [key0, key0 + 64) of one item into a stage, zeros past S
__device__ __forceinline__ void load_tile(Stage& st,
                                          const __nv_bfloat16* __restrict__ k,
                                          const float* __restrict__ v,
                                          int key0, int S, int t) {
  constexpr int kChunks = kC / 8;  // 16-byte chunks a key row
  for (int i = t; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = key0 + r < S;
    const __nv_bfloat16* src =
        k + (ok ? static_cast<size_t>(key0 + r) * kC + c * 8 : 0);
    cp_async16(st.k + r * kPitch + c * 8, src, ok ? 16 : 0);
  }
  for (int i = t; i < kKeys * 2; i += kThreads) {
    const bool ok = key0 + i / 2 < S;
    cp_async4(st.v + i, v + (ok ? static_cast<size_t>(key0) * 2 + i : 0),
              ok ? 4 : 0);
  }
}

// Grid (ceil(L / 64), N).
__global__ void __launch_bounds__(kThreads)
global_match_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int L, int S, float scale_log2e) {
  __shared__ __align__(16) Stage stages[2];
  const int n = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;  // the fragments' row and pair
  q += static_cast<size_t>(n) * L * kC;
  k += static_cast<size_t>(n) * S * kC;
  v += static_cast<size_t>(n) * S * 2;
  out += static_cast<size_t>(n) * L * 2;
  const int tiles = (S + kKeys - 1) / kKeys;

  load_tile(stages[0], k, v, 0, S, t);
  cp_commit();

  // the warp's q rows g and g + 8 as A fragments, k step s: channels
  // 16 s + 2 tq, +1 (registers 0, 1) and 16 s + 8 + 2 tq, +1 (2, 3)
  const int row0 = blockIdx.x * kRows + warp * 16 + g, row1 = row0 + 8;
  uint32_t a[kSteps][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + static_cast<size_t>(min(row0, L - 1)) * kC);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + static_cast<size_t>(min(row1, L - 1)) * kC);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a[s][0] = row0 < L ? __ldg(q0 + s * 8 + tq) : 0u;
      a[s][1] = row1 < L ? __ldg(q1 + s * 8 + tq) : 0u;
      a[s][2] = row0 < L ? __ldg(q0 + s * 8 + 4 + tq) : 0u;
      a[s][3] = row1 < L ? __ldg(q1 + s * 8 + 4 + tq) : 0u;
    }
  }

  // rows g and g + 8: running max of the scaled scores, sums of p, p v
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f}, ox[2] = {0.0f, 0.0f}, oy[2] = {0.0f, 0.0f};
  // ldmatrix: lanes 8 i .. 8 i + 7 address the rows of matrix i
  const int mi = lane / 8, mr = lane % 8;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_tile(stages[(it + 1) & 1], k, v, (it + 1) * kKeys, S, t);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const Stage& st = stages[it & 1];

    float acc[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
      for (int s = 0; s < kSteps; s += 2) {
        // matrices: keys 8 nt .. +7 at channels 16 s, 16 s + 8,
        // 16 (s + 1), 16 (s + 1) + 8: B fragments of steps s and s + 1
        uint32_t b[4];
        ldmatrix_x4(b, st.k + (nt * 8 + mr) * kPitch + (s + mi / 2) * 16 +
                           (mi % 2) * 8);
        mma(acc[nt], a[s], b[0], b[1]);
        mma(acc[nt], a[s + 1], b[2], b[3]);
      }
    }

    // acc[nt][e]: row g (e < 2) or g + 8, key 8 nt + 2 tq + (e & 1)
    const int key0 = it * kKeys;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + nt * 8 + tq * 2 + (e & 1) >= S) acc[nt][e] = -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], acc[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four lanes of a row cover the tile's 64 keys, one of them valid
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 2));
      const float next = fmaxf(m[i], tmax[i] * scale_log2e);
      const float alpha = exp2f(m[i] - next);
      m[i] = next;
      l[i] *= alpha;
      ox[i] *= alpha;
      oy[i] *= alpha;
    }
    const float2* vv = reinterpret_cast<const float2*>(st.v);
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = exp2f(fmaf(acc[nt][e], scale_log2e, -m[i]));
        const float2 val = vv[nt * 8 + tq * 2 + (e & 1)];
        l[i] += p;
        ox[i] = fmaf(p, val.x, ox[i]);
        oy[i] = fmaf(p, val.y, oy[i]);
      }
    }
    __syncthreads();  // the stage is loaded again two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[i] += __shfl_xor_sync(kFull, l[i], off);
      ox[i] += __shfl_xor_sync(kFull, ox[i], off);
      oy[i] += __shfl_xor_sync(kFull, oy[i], off);
    }
  }
  if (tq == 0) {
    float2* o = reinterpret_cast<float2*>(out);
    if (row0 < L) o[row0] = make_float2(ox[0] / l[0], oy[0] / l[0]);
    if (row1 < L) o[row1] = make_float2(ox[1] / l[1], oy[1] / l[1]);
  }
}

}  // namespace

// q: (N, L, 128) bf16, k: (N, S, 128) bf16, v: (N, S, 2) fp32, out: (N, L,
// 2) fp32, contiguous, on the current device; scale_log2e: the scores'
// scale times log2(e).
extern "C" int upflow_global_match(const void* q, const void* k,
                                   const float* v, float* out, int N, int L,
                                   int S, float scale_log2e, void* stream) {
  if (N == 0 || L == 0) return 0;
  if (S <= 0 || N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + kRows - 1) / kRows, N);
  global_match_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, out, L, S, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}
