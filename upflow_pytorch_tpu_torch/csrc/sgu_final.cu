// Final SGU stage for Hopper: for one direction, from the quarter-
// resolution flow fq (B, 2, Hq, Wq), SGU head output xo (B, 3, Hq, Wq)
// and mask mq = sigmoid(xo[:, 2]) (B, 1, Hq, Wq),
//     flow  = upsample2d_flow_as(fq, (H, W), if_rate=True)
//     iflow = upsample2d_flow_as(xo[:, :2], (H, W), if_rate=True)
//     m     = upsample2d_as(mq, (H, W))
//     out   = warp(flow, iflow) * (1 - m) + flow * m
// with the align_corners=True bilinear resize and warp = tools.torch_warp.
//
// Replaces the TPU kernel upflow_pytorch_tpu/ops/pallas/sgu_final.py
// (sgu_final_pallas, the +-2 px fused tier) and, with it, the medium tier
// of models/upflow.py::_sgu_final_op_impl (planar resizes and the windowed
// warp of ops/pallas/warp.py::_window_warp_resident) and its XLA fallback.
//
// Bound on the H100: bytes.  It writes 2 full-resolution planes and reads
// 5 quarter-resolution ones: at B=4, 384x1280 that is 15.7 + 2.5 MB, a
// bound of about 5.4 us.  What a pixel needs is gathered: the resize of 5
// planes at the pixel and of 2 planes at the warp's 4 taps, 76 scalar
// loads a pixel when each is read from device memory.  What paces this
// design is the pixel phase's instruction issue, not its loads (the
// ablations and clock64 phases of scripts/torch_sgu_final_ablate.py).
// Design:
// - A block owns a TY x 128 output tile; each thread computes 4 adjacent
//   pixels of a row and stores them with one 16-byte store a plane where
//   the rows allow.  No full-resolution intermediate reaches device memory.
// - The resize is separable and rows come first (as the plain version's
//   products), so the value at (Y, X) is the column lerp of two row-lerped
//   values R(Y, c) at quarter-resolution columns c.  Each block stages in
//   shared memory, once: the lerp tables (ops/resize.py::interp_taps) of
//   its rows and columns with a halo of kHalo pixels each side, one entry
//   a 16-byte load; the quarter-resolution patches that they reach, by
//   cp.async copies all in flight at once; then, from those, the
//   row-lerped values R of u and v (one float2) over the halo.  A warp
//   tap is then 2 float2 loads and 2 lerps, with one column entry for
//   each of the taps' two columns; the inter-flow and the mask at the
//   pixel lerp the raw patch (4 loads and 3 lerps a plane).  That keeps a
//   block at 73 KB (32-row tiles), so three blocks fit an SM.
// - The taps of the staged box load and blend without a branch: a tap
//   outside the image reads the pixel's own row or column and is zeroed
//   after the load.
// - The coordinate roundtrip divides by the image size less one at every
//   pixel, twice: a correctly rounded division by a reciprocal computed
//   once (warp_common.cuh::div_rn) replaces __fdiv_rn's range check and
//   call, which took a third of the first tiled design's time.
// - Taps farther than kHalo pixels (inter-flows beyond +-36 px at full
//   resolution, +-9 px at quarter) read the planes and tables from device
//   memory with the same arithmetic, so every inter-flow magnitude is
//   served: the TPU's tiers, its extended patches and its lax.cond are gone.
// - The arithmetic is the previous one op for op: the rate scales
//   multiply after the resize, as upsample2d_flow_as does, and every step
//   is a correctly rounded intrinsic in the plain version's op order.
//   Each two-tap lerp rounds as the plain version's matrix product
//   accumulates over the source index (w0*a rounded, then one fma of
//   w1*b), because the warp turns an ulp of a sample coordinate into ulp x
//   the flow's slope, which is steep where a sample leaves the image.
// - Width sharding (parallel/spatial.py): the output may be the columns
//   [x0, x0 + w_out) of the W-column frame.  The tiles then start at x0,
//   every column of the tables, the staged box and the taps is global
//   (x0 + a local column, an integer add before any float conversion),
//   the column tables stay over the whole W, and only the stores use the
//   local column.  x0 = 0, w_out = W is the whole frame, launched with
//   kWhole, which makes them compile-time constants: the offset's index
//   arithmetic costs the whole frame 5% of its device time otherwise.
#include <cuda_runtime.h>

#include "per_device.cuh"
#include "warp_common.cuh"

namespace {

constexpr int kTileX = 128;           // output columns of a tile
constexpr int kPx = 4;                // adjacent pixels of a thread
constexpr int kLanes = kTileX / kPx;  // 32: a warp spans the tile's width
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kHalo = 40;  // pixels beyond the tile whose taps are staged
constexpr int kCols = kTileX + 2 * kHalo;  // staged column table entries
// quarter-resolution columns staged: those the halo spans (at most 54 at
// a x4 upsample) and those of the tile itself (at most 34); a wider span
// (a resize by less than x4) sends the block to device memory
constexpr int kQC = 54;
constexpr int kQO = 40;

// One output index of a resize: the two source indices and their weights.
struct Lerp {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Lerp lerp_at(const int* __restrict__ idx,
                                        const float* __restrict__ wt, int o) {
  return Lerp{__ldg(idx + 2 * o), __ldg(idx + 2 * o + 1), __ldg(wt + 2 * o),
              __ldg(wt + 2 * o + 1)};
}

// a table entry staged as one 16-byte word
__device__ __forceinline__ int4 pack(const Lerp& l) {
  return make_int4(l.i0, l.i1, __float_as_int(l.w0), __float_as_int(l.w1));
}
__device__ __forceinline__ Lerp unpack(int4 v) {
  return Lerp{v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
}

// w0*a + w1*b rounded as a matrix product accumulates it: the first term
// rounded, the second added by one fused multiply-add.
__device__ __forceinline__ float mix(float a, float b, const Lerp& l) {
  return __fmaf_rn(l.w1, b, __fmul_rn(l.w0, a));
}

// The value at (y, x) of the resized plane q (wq columns, not yet
// rate-scaled), read from device memory: rows first, then columns.
__device__ __forceinline__ float resized_ldg(const float* __restrict__ q,
                                             int wq, const Lerp& r,
                                             const Lerp& c) {
  const float* q0 = q + r.i0 * wq;
  const float* q1 = q + r.i1 * wq;
  return mix(mix(__ldg(q0 + c.i0), __ldg(q1 + c.i0), r),
             mix(__ldg(q0 + c.i1), __ldg(q1 + c.i1), r), c);
}

// u and v resized at (y, x) from device memory: the taps that land
// outside the staged halo, and every sample of a block whose staged box
// does not fit the shared memory.
__device__ __noinline__ float2 uv_ldg(const float* __restrict__ up,
                                      const float* __restrict__ vp, int wq,
                                      const int* __restrict__ row_idx,
                                      const float* __restrict__ row_wt,
                                      const int* __restrict__ col_idx,
                                      const float* __restrict__ col_wt, int y,
                                      int x) {
  const Lerp r = lerp_at(row_idx, row_wt, y), c = lerp_at(col_idx, col_wt, x);
  return make_float2(resized_ldg(up, wq, r, c), resized_ldg(vp, wq, r, c));
}

// The blended output (u, v) of a pixel from its own resized samples (not
// yet rate-scaled) and its taps (scaled, zero outside the image).
__device__ __forceinline__ float2 blended(const float2 tap[4],
                                          const upflow::Taps& t, float2 own,
                                          float m, float su, float sv) {
  return make_float2(
      upflow::blend(upflow::tap_sum(tap[0].x, tap[1].x, tap[2].x, tap[3].x, t),
                    __fmul_rn(own.x, su), m),
      upflow::blend(upflow::tap_sum(tap[0].y, tap[1].y, tap[2].y, tap[3].y, t),
                    __fmul_rn(own.y, sv), m));
}

// One output pixel (u, v) computed from device memory alone.
__device__ __noinline__ float2 pixel_ldg(
    const float* __restrict__ up, const float* __restrict__ vp,
    const float* __restrict__ iup, const float* __restrict__ ivp,
    const float* __restrict__ mp, int wq, const int* __restrict__ row_idx,
    const float* __restrict__ row_wt, const int* __restrict__ col_idx,
    const float* __restrict__ col_wt, int y, int x, int H, int W, float su,
    float sv, upflow::Divisor dx, upflow::Divisor dy) {
  const Lerp r = lerp_at(row_idx, row_wt, y), c = lerp_at(col_idx, col_wt, x);
  const float iu = __fmul_rn(resized_ldg(iup, wq, r, c), su);
  const float iv = __fmul_rn(resized_ldg(ivp, wq, r, c), sv);
  const upflow::Taps t = upflow::bilinear_taps(iu, iv, x, y, H, W, dx, dy);
  const bool in[4] = {t.in00, t.in01, t.in10, t.in11};
  float2 tap[4] = {};
  for (int k = 0; k < 4; ++k) {
    if (!in[k]) continue;
    const float2 v = uv_ldg(up, vp, wq, row_idx, row_wt, col_idx, col_wt,
                            k < 2 ? t.yi : t.yj, k % 2 ? t.xj : t.xi);
    tap[k] = make_float2(__fmul_rn(v.x, su), __fmul_rn(v.y, sv));
  }
  return blended(tap, t,
                 make_float2(resized_ldg(up, wq, r, c),
                             resized_ldg(vp, wq, r, c)),
                 resized_ldg(mp, wq, r, c), su, sv);
}

// The shared memory of a TY-row tile, in 4-byte words: the column and row
// tables (16 bytes an entry); R of u and v (float2, kRows x kQC); and the
// raw quarter-resolution patches: u and v interleaved (float2, kQR x
// kQC), and iu, iv and m (3 x kQRO x kQO).
template <int TY>
struct Smem {
  static constexpr int kRows = TY + 2 * kHalo;
  static constexpr int kQR = kRows / 4 + 4;  // quarter rows of the halo
  static constexpr int kQRO = TY / 4 + 4;    // and of the tile
  static constexpr int kColTab = 4 * kCols;
  static constexpr int kRowTab = 4 * kRows;
  static constexpr int kUV = 2 * kRows * kQC;
  static constexpr int kRawUV = 2 * kQR * kQC;
  static constexpr int kRawOwn = 3 * kQRO * kQO;
  static constexpr int kWords = kColTab + kRowTab + kUV + kRawUV + kRawOwn;
  static constexpr size_t kBytes = 4 * static_cast<size_t>(kWords);
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int TY, bool kWhole>
__global__ void __launch_bounds__(kThreads, 3)
sgu_final_kernel(const float* __restrict__ fq, const float* __restrict__ xo,
                 const float* __restrict__ mq, const int* __restrict__ row_idx,
                 const float* __restrict__ row_wt,
                 const int* __restrict__ col_idx,
                 const float* __restrict__ col_wt, float* __restrict__ out,
                 int Hq, int Wq, int H, int W, int w_out, int x0, float su,
                 float sv, int vec_out) {
  if (kWhole) {
    w_out = W;
    x0 = 0;
  }
  using S = Smem<TY>;
  extern __shared__ __align__(16) float smem[];
  int4* col_tab = reinterpret_cast<int4*>(smem);
  int4* row_tab = reinterpret_cast<int4*>(smem + S::kColTab);
  float2* r_uv = reinterpret_cast<float2*>(smem + S::kColTab + S::kRowTab);
  float2* raw_uv = r_uv + kQC * S::kRows;
  float* raw_own = smem + S::kColTab + S::kRowTab + S::kUV + S::kRawUV;

  const int tid = threadIdx.x;
  const int lane = tid % kLanes, warp = tid / kLanes;
  // the tile's first global column and row; x_out the end of the output
  const int tx = x0 + blockIdx.x * kTileX, y0 = blockIdx.y * TY;
  const int x_out = x0 + w_out;
  const int b = blockIdx.z;
  const int pq = Hq * Wq;
  const float* up = fq + static_cast<size_t>(b) * 2 * pq;
  const float* vp = up + pq;
  const float* iup = xo + static_cast<size_t>(b) * 3 * pq;
  const float* ivp = iup + pq;
  const float* mp = mq + static_cast<size_t>(b) * pq;
  const upflow::Divisor dx = upflow::roundtrip_divisor(W);
  const upflow::Divisor dy = upflow::roundtrip_divisor(H);
  const int xt = tx + kPx * lane;
  const size_t plane = static_cast<size_t>(H) * w_out;
  float* ou = out + static_cast<size_t>(b) * 2 * plane;
  float* ov = ou + plane;
  // stores a thread's 4 pixels of row y: one 16-byte store a plane where
  // the row allows
  auto store = [&](int y, const float2 (&res)[kPx]) {
    const size_t o = static_cast<size_t>(y) * w_out + (xt - x0);
    if (vec_out && xt + kPx <= x_out) {
      *reinterpret_cast<float4*>(ou + o) =
          make_float4(res[0].x, res[1].x, res[2].x, res[3].x);
      *reinterpret_cast<float4*>(ov + o) =
          make_float4(res[0].y, res[1].y, res[2].y, res[3].y);
    } else {
      for (int p = 0; p < kPx && xt + p < x_out; ++p) {
        ou[o + p] = res[p].x;
        ov[o + p] = res[p].y;
      }
    }
  };

  // the staged box: columns [xs0, xs0 + kCols) and rows [yr0, yr1) at
  // full resolution; the quarter-resolution columns [cq0, cq0 + nq) and
  // rows [qr0, qr0 + nqr) they reach, and the tile's, [co0, co0 + no) and
  // [qo0, qo0 + nqo).  The resize tables are monotonic, so the first and
  // the last entry bound them.  A box larger than the shared memory (a
  // resize by less than x4) sends the block to device memory.
  const int xs0 = tx - kHalo;
  const int yr0 = max(0, y0 - kHalo), yr1 = min(H, y0 + TY + kHalo);
  const int n_rows = yr1 - yr0;
  const int own_rows = min(TY, H - y0);
  const int x_end = min(x_out, tx + kTileX);
  const int cq0 = __ldg(col_idx + 2 * max(0, xs0));
  const int nq = __ldg(col_idx + 2 * (min(W, xs0 + kCols) - 1) + 1) + 1 - cq0;
  const int co0 = __ldg(col_idx + 2 * tx);
  const int no = __ldg(col_idx + 2 * (x_end - 1) + 1) + 1 - co0;
  const int qr0 = __ldg(row_idx + 2 * yr0);
  const int nqr = __ldg(row_idx + 2 * (yr1 - 1) + 1) + 1 - qr0;
  const int qo0 = __ldg(row_idx + 2 * y0);
  const int nqo = __ldg(row_idx + 2 * (y0 + own_rows - 1) + 1) + 1 - qo0;
  if (nq > kQC || no > kQO || nqr > S::kQR || nqo > S::kQRO) {
    for (int i = warp; i < own_rows; i += kWarps) {
      float2 res[kPx];
      for (int p = 0; p < kPx; ++p)
        res[p] = xt + p < x_out
                     ? pixel_ldg(up, vp, iup, ivp, mp, Wq, row_idx, row_wt,
                                 col_idx, col_wt, y0 + i, xt + p, H, W, su,
                                 sv, dx, dy)
                     : make_float2(0.0f, 0.0f);
      store(y0 + i, res);
    }
    return;
  }

  // the raw patches, every copy in flight at once: a warp a row, its
  // lanes along the row
  for (int i = warp; i < nqr; i += kWarps) {
    const int g = (qr0 + i) * Wq + cq0;
    for (int c = lane; c < nq; c += kLanes) {
      float* d = reinterpret_cast<float*>(raw_uv + i * kQC + c);
      cp_async4(d, up + g + c);
      cp_async4(d + 1, vp + g + c);
    }
  }
  for (int rr = warp; rr < 3 * nqo; rr += kWarps) {
    const int p = rr / nqo, i = rr - p * nqo;
    const float* q = p == 0 ? iup : p == 1 ? ivp : mp;
    const int g = (qo0 + i) * Wq + co0;
    for (int c = lane; c < no; c += kLanes)
      cp_async4(raw_own + (p * S::kQRO + i) * kQO + c, q + g + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < kCols; i += kThreads) {
    const int x = xs0 + i;
    if (x >= 0 && x < W) col_tab[i] = pack(lerp_at(col_idx, col_wt, x));
  }
  for (int i = tid; i < n_rows; i += kThreads)
    row_tab[i] = pack(lerp_at(row_idx, row_wt, yr0 + i));
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the tables and the raw patches

  // R of u and v over the box's rows: a warp a row, its lanes along the
  // row (at most two columns each), the loads of two rows in flight
#pragma unroll 2
  for (int i = warp; i < n_rows; i += kWarps) {
    const Lerp r = unpack(row_tab[i]);
    const float2* a0 = raw_uv + (r.i0 - qr0) * kQC;
    const float2* a1 = raw_uv + (r.i1 - qr0) * kQC;
#pragma unroll
    for (int k = 0; k < kQC; k += kLanes) {
      const int c = k + lane;
      if (c >= nq) break;
      const float2 u0 = a0[c], u1 = a1[c];
      r_uv[i * kQC + c] = make_float2(mix(u0.x, u1.x, r), mix(u0.y, u1.y, r));
    }
  }
  __syncthreads();

  // u and v resized (not yet rate-scaled) at staged row i of R, column
  // entry c
  auto uv_at = [&](int i, const Lerp& c) {
    const float2* r = r_uv + i * kQC - cq0;
    const float2 a = r[c.i0], bb = r[c.i1];
    return make_float2(mix(a.x, bb.x, c), mix(a.y, bb.y, c));
  };
  for (int i = warp; i < own_rows; i += kWarps) {
    const int y = y0 + i;
    // the raw rows of the tile's row y, for the inter-flow and the mask
    const Lerp r = unpack(row_tab[y - yr0]);
    const float* o0 = raw_own + (r.i0 - qo0) * kQO - co0;
    const float* o1 = raw_own + (r.i1 - qo0) * kQO - co0;
    // plane p of iu, iv, m resized at column entry c
    auto own_at = [&](int p, const Lerp& c) {
      const int d = p * S::kQRO * kQO;
      return mix(mix(o0[d + c.i0], o1[d + c.i0], r),
                 mix(o0[d + c.i1], o1[d + c.i1], r), c);
    };
    float2 res[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      // past the output's edge: computed, unused
      const int x = min(xt + p, x_out - 1);
      const Lerp c = unpack(col_tab[x - xs0]);
      const float iu = __fmul_rn(own_at(0, c), su);
      const float iv = __fmul_rn(own_at(1, c), sv);
      const float m = own_at(2, c);
      const float2 own = uv_at(y - yr0, c);
      const upflow::Taps t =
          upflow::bilinear_taps(iu, iv, x, y, H, W, dx, dy);
      // the taps' rows and columns, the pixel's own where a pair of taps
      // is outside the image, each looked up once
      const int ya = t.in00 || t.in01 ? t.yi : y;
      const int yb = t.in10 || t.in11 ? t.yj : y;
      const int xa = t.in00 || t.in10 ? t.xi : x;
      const int xb = t.in01 || t.in11 ? t.xj : x;
      const bool in[4] = {t.in00, t.in01, t.in10, t.in11};
      float2 tap[4];
      if (static_cast<unsigned>(ya - yr0) < static_cast<unsigned>(n_rows) &&
          static_cast<unsigned>(yb - yr0) < static_cast<unsigned>(n_rows) &&
          static_cast<unsigned>(xa - xs0) < static_cast<unsigned>(kCols) &&
          static_cast<unsigned>(xb - xs0) < static_cast<unsigned>(kCols)) {
        const Lerp ca = unpack(col_tab[xa - xs0]);
        const Lerp cb = unpack(col_tab[xb - xs0]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 v = uv_at((k < 2 ? ya : yb) - yr0, k % 2 ? cb : ca);
          tap[k] = in[k] ? make_float2(__fmul_rn(v.x, su), __fmul_rn(v.y, sv))
                         : make_float2(0.0f, 0.0f);
        }
      } else {
        for (int k = 0; k < 4; ++k) {
          tap[k] = make_float2(0.0f, 0.0f);
          if (!in[k]) continue;
          const float2 v = uv_ldg(up, vp, Wq, row_idx, row_wt, col_idx,
                                  col_wt, k < 2 ? ya : yb, k % 2 ? xb : xa);
          tap[k] = make_float2(__fmul_rn(v.x, su), __fmul_rn(v.y, sv));
        }
      }
      res[p] = blended(tap, t, own, m, su, sv);
    }
    store(y, res);
  }
}

template <int TY, bool kWhole>
int launch(const float* fq, const float* xo, const float* mq,
           const int* row_idx, const float* row_wt, const int* col_idx,
           const float* col_wt, float* out, int B, int Hq, int Wq, int H,
           int W, int w_out, int x0, float su, float sv,
           cudaStream_t stream) {
  static upflow::PerDevice attrs;
  const cudaError_t e = attrs.once([] {
    return cudaFuncSetAttribute(sgu_final_kernel<TY, kWhole>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Smem<TY>::kBytes));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w_out + kTileX - 1) / kTileX, (H + TY - 1) / TY, B);
  // 16-byte stores need rows of whole float4s (the output is allocated
  // by torch, so its base is aligned)
  const int vec_out = w_out % kPx == 0;
  sgu_final_kernel<TY, kWhole><<<grid, kThreads, Smem<TY>::kBytes,
                                 stream>>>(
      fq, xo, mq, row_idx, row_wt, col_idx, col_wt, out, Hq, Wq, H, W, w_out,
      x0, su, sv, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fq: (B, 2, Hq, Wq), xo: (B, 3, Hq, Wq), mq: (B, 1, Hq, Wq) fp32;
// row_idx/row_wt: (H, 2) int32/fp32 and col_idx/col_wt: (W, 2), the
// resize's source indices and weights per output row and column;
// su = W / Wq, sv = H / Hq in fp32; out: (B, 2, H, w_out), the frame's
// columns [x0, x0 + w_out) (0 <= x0, x0 + w_out <= W); ty: tile rows (16
// or 32).  All contiguous on the current device.
extern "C" int upflow_sgu_final(const float* fq, const float* xo,
                                const float* mq, const int* row_idx,
                                const float* row_wt, const int* col_idx,
                                const float* col_wt, float* out, int B, int Hq,
                                int Wq, int H, int W, int w_out, int x0,
                                float su, float sv, int ty, void* stream) {
  if (x0 < 0 || w_out < 0 || x0 + w_out > W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || w_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ty != 16 && ty != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (x0 == 0 && w_out == W)
    return (ty == 16 ? launch<16, true> : launch<32, true>)(
        fq, xo, mq, row_idx, row_wt, col_idx, col_wt, out, B, Hq, Wq, H, W,
        w_out, x0, su, sv, s);
  return (ty == 16 ? launch<16, false> : launch<32, false>)(
      fq, xo, mq, row_idx, row_wt, col_idx, col_wt, out, B, Hq, Wq, H, W,
      w_out, x0, su, sv, s);
}

