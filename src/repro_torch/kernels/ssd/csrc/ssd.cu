// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), with the final
// state: the chunk-parallel decomposition on the tensor cores. Plain C
// interface, loaded with ctypes by ../kernel.py; every entry launches on the
// caller's stream, allocates nothing (the wrapper passes y, the state and the
// scratch) and returns the first launch error.
//
// Layouts are the JAX package's: x (b, s, h, p), dt (b, s, h), A (h,)
// float32, B and C (b, s, g, n), y (b, s, h, p); x, dt, B, C and y all
// float32 or all bfloat16, the optional final state (b, h, p, n) float32.
// x, B and C may be row-strided: their (b, s) rows lie ldx, ldb and ldc
// elements apart (a multiple of 16 bytes), the rest of a row contiguous, as
// Mamba2Block's slices of its conv output are; dt and y are contiguous.
// Head hh reads group hh / (h / g). It computes ssd_chunked
// (repro_torch/kernels/ssd/ref.py): per chunk of T steps, with cum the
// running sum of dt * A from the chunk's start,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i . h_prev
//   h   = h_prev exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// Chunking does not change that function, only where sums are rounded: the
// kernels take T = 64 steps a chunk whatever chunk the caller's plain version
// uses. A ragged tail is steps with dt = 0 (and x, B, C = 0), as ssd_chunked
// pads it: they neither decay nor feed the state.
//
// Replaces: repro/kernels/ssd/kernel.py:67, ssd_pallas (_ssd_kernel), whose
// grid (b, h, s/chunk) carries the (p, n) state in VMEM scratch along its
// sequential ("arbitrary") chunk axis.
//
// Bound on this card: bytes (at Hymba-1.5B, p 64 and n 16, the scan does some
// tens of operations per byte of x and y, below the ~295 per byte where the
// bf16 tensor cores, or the ~50 where the fp32-accurate 3xTF32 rate, would
// be the limit).
//
// Design: the sequential chunk axis is the only serial part of the scan, so
// it is kept to one small pass, and everything else runs on b * nc * h
// independent tiles (nc = ceil(s / T): 6,400 tiles at Hymba's prefill). Four
// launches (the passes of the public Mamba-2 Triton implementation,
// mamba_ssm/ops/triton/ssd_combined.py, with its chunk cumsum folded into the
// two passes that need it):
//  1. ssd_cb_kernel, per (b, chunk, g): CB = C . B^T (T x T, fp32), once per
//     group, not per head: the heads of a group read it through L2.
//  2. ssd_state_kernel, per (b, chunk, h, 64 channels of p): cum by a warp scan;
//     the chunk's decay exp(cum_last); its state S = x^T (w o B), p x n, with
//     w_j = exp(cum_last - cum_j) dt_j.
//  3. ssd_pass_kernel, per (b, h) and element of p x n, serial over the chunks:
//     h_c = h_{c-1} exp(cum_last,c) + S_c, in ssd_chunked's rounding order
//     (a multiply, then an add). It overwrites S_c with h_{c-1}, the state
//     entering chunk c, and writes the final state.
//  4. ssd_scan_kernel, per (b, chunk, h, 64 channels of p): cum again (the same
//     code, so the same bits); the decayed scores M_ij = CB_ij exp(cum_i -
//     cum_j) dt_j for j <= i, with the mask applied BEFORE exp (above the
//     diagonal cum_i - cum_j is positive and exp could overflow to inf, and
//     inf * 0 is NaN); y = M x + exp(cum_i) (C h_{c-1}^T).
// Every product runs on the tensor cores through mma.sync, warp tiles read as
// fp32 from shared memory (rows padded so that fragment loads are
// conflict-free, see pitch()):
//  - bf16 entry: m16n8k16 bf16 -> fp32. x, B and C are bf16 inputs and enter
//    exactly. The fp32 factors enter as two bf16 terms, hi = rn(v) and lo =
//    rn(v - hi) (v within 2^-16 |v|): w o B in the chunk states, M in the
//    intra-chunk product, h_{c-1} in the inter-chunk read-out. CB (bf16 C and
//    B) is one term.
//  - f32 entry: m16n8k8 TF32 with the 3xTF32 split of phase_gemm.cuh (lo.hi +
//    hi.lo + hi.hi), each 32-deep K tile in a fresh accumulator chain added
//    to the running sum in fp32: an MMA rounds its sum toward zero, and one
//    TF32 term would miss the f32 prefill's 1e-4 check.
// Scratch, from the wrapper: CB (b, nc, g, T, T), the chunk states (b, h, nc,
// p, n) and the chunk decays (b, h, nc), all fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../deconv/csrc/phase_gemm.cuh"  // the mma.sync and TF32-split helpers

namespace {

using phase_gemm::allow_smem;
using phase_gemm::from_f;
using phase_gemm::mma_bf16;
using phase_gemm::mma_tf32;
using phase_gemm::split_tf32;
using phase_gemm::to_f;

constexpr int T = 64;         // steps per chunk
constexpr int PT = 64;        // head channels p per block of passes 2 and 4
constexpr int THREADS = 128;  // 4 warps
constexpr int KCHAIN = 32;    // f32: K per fresh accumulator chain
constexpr int PASS_THREADS = 256;

struct Geom {
  int b, s, h, p, g, nc, ptiles;
  int ldx, ldb, ldc;  // row strides of x, B and C, in elements
};

// Row pitch, in floats, of a shared-memory operand of ``cols`` columns (a
// multiple of 16). K-major: element (row, k) at row * pitch + k; otherwise
// (k, col) at k * pitch + col. The padding makes a warp's fragment loads hit
// 32 distinct banks: bf16 reads a K-major pair as one float2 (pitch = 8 mod
// 16) and the other layout as two scalars (4 mod 8); TF32 reads scalars,
// K-major (4 mod 8) or not (8 mod 16).
__host__ __device__ constexpr int pitch(int cols, bool kmajor, bool f32) {
  return cols + (kmajor != f32 ? 8 : 4);
}

__device__ __forceinline__ unsigned pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);  // .x, the lower column, in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// (hi, lo) bf16x2 terms of two fp32 values: hi = rn(v), lo = rn(v - hi)
__device__ __forceinline__ void split_bf16(float2 v, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(v.x - __bfloat162float(h.x), v.y - __bfloat162float(h.y));
}

// A (m, k) and B (k, n) elements of a shared-memory operand
template <bool KMAJ>
__device__ __forceinline__ float at(const float* s, int ld, int row, int k) {
  return KMAJ ? s[row * ld + k] : s[k * ld + row];
}

// (v(row, k), v(row, k + 1)): one float2 when K-major (k even, pitch even)
template <bool KMAJ>
__device__ __forceinline__ float2 pair(const float* s, int ld, int row, int k) {
  if constexpr (KMAJ) return *reinterpret_cast<const float2*>(s + row * ld + k);
  return make_float2(s[k * ld + row], s[(k + 1) * ld + row]);
}

// acc[MI][NI] (m16 x n8 fragments) += A[m0 .. m0 + 16 MI, k0 .. k1) B[k0 .. k1,
// n0 .. n0 + 8 NI), one warp. AK / BK: the operands' layouts (see pitch()).
// bf16 (F32 false): ASPLIT / BSPLIT mark the operand that enters as two bf16
// terms; the other is exact in bf16. The small products go first.
template <bool F32, int MI, int NI, bool AK, bool BK, bool ASPLIT, bool BSPLIT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MI][NI][4], const float* a, int lda, const float* b,
                                          int ldb, int m0, int n0, int k0, int k1) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  if constexpr (F32) {
    for (int kc = k0; kc < k1; kc += KCHAIN) {
      float tacc[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[mi][ni][e] = 0.f;
      const int ke = min(kc + KCHAIN, k1);
#pragma unroll 1
      for (int k = kc; k < ke; k += 8) {
        unsigned ah[MI][4], al[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = m0 + mi * 16 + gq;
          split_tf32(at<AK>(a, lda, r, k + tq), ah[mi][0], al[mi][0]);
          split_tf32(at<AK>(a, lda, r + 8, k + tq), ah[mi][1], al[mi][1]);
          split_tf32(at<AK>(a, lda, r, k + tq + 4), ah[mi][2], al[mi][2]);
          split_tf32(at<AK>(a, lda, r + 8, k + tq + 4), ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int c = n0 + ni * 8 + gq;
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(at<BK>(b, ldb, c, k + tq), bh0, bl0);
          split_tf32(at<BK>(b, ldb, c, k + tq + 4), bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_tf32(tacc[mi][ni], al[mi], bh0, bh1);
            mma_tf32(tacc[mi][ni], ah[mi], bl0, bl1);
            mma_tf32(tacc[mi][ni], ah[mi], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += tacc[mi][ni][e];
    }
  } else {
#pragma unroll 1
    for (int k = k0; k < k1; k += 16) {
      unsigned ah[MI][4], al[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = m0 + mi * 16 + gq;
        const float2 v[4] = {pair<AK>(a, lda, r, k + 2 * tq), pair<AK>(a, lda, r + 8, k + 2 * tq),
                             pair<AK>(a, lda, r, k + 2 * tq + 8), pair<AK>(a, lda, r + 8, k + 2 * tq + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (ASPLIT)
            split_bf16(v[e], ah[mi][e], al[mi][e]);
          else
            ah[mi][e] = pack_bf16(v[e].x, v[e].y);
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = n0 + ni * 8 + gq;
        const float2 v0 = pair<BK>(b, ldb, c, k + 2 * tq), v1 = pair<BK>(b, ldb, c, k + 2 * tq + 8);
        unsigned bh0, bl0 = 0, bh1, bl1 = 0;
        if constexpr (BSPLIT) {
          split_bf16(v0, bh0, bl0);
          split_bf16(v1, bh1, bl1);
        } else {
          bh0 = pack_bf16(v0.x, v0.y);
          bh1 = pack_bf16(v1.x, v1.y);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if constexpr (ASPLIT) mma_bf16(acc[mi][ni], al[mi], bh0, bh1);
          if constexpr (BSPLIT) mma_bf16(acc[mi][ni], ah[mi], bl0, bl1);
          mma_bf16(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// Inclusive scan of dt * a over a chunk's T = 64 steps, two steps per lane
// (one warp). Passes 2 and 4 both call it: the same code gives the same bits.
__device__ __forceinline__ void chunk_cum(const float* dts, float a, float* cum) {
  const int lane = threadIdx.x & 31;
  const float d0 = dts[2 * lane] * a, d1 = dts[2 * lane + 1] * a;
  float sc = d0 + d1;
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, sc, w);
    if (lane >= w) sc += up;
  }
  cum[2 * lane] = sc - d1;
  cum[2 * lane + 1] = sc;
}

// 16 bytes of X at src (4 f32 or 8 bf16 values) -> fp32
template <typename X>
__device__ __forceinline__ void load16(const X* src, float (&v)[16 / sizeof(X)]) {
  if constexpr (sizeof(X) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// E fp32 values -> shared memory at dst (16-byte aligned), as float4s
template <int E>
__device__ __forceinline__ void store_f4(float* dst, const float (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// dt of head hh over chunk c (0 past the end: the ragged tail)
template <typename X>
__device__ __forceinline__ void load_dt(const X* dt, float* dts, const Geom& gm, int bb, int c, int hh) {
  for (int r = threadIdx.x; r < T; r += THREADS) {
    const int t = c * T + r;
    dts[r] = t < gm.s ? to_f(dt[((size_t)bb * gm.s + t) * gm.h + hh]) : 0.f;
  }
}

// x of head hh, channels p0 .. p0 + PT, over chunk c -> xs[j][p] (0
// outside), in 16-byte chunks (p is a multiple of 16: a chunk never
// straddles its end; the wrapper aligns x)
template <typename X>
__device__ __forceinline__ void load_x(const X* x, float* xs, int ld, const Geom& gm, int bb, int c, int hh,
                                       int p0) {
  constexpr int E = 16 / sizeof(X), CPR = PT / E;
#pragma unroll 4
  for (int e = threadIdx.x; e < T * CPR; e += THREADS) {
    const int r = e / CPR, col = (e - r * CPR) * E;
    const int t = c * T + r, p = p0 + col;
    float v[E] = {};
    if (t < gm.s && p < gm.p) load16(x + ((size_t)bb * gm.s + t) * gm.ldx + hh * gm.p + p, v);
    store_f4(xs + r * ld + col, v);
  }
}

// B or C (row stride ldm) of group gg over chunk c -> s[j][n] (0 past the
// end), in 16-byte chunks
template <typename X, int N>
__device__ __forceinline__ void load_bc(const X* m, int ldm, float* s, int ld, const Geom& gm, int bb, int c,
                                        int gg) {
  constexpr int E = 16 / sizeof(X), CPR = N / E;
#pragma unroll 4
  for (int e = threadIdx.x; e < T * CPR; e += THREADS) {
    const int r = e / CPR, n = (e - r * CPR) * E;
    const int t = c * T + r;
    float v[E] = {};
    if (t < gm.s) load16(m + ((size_t)bb * gm.s + t) * ldm + gg * N + n, v);
    store_f4(s + r * ld + n, v);
  }
}

// ---- pass 1: CB = C . B^T per (chunk, group, batch row)
template <bool F32, int N>
constexpr size_t cb_smem() {
  return sizeof(float) * 2 * T * pitch(N, true, F32);
}

template <typename X, int N>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const X* __restrict__ Bm, const X* __restrict__ Cm, float* __restrict__ cb, Geom gm) {
  constexpr bool F32 = sizeof(X) == 4;
  constexpr int LD = pitch(N, true, F32);
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;         // C[i][n]: A, K-major
  float* Bs = Cs + T * LD;  // B[j][n]: B (k = n, col = j), K-major
  const int c = blockIdx.x, gg = blockIdx.y, bb = blockIdx.z;
  load_bc<X, N>(Cm, gm.ldc, Cs, LD, gm, bb, c, gg);
  load_bc<X, N>(Bm, gm.ldb, Bs, LD, gm, bb, c, gg);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // a 32 x 32 warp tile
  if (wn > wm) return;                      // above the diagonal: j > i everywhere, never read
  float acc[2][4][4];
  zero(acc);
  warp_gemm<F32, 2, 4, true, true, false, false>(acc, Cs, LD, Bs, LD, 32 * wm, 32 * wn, 0, N);
  float* out = cb + (((size_t)bb * gm.nc + c) * gm.g + gg) * T * T;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 32 * wm + 16 * mi + (lane >> 2) + 8 * hf, j = 32 * wn + 8 * ni + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + i * T + j) = make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
}

// ---- pass 2: the chunk states S = x^T (w o B) and the chunk decays
template <int N>
struct StateTile {  // 4 warps over the PT x N state: WM x WN warps of (16 MI) x (8 NI)
  static constexpr int WN = N >= 64 ? 2 : 1, WM = 4 / WN;
  static constexpr int MI = PT / WM / 16, NI = N / WN / 8;
};

template <bool F32, int N>
constexpr size_t state_smem() {
  return sizeof(float) * (T * pitch(PT, false, F32) + T * pitch(N, false, F32) + 2 * T);
}

template <typename X, int N>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const X* __restrict__ x, const X* __restrict__ dt, const float* __restrict__ A,
             const X* __restrict__ Bm, float* __restrict__ states, float* __restrict__ decay, Geom gm) {
  constexpr bool F32 = sizeof(X) == 4;
  constexpr int LX = pitch(PT, false, F32), LB = pitch(N, false, F32);
  using W = StateTile<N>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // x[j][p]: A = x^T (m = p, k = j), not K-major
  float* wbs = xs + T * LX;   // (w o B)[j][n]: B (k = j, col = n), not K-major
  float* dts = wbs + T * LB;  // T
  float* cum = dts + T;       // T
  const int c = blockIdx.x / gm.ptiles, p0 = (blockIdx.x - c * gm.ptiles) * PT;
  const int hh = blockIdx.y, bb = blockIdx.z, gg = hh / (gm.h / gm.g);
  load_dt(dt, dts, gm, bb, c, hh);
  load_x(x, xs, LX, gm, bb, c, hh, p0);
  load_bc<X, N>(Bm, gm.ldb, wbs, LB, gm, bb, c, gg);
  __syncthreads();
  if (threadIdx.x < 32) chunk_cum(dts, A[hh], cum);
  __syncthreads();
  const float last = cum[T - 1];
  for (int e = threadIdx.x; e < T * N; e += THREADS) {
    const int j = e / N, n = e - j * N;
    wbs[j * LB + n] *= expf(last - cum[j]) * dts[j];
  }
  if (threadIdx.x == 0 && p0 == 0) decay[((size_t)bb * gm.h + hh) * gm.nc + c] = expf(last);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / W::WN, wn = warp - wm * W::WN;
  const int m0 = wm * W::MI * 16, n0 = wn * W::NI * 8;
  float acc[W::MI][W::NI][4];
  zero(acc);
  warp_gemm<F32, W::MI, W::NI, false, false, false, true>(acc, xs, LX, wbs, LB, m0, n0, 0, T);
  float* out = states + (((size_t)bb * gm.h + hh) * gm.nc + c) * gm.p * N;
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + m0 + 16 * mi + (lane >> 2) + 8 * hf, n = n0 + 8 * ni + 2 * (lane & 3);
        if (p < gm.p)
          *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
}

// ---- pass 3: state passing, serial over the chunks. states[c] := h_{c-1}.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay, float* __restrict__ state, int nc,
            int pn) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= pn) return;
  const size_t bh = blockIdx.y;
  float* sp = states + bh * nc * pn + e;
  const float* dp = decay + bh * nc;
  float hprev = 0.f;
  constexpr int AHEAD = 8;  // chunk states loaded before the first is used: 8 loads in flight, not 1
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float sc[AHEAD], dc[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      sc[i] = c0 + i < nc ? sp[(size_t)(c0 + i) * pn] : 0.f;
      dc[i] = c0 + i < nc ? dp[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (c0 + i >= nc) break;
      sp[(size_t)(c0 + i) * pn] = hprev;
      hprev = __fadd_rn(__fmul_rn(hprev, dc[i]), sc[i]);  // ssd_chunked's order: multiply, then add
    }
  }
  if (state != nullptr) state[bh * pn + e] = hprev;
}

// ---- pass 4: the chunk scan y = M x + exp(cum_i) C h_{c-1}^T
template <bool F32, int N>
constexpr size_t scan_smem() {
  return sizeof(float) *
         (T * pitch(T, true, F32) + T * pitch(PT, false, F32) + T * pitch(N, true, F32) + PT * pitch(N, true, F32) + 2 * T);
}

template <typename X, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const X* __restrict__ x, const X* __restrict__ dt, const float* __restrict__ A,
            const X* __restrict__ Cm, const float* __restrict__ cb, const float* __restrict__ states,
            X* __restrict__ y, Geom gm) {
  constexpr bool F32 = sizeof(X) == 4;
  constexpr int LM = pitch(T, true, F32), LX = pitch(PT, false, F32), LC = pitch(N, true, F32);
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;          // M[i][j]: A, K-major
  float* xs = ms + T * LM;   // x[j][p]: B (k = j, col = p), not K-major
  float* cs = xs + T * LX;   // C[i][n]: A, K-major
  float* hs = cs + T * LC;   // h_{c-1}[p][n]: B (k = n, col = p), K-major
  float* dts = hs + PT * LC;  // T
  float* cum = dts + T;       // T
  const int c = blockIdx.x / gm.ptiles, p0 = (blockIdx.x - c * gm.ptiles) * PT;
  const int hh = blockIdx.y, bb = blockIdx.z, gg = hh / (gm.h / gm.g);
  load_dt(dt, dts, gm, bb, c, hh);
  load_x(x, xs, LX, gm, bb, c, hh, p0);
  load_bc<X, N>(Cm, gm.ldc, cs, LC, gm, bb, c, gg);
  const float* hsrc = states + (((size_t)bb * gm.h + hh) * gm.nc + c) * gm.p * N;
#pragma unroll 4
  for (int e = threadIdx.x; e < PT * N / 4; e += THREADS) {
    const int r = e / (N / 4), n = (e - r * (N / 4)) * 4;
    float v[4] = {};
    if (c > 0 && p0 + r < gm.p) load16(hsrc + (size_t)(p0 + r) * N + n, v);  // chunk 0 enters with 0
    store_f4(hs + r * LC + n, v);
  }
  const float* cbsrc = cb + (((size_t)bb * gm.nc + c) * gm.g + gg) * T * T;
#pragma unroll 4
  for (int e = threadIdx.x; e < T * T / 4; e += THREADS) {
    const int i = e / (T / 4), j = (e - i * (T / 4)) * 4;
    float v[4] = {};
    if (j <= i) load16(cbsrc + i * T + j, v);  // only the causal part of CB is ever written
    store_f4(ms + i * LM + j, v);
  }
  __syncthreads();
  if (threadIdx.x < 32) chunk_cum(dts, A[hh], cum);
  __syncthreads();
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int i = e / T, j = e - i * T;
    // masked first: exp only of cum_i - cum_j <= 0; above the diagonal 0
    ms[i * LM + j] = j <= i ? ms[i * LM + j] * (expf(cum[i] - cum[j]) * dts[j]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // a 32 x 32 warp tile of the T x PT output
  float intra[2][4][4], inter[2][4][4];
  zero(intra);
  zero(inter);
  // rows 32 wm .. 32 wm + 31 read keys j <= i only
  warp_gemm<F32, 2, 4, true, false, true, false>(intra, ms, LM, xs, LX, 32 * wm, 32 * wn, 0, 32 * (wm + 1));
  if (c > 0) warp_gemm<F32, 2, 4, true, true, false, true>(inter, cs, LC, hs, LC, 32 * wm, 32 * wn, 0, N);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 32 * wm + 16 * mi + (lane >> 2) + 8 * hf;
      const int t = c * T + i;
      if (t >= gm.s) continue;
      const float ei = expf(cum[i]);
      X* yrow = y + (((size_t)bb * gm.s + t) * gm.h + hh) * gm.p;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int p = p0 + 32 * wn + 8 * ni + 2 * (lane & 3);  // even: p and p + 1, one store
        if (p >= gm.p) continue;
        const float v0 = intra[mi][ni][2 * hf] + inter[mi][ni][2 * hf] * ei;
        const float v1 = intra[mi][ni][2 * hf + 1] + inter[mi][ni][2 * hf + 1] * ei;
        if constexpr (sizeof(X) == 4)
          *reinterpret_cast<float2*>(yrow + p) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <typename X, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
           void* cb, void* states, void* decay, const Geom& gm, cudaStream_t stream) {
  constexpr bool F32 = sizeof(X) == 4;
  static unsigned done[3] = {0, 0, 0};
  int err = allow_smem(ssd_cb_kernel<X, N>, cb_smem<F32, N>(), done[0]);
  if (!err) err = allow_smem(ssd_state_kernel<X, N>, state_smem<F32, N>(), done[1]);
  if (!err) err = allow_smem(ssd_scan_kernel<X, N>, scan_smem<F32, N>(), done[2]);
  if (err) return err;
  const X* xx = static_cast<const X*>(x);
  const X* dd = static_cast<const X*>(dt);
  const float* aa = static_cast<const float*>(A);
  float* cbp = static_cast<float*>(cb);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  ssd_cb_kernel<X, N><<<dim3(gm.nc, gm.g, gm.b), THREADS, cb_smem<F32, N>(), stream>>>(
      static_cast<const X*>(B), static_cast<const X*>(C), cbp, gm);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 tiles(gm.nc * gm.ptiles, gm.h, gm.b);
  ssd_state_kernel<X, N><<<tiles, THREADS, state_smem<F32, N>(), stream>>>(xx, dd, aa, static_cast<const X*>(B), sts,
                                                                      dec, gm);
  if ((err = (int)cudaGetLastError())) return err;
  const int pn = gm.p * N;
  ssd_pass_kernel<<<dim3((pn + PASS_THREADS - 1) / PASS_THREADS, gm.b * gm.h), PASS_THREADS, 0, stream>>>(
      sts, dec, static_cast<float*>(state), gm.nc, pn);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_scan_kernel<X, N><<<tiles, THREADS, scan_smem<F32, N>(), stream>>>(xx, dd, aa, static_cast<const X*>(C), cbp,
                                                                    sts, static_cast<X*>(y), gm);
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
             void* cb, void* states, void* decay, int b, int s, int h, int p, int g, int n, int ldx, int ldb,
             int ldc, void* stream) {
  const Geom gm{b, s, h, p, g, (s + T - 1) / T, (p + PT - 1) / PT, ldx, ldb, ldc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<X, 16>(x, dt, A, B, C, y, state, cb, states, decay, gm, st);
    case 32: return launch<X, 32>(x, dt, A, B, C, y, state, cb, states, decay, gm, st);
    case 64: return launch<X, 64>(x, dt, A, B, C, y, state, cb, states, decay, gm, st);
    case 128: return launch<X, 128>(x, dt, A, B, C, y, state, cb, states, decay, gm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (b,s,h,p), dt (b,s,h), A (h) float32, B/C (b,s,g,n) -> y (b,s,h,p) and,
// when state is not null, the final state (b,h,p,n) float32. ldx, ldb, ldc:
// the row strides of x, B and C in elements (h*p and g*n when contiguous).
// Scratch, float32: cb b*nc*g*64*64, states b*h*nc*p*n, decay b*h*nc, with
// nc = ceil(s / 64).
int ssd_f32(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
            void* cb, void* states, void* decay, int b, int s, int h, int p, int g, int n, int ldx, int ldb, int ldc,
            void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, state, cb, states, decay, b, s, h, p, g, n, ldx, ldb, ldc, stream);
}

int ssd_bf16(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
             void* cb, void* states, void* decay, int b, int s, int h, int p, int g, int n, int ldx, int ldb,
             int ldc, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, state, cb, states, decay, b, s, h, p, g, n, ldx, ldb, ldc,
                                 stream);
}

// Dynamic shared memory of each pass (cb, state, scan), in bytes, for
// esize-byte operands and state width n.
long long ssd_smem_bytes(int esize, int n, int pass) {
  const bool f32 = esize == 4;
  switch (n * 4 + pass) {
#define SSD_SMEM(N)                                                                        \
  case N * 4 + 0: return (long long)(f32 ? cb_smem<true, N>() : cb_smem<false, N>());       \
  case N * 4 + 1: return (long long)(f32 ? state_smem<true, N>() : state_smem<false, N>()); \
  case N * 4 + 2: return (long long)(f32 ? scan_smem<true, N>() : scan_smem<false, N>());
    SSD_SMEM(16)
    SSD_SMEM(32)
    SSD_SMEM(64)
    SSD_SMEM(128)
#undef SSD_SMEM
    default: return -1;
  }
}

const char* ssd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
