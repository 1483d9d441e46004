// Fused serving blocks for Hopper (sm_90a): conv/deconv + bias + norm + act,
// and the SPPF max-pool pyramid. Plain C interface, loaded with ctypes by
// ../kernel.py; every entry launches on the caller's stream, allocates
// nothing (the wrapper passes outputs and scratch) and returns
// cudaGetLastError().
//
// Layouts are the JAX package's: activations NHWC, weights (kh, kw, Cin, Cout).
// conv_block and deconv_block take x, w and y all float32
// (fused_conv_block_f32) or all bfloat16 (fused_conv_block_bf16), with bias,
// gamma and beta float32 and fp32 accumulation; SPPF takes either dtype.
//
// conv_block (deconv = 0)
//   Replaces: repro/kernels/fused/kernel.py, conv_block_pallas
//   (_conv_block_kernel, _norm_act).
//   Bound on this card: operations for the wide layers (K = k*k*Cin up to
//   8192), weight bytes for the deep 1x1/2x2 layers whose M = B*Ho*Wo is
//   1..4 rows, activation bytes for the narrow YOLOv8 layers.
//   Design: the TPU kernel keeps a whole sample in VMEM; a 128x128x64 fp32
//   sample (4 MB) is far beyond 227 KB of shared memory, so the block splits
//   into (a) an implicit-GEMM conv (conv_gemm_kernel), M = B*Ho*Wo, N = Cout,
//   K = k*k*Cin in tap-major order, on the tensor cores through the K loop
//   of ../../deconv/csrc/phase_gemm.cuh (gemm_k_loop): 3xTF32 for float32,
//   m16n8k16 for bfloat16, a 3-stage cp.async ring of 128-byte K tiles, 16-byte copies
//   when Cin and Cout hold whole 16-byte chunks (a chunk never straddles two
//   taps; x and w 16-byte aligned), element staging otherwise (the Cin-3
//   stems). Output row (oh, ow) reads input (oh*s - p + di, ow*s - p + dj)
//   through tap (di, dj); a tap that reaches no input for any row of the
//   block is skipped before its weights load (the block votes, for k <= 5:
//   at the Pix2Pix 2x2 -> 1x1 conv 4 of 16 taps are live; a larger kernel
//   walks every tap). Bias (and the act, when
//   there is no norm) in the epilogue; layers with too few output tiles to
//   fill the card split the block's live K tiles over blocks into a partial
//   buffer that one pass sums in a fixed order (no atomics, so results are
//   bit-reproducible); (b) per-(stats set, group) mean and variance by
//   Welford per thread and Chan's merge across threads and row chunks, in a
//   fixed order; the stats set is the sample for instance/group norm and the
//   whole batch for batch norm, so B > 1 batch norm is exact; (c) normalise,
//   scale, shift and activate. The statistics are taken over the fp32
//   pre-norm values, as the JAX kernel norms its fp32 accumulator: with a
//   norm, (a) writes fp32 (into y for float32, into the wrapper's scratch for
//   bfloat16) and (c) writes y in its own type.
//
// deconv_block (deconv = 1)
//   Replaces: repro/kernels/fused/kernel.py, deconv_block_pallas
//   (_deconv_block_kernel, reusing repro/kernels/deconv/kernel.py
//   _phase_matmuls).
//   Bound on this card: weight bytes for the 1x1..8x8 up blocks at batch 1,
//   operations for the wide ones, bytes for the Cout-3 final layer.
//   Design: the k4/s2 crop-1 deconv is the phase GEMM of
//   ../../deconv/csrc/phase_gemm.cuh, which deconv2d.cu launches too (four
//   parity-phase GEMMs of M = B*H*W, K = 4*Cin on the tensor cores, 3xTF32
//   or bf16, bias and, without a norm, the act in the epilogue), or for
//   Cout <= 4 without a bf16 norm its phase-fused narrow kernel; then the
//   same (b)/(c) passes as conv_block.
//
// sppf_pyramid (sppf_pyramid_f32 / sppf_pyramid_bf16)
//   Replaces: repro/kernels/fused/kernel.py, sppf_pyramid_pallas (_sppf_kernel).
//   Bound on this card: bytes (read C, write 4C per pixel; 2 x window
//   compares a level); at YOLOv8's (1, 8, 8, 128) a call moves 160 KB, so
//   launch latency and the chain of dependent steps inside a block set its
//   time, not the work.
//   Design: the blocks spread over the card: the wrapper (fused/kernel.py
//   sppf_geometry) picks ct channels and rb output rows per block so that
//   the grid reaches one block per SM (256 blocks of 4 channels x 1 row at
//   (1, 8, 8, 128)). A block copies its rows plus a halo of reps * pad rows
//   into shared memory, writing the input slice of the concat in the same
//   pass, and runs each level as a separable pool: a window-wide row max,
//   then a window-tall column max (2 x window compares instead of
//   window^2), with out-of-range taps skipped (the -inf halo). Threads run
//   along C (coalesced loads and stores, conflict-free shared memory) and
//   step their pixels without an integer division. Taps go left to right,
//   then top to bottom, with torch's max_pool rule (take v when v > m or v
//   is NaN): the same value, bit for bit, as a row-major walk of the
//   window.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "../../deconv/csrc/phase_gemm.cuh"

namespace {

using phase_gemm::ACT_NONE;
using phase_gemm::activate;
using phase_gemm::BN;
using phase_gemm::cp_async16;
using phase_gemm::from_f;
using phase_gemm::gemm_k_loop;
using phase_gemm::gemm_threads;
using phase_gemm::grid_for;
using phase_gemm::smem_u32;
using phase_gemm::STAGES;
using phase_gemm::Tile;
using phase_gemm::to_f;
using phase_gemm::warp_rows;

enum { NORM_NONE = 0, NORM_BATCH = 1, NORM_INSTANCE = 2, NORM_GROUP = 3 };

struct ConvGeom {
  int B, H, W, Cin, Cout, k, stride, pad, Ho, Wo;
  int M;       // GEMM rows: B * Ho * Wo
  int K;       // k * k * Cin
  int splitk;  // splits of each block's live K tiles
  int per;     // live K tiles per split
  int act;     // applied in the epilogue (ACT_NONE when a norm follows)
};

// One BM x 64 output tile of the conv and one split of its live K tiles:
// phase_gemm_kernel's tiles, ring and MMAs (phase_gemm::gemm_k_loop) over a
// conv's tap map (one phase, k * k taps).
template <typename T, int BM, bool VEC, typename O>
__global__ void __launch_bounds__(gemm_threads<T, BM>())
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                 O* __restrict__ y, float* __restrict__ part, ConvGeom g) {
  constexpr int WR = warp_rows<T, BM>(), MI = WR / 16;
  constexpr int THREADS = gemm_threads<T, BM>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = Tile<T>::K, AP = Tile<T>::A, BP = Tile<T>::B;
  constexpr int A_STAGE = BM * AP, B_STAGE = BK * BP;
  static_assert((BM == 64 || BM == 128) && THREADS >= BM, "2 warps across N; a thread per row for the tap vote");
  static_assert(THREADS % BK == 0 && THREADS % BN == 0, "element staging: a thread keeps its K / N column");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned live_taps;
  __shared__ int row_base[BM], row_ih[BM], row_iw[BM];  // element staging: each row's image and first tap
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's WR x 32 tile: rows WR wm, columns 32 wn
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int HWo = g.Ho * g.Wo, KK = g.k * g.k;

  // The block's vote: bit di * k + dj set when tap (di, dj) reaches a real
  // input for some row of this tile. Past 32 taps every K tile counts as
  // live, and the wrapper's per and splitk (conv_live_k_tiles) count them all.
  if (tid == 0) live_taps = 0;
  __syncthreads();
  {
    unsigned mine = 0;
    if (tid < BM) {
      int base = 0, ih0 = -(1 << 20), iw0 = -(1 << 20);  // rows past the tensor reach nothing
      if (m0 + tid < g.M) {
        const int b = (m0 + tid) / HWo;
        const int r = m0 + tid - b * HWo;
        const int oh = r / g.Wo;
        base = b * g.H * g.W * g.Cin;
        ih0 = oh * g.stride - g.pad;
        iw0 = (r - oh * g.Wo) * g.stride - g.pad;
        if (KK <= 32)
          for (int di = 0; di < g.k; ++di)
            for (int dj = 0; dj < g.k; ++dj)
              if (ih0 + di >= 0 && ih0 + di < g.H && iw0 + dj >= 0 && iw0 + dj < g.W) mine |= 1u << (di * g.k + dj);
      }
      row_base[tid] = base;
      row_ih[tid] = ih0;
      row_iw[tid] = iw0;
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    if (lane == 0 && mine) atomicOr(&live_taps, mine);
  }
  __syncthreads();
  const unsigned live = live_taps;
  const int nkt = (g.K + BK - 1) / BK;
  auto tile_live = [&](int kt) {
    if (KK > 32) return true;
    const int k0 = kt * BK;
    const int t_lo = k0 / g.Cin, t_hi = (min(k0 + BK, g.K) - 1) / g.Cin;
    return ((live >> t_lo) & ((2u << (t_hi - t_lo)) - 1u)) != 0;
  };
  // This split's first K tile: skip split * per live tiles by walking the
  // live taps (at most 32), whose K tiles are [t Cin / BK, ((t+1) Cin - 1) / BK].
  int kt = nkt;
  if (KK > 32) {
    kt = min(split * g.per, nkt);
  } else {
    int skip = split * g.per, last = -1;
    for (int t = 0; t < KK; ++t) {
      if (!((live >> t) & 1u)) continue;
      const int a = max(t * g.Cin / BK, last + 1), b = ((t + 1) * g.Cin - 1) / BK;
      if (a > b) continue;
      if (skip <= b - a) {
        kt = a + skip;
        break;
      }
      skip -= b - a + 1;
      last = b;
    }
  }

  // VEC staging: thread -> (rows tid / CPR + i * A_ROWS, chunk tid % CPR) of A
  constexpr int CPR = BK / EPC;
  constexpr int A_IT = BM * CPR / THREADS;
  constexpr int A_ROWS = THREADS / CPR;
  constexpr int CPB = BN / EPC;
  // element staging: thread -> (rows tid / BK + i * THREADS / BK, column tid % BK) of A,
  // (rows tid / BN + i * THREADS / BN, column tid % BN) of B
  constexpr int A_EL = BM * BK / THREADS, B_EL = BK * BN / THREADS;
  const int a_ch = tid % CPR;

  auto load_tile = [&](int k_tile, int stage) {
    T* as = As + stage * A_STAGE;
    T* bs = Bs + stage * B_STAGE;
    const int k0 = k_tile * BK;
    if constexpr (VEC) {
      // this thread's chunk: channels c .. c + EPC of tap (di, dj), one tap
      // (Cin is a multiple of EPC)
      const int kk = k0 + a_ch * EPC;
      const int tap = kk / g.Cin, c = kk - tap * g.Cin;
      const int di = tap / g.k, dj = tap - di * g.k;
#pragma unroll
      for (int i = 0; i < A_IT; ++i) {
        const int r = tid / CPR + i * A_ROWS;
        const int ih = row_ih[r] + di, iw = row_iw[r] + dj;
        const bool ok = kk < g.K && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        const T* src = ok ? x + row_base[r] + (ih * g.W + iw) * g.Cin + c : x;
        cp_async16(smem_u32(as + r * AP + a_ch * EPC), src, ok);
      }
#pragma unroll
      for (int e = tid; e < BK * CPB; e += THREADS) {
        const int kr = e / CPB, ch = e - kr * CPB;
        const int n = n0 + ch * EPC;
        const bool ok = k0 + kr < g.K && n < g.Cout;
        cp_async16(smem_u32(bs + kr * BP + ch * EPC), ok ? w + (size_t)(k0 + kr) * g.Cout + n : w, ok);
      }
    } else {
      // every load of the tile issued before the first store: one memory
      // latency a tile, not one an element
      const int kk = k0 + tid % BK;
      const int tap = kk / g.Cin, ci = kk - tap * g.Cin;
      const int di = tap / g.k, dj = tap - di * g.k;
      T av[A_EL];
#pragma unroll
      for (int i = 0; i < A_EL; ++i) {
        const int r = tid / BK + i * (THREADS / BK);
        const int ih = row_ih[r] + di, iw = row_iw[r] + dj;
        const bool ok = kk < g.K && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        av[i] = ok ? x[row_base[r] + (ih * g.W + iw) * g.Cin + ci] : from_f<T>(0.f);
      }
      const int n = n0 + tid % BN;
      T bv[B_EL];
#pragma unroll
      for (int i = 0; i < B_EL; ++i) {
        const int kr = tid / BN + i * (THREADS / BN);
        bv[i] = k0 + kr < g.K && n < g.Cout ? w[(size_t)(k0 + kr) * g.Cout + n] : from_f<T>(0.f);
      }
#pragma unroll
      for (int i = 0; i < A_EL; ++i) as[(tid / BK + i * (THREADS / BK)) * AP + tid % BK] = av[i];
#pragma unroll
      for (int i = 0; i < B_EL; ++i) bs[(tid / BN + i * (THREADS / BN)) * BP + tid % BN] = bv[i];
    }
  };

  float acc[MI][4][4];
  gemm_k_loop<T, BM>(As, kt, g.per, nkt, tile_live, load_tile, acc);

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WR + mi * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq + e;
          if (n >= g.Cout) continue;
          const float s = acc[mi][ni][2 * h + e];
          if (g.splitk == 1)
            y[(size_t)m * g.Cout + n] = from_f<O>(activate(s + bias[n], g.act));
          else
            part[((size_t)split * g.M + m) * g.Cout + n] = s;
        }
    }
}

template <typename T, int BM, bool VEC, typename O>
int launch_conv_tile(const T* x, const T* w, const float* bias, O* out, float* part, const ConvGeom& g,
                     cudaStream_t stream) {
  static unsigned done = 0;
  const size_t smem = phase_gemm::gemm_smem_bytes<T>(BM);
  int err = phase_gemm::allow_smem(conv_gemm_kernel<T, BM, VEC, O>, smem, done);
  if (err) return err;
  dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN, g.splitk);
  conv_gemm_kernel<T, BM, VEC, O><<<grid, gemm_threads<T, BM>(), smem, stream>>>(x, w, bias, out, part, g);
  return (int)cudaGetLastError();
}

// The conv GEMM, then (splitk > 1) the fixed-order sum of its splits, into y
// of type O. bm: 64 or 128 rows per tile (128 only with vec).
template <typename T, typename O>
int launch_conv_gemm(const T* x, const T* w, const float* bias, O* y, float* part, const ConvGeom& g, int bm,
                     int vec, cudaStream_t stream) {
  int err;
  if (vec && bm == 128)
    err = launch_conv_tile<T, 128, true>(x, w, bias, y, part, g, stream);
  else if (vec)
    err = launch_conv_tile<T, 64, true>(x, w, bias, y, part, g, stream);
  else
    err = launch_conv_tile<T, 64, false>(x, w, bias, y, part, g, stream);
  if (err || g.splitk == 1) return err;
  const int total = g.M * g.Cout;
  phase_gemm::splitk_reduce_kernel<O><<<grid_for(total), 256, 0, stream>>>(part, bias, y, g.splitk, total, g.Cout,
                                                                          g.act);
  return (int)cudaGetLastError();
}

// Chan et al.'s merge of two (count, mean, M2) summaries.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// y as (sets, rows, C). Block (32 channels x 8 row lanes) summarises one row
// chunk of one set for 32 channels: Welford per thread, Chan across lanes.
__global__ void stats_partial_kernel(const float* __restrict__ y, float* __restrict__ pn,
                                     float* __restrict__ pmean, float* __restrict__ pm2, int rows,
                                     int C, int rows_per_chunk, int chunks) {
  __shared__ float sn[8][32], smean[8][32], sm2[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int chunk = blockIdx.y, set = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    const float* base = y + (size_t)set * rows * C + c;
    for (int r = r0 + ty; r < r1; r += 8) {
      const float v = base[(size_t)r * C];
      n += 1.f;
      const float d = v - mean;
      mean += d / n;
      m2 += d * (v - mean);
    }
  }
  sn[ty][tx] = n;
  smean[ty][tx] = mean;
  sm2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int t = 1; t < 8; ++t) chan_merge(n, mean, m2, sn[t][tx], smean[t][tx], sm2[t][tx]);
    const size_t o = ((size_t)set * chunks + chunk) * C + c;
    pn[o] = n;
    pmean[o] = mean;
    pm2[o] = m2;
  }
}

// One warp per (set, group): each lane merges every 32nd of the group's
// (chunk, channel) summaries, then a fixed shuffle tree merges the lanes.
__global__ void stats_final_kernel(const float* __restrict__ pn, const float* __restrict__ pmean,
                                   const float* __restrict__ pm2, float* __restrict__ mean_out,
                                   float* __restrict__ rstd_out, int G, int CG, int C, int chunks,
                                   float eps) {
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int set = i / G, grp = i - set * G;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int j = lane; j < chunks * CG; j += 32) {
    const int ch = j / CG;
    const size_t o = ((size_t)set * chunks + ch) * C + grp * CG + (j - ch * CG);
    chan_merge(n, mean, m2, pn[o], pmean[o], pm2[o]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    mean_out[i] = mean;
    rstd_out[i] = 1.f / sqrtf(m2 / n + eps);  // population variance, as jnp.var
  }
}

// pre (fp32, the GEMM's output) -> y in its own type; in place for float32
template <typename O>
__global__ void norm_act_kernel(const float* pre, O* y, const float* __restrict__ mean,
                                const float* __restrict__ rstd, const float* __restrict__ gamma,
                                const float* __restrict__ beta, int total, int C, int HW, int G,
                                int CG, int per_sample, int act) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c = i % C;
    const int s = per_sample ? i / C / HW : 0;
    const int k = s * G + c / CG;
    y[i] = from_f<O>(activate((pre[i] - mean[k]) * rstd[k] * gamma[c] + beta[c], act));
  }
}

constexpr int SPPF_THREADS = 256;

// One block per (channel tile, band of rb output rows, sample); threads
// (c, ty): c the channel in the tile (lanes along C), ty the first of the
// pixels it walks. The block holds its rows and reps * pad rows of halo
// on each side (clipped to the map), at every level, in two fp32 planes
// (pixel-major, ct channels a pixel). A level is a window-wide row max
// into rmax, then a window-tall column max back into cur. Rows outside the
// region are left out like the -inf padding: that changes only rows
// further than (reps - level) * pad from the band, which no later level
// reads for the band.
template <typename T>
__global__ void __launch_bounds__(SPPF_THREADS)
sppf_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int rb, int window, int reps) {
  extern __shared__ float smem[];
  const int ct = blockDim.x, ny = blockDim.y;
  const int c = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * ct;
  const int h0 = blockIdx.y * rb, h1 = min(H, h0 + rb);
  const int pad = window / 2;
  const int lo = max(0, h0 - reps * pad), hi = min(H, h1 + reps * pad);
  const int rows = hi - lo, n = rows * W;  // the region: image pixels lo * W .. hi * W
  float* cur = smem;            // the region at the current level
  float* rmax = smem + n * ct;  // its row maxima
  const bool live = c0 + c < C;
  const size_t OC = (size_t)(reps + 1) * C;
  const size_t pix0 = (size_t)blockIdx.z * H * W + (size_t)lo * W;
  const T* xr = x + pix0 * C + c0 + c;
  T* orow = out + pix0 * OC + c0 + c;
  // the region pixel i = ty + k ny as (row, col), stepped without a division
  const int r_first = ty / W, w_first = ty - r_first * W;
  const int dr = ny / W, dw = ny - dr * W;
  const int band_lo = h0 - lo, band_hi = h1 - lo;  // the band's rows in the region

  for (int i = ty, r = r_first, w = w_first; i < n; i += ny) {
    const T v = live ? xr[(size_t)i * C] : from_f<T>(0.f);
    cur[i * ct + c] = to_f(v);
    if (live && r >= band_lo && r < band_hi) orow[(size_t)i * OC] = v;
    r += dr;
    w += dw;
    if (w >= W) w -= W, ++r;
  }
  __syncthreads();
  for (int level = 1; level <= reps; ++level) {
    // row max, taps left to right; torch's max_pool rule: v is taken when
    // v > m or v is NaN. Max has no rounding, and the separable order keeps
    // which of equal values (+-0) or of NaNs wins: the result is the
    // row-major window walk's, bit for bit.
    for (int i = ty, r = r_first, w = w_first; i < n; i += ny) {
      float m = -INFINITY;
      for (int d = -pad; d <= pad; ++d) {
        if (w + d < 0 || w + d >= W) continue;
        const float v = cur[(i + d) * ct + c];
        if (v > m || isnan(v)) m = v;
      }
      rmax[i * ct + c] = m;
      r += dr;
      w += dw;
      if (w >= W) w -= W, ++r;
    }
    __syncthreads();
    // column max of the row maxima, taps top to bottom
    for (int i = ty, r = r_first, w = w_first; i < n; i += ny) {
      float m = -INFINITY;
      for (int d = -pad; d <= pad; ++d) {
        if (r + d < 0 || r + d >= rows) continue;
        const float v = rmax[(i + d * W) * ct + c];
        if (v > m || isnan(v)) m = v;
      }
      cur[i * ct + c] = m;
      if (live && r >= band_lo && r < band_hi) orow[(size_t)i * OC + (size_t)level * C] = from_f<T>(m);
      r += dr;
      w += dw;
      if (w >= W) w -= W, ++r;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_sppf(const void* x, void* out, int B, int H, int W, int C, int ct, int rb, int window, int reps,
                cudaStream_t stream) {
  const int rows = min(H, rb + 2 * reps * (window / 2));
  const size_t smem = 2 * (size_t)rows * W * ct * sizeof(float);
  dim3 grid((C + ct - 1) / ct, (H + rb - 1) / rb, B);
  sppf_kernel<T><<<grid, dim3(ct, SPPF_THREADS / ct), smem, stream>>>(static_cast<const T*>(x),
                                                                       static_cast<T*>(out), H, W, C, rb, window,
                                                                       reps);
  return (int)cudaGetLastError();
}

// conv (deconv = 0): (B,H,W,Cin) * (k,k,Cin,Cout), stride, pad -> (B,Ho,Wo,Cout):
// the conv GEMM, tile_rows (64 or 128) rows per tile, vec: 16-byte staging.
// deconv (deconv = 1): (B,H,W,Cin) * (4,4,Cin,Cout), k4/s2, crop 1 -> (B,2H,2W,Cout):
// narrow: phase_gemm.cuh's phase-fused kernel (Cout <= 4), tile_rows input
// rows per block; else its phase GEMM, tile_rows and vec as for the conv.
// Both: splitk splits of per live K tiles each. part: splitk * B*Ho*Wo*Cout
// floats when splitk > 1, else unused. pre: B*Ho*Wo*Cout floats, the
// pre-norm values, when norm != none (float32: y itself), else unused.
// stats: 3*sets*chunks*Cout + 2*sets*G floats when norm != none, else
// unused, with sets = (norm == batch ? 1 : B) and G = (norm == group ? groups
// : Cout).
template <typename T>
int conv_block(const void* xv, const void* wv, const float* bias, const float* gamma, const float* beta, void* yv,
               float* pre, float* part, float* stats, int B, int H, int W, int Cin, int Cout, int k, int stride,
               int pad, int deconv, int norm, int groups, int act, float eps, int splitk, int per, int chunks,
               int narrow, int tile_rows, int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  const int epi_act = norm == NORM_NONE ? act : ACT_NONE;
  const int Ho = deconv ? 2 * H : (H + 2 * pad - k) / stride + 1;
  const int Wo = deconv ? 2 * W : (W + 2 * pad - k) / stride + 1;
  const int total = B * Ho * Wo * Cout;
  int err;
  if (deconv) {
    const phase_gemm::PhaseGeom pg = phase_gemm::make_geom(B, H, W, Cin, Cout, splitk, per, epi_act);
    if (narrow)  // never with a bf16 norm (the wrapper's rule): it writes T
      err = phase_gemm::launch_narrow<T>(x, w, bias, y, pg, tile_rows, stream);
    else if (norm == NORM_NONE)
      err = phase_gemm::launch_phase_gemm<T>(x, w, bias, y, part, pg, tile_rows, vec, stream);
    else
      err = phase_gemm::launch_phase_gemm<T, float>(x, w, bias, pre, part, pg, tile_rows, vec, stream);
  } else {
    ConvGeom g;
    g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.k = k; g.stride = stride; g.pad = pad;
    g.Ho = Ho; g.Wo = Wo;
    g.M = B * Ho * Wo;
    g.K = k * k * Cin;
    g.splitk = splitk;
    g.per = per;
    g.act = epi_act;
    err = norm == NORM_NONE ? launch_conv_gemm<T, T>(x, w, bias, y, part, g, tile_rows, vec, stream)
                            : launch_conv_gemm<T, float>(x, w, bias, pre, part, g, tile_rows, vec, stream);
  }
  if (err || norm == NORM_NONE) return err;
  const int sets = norm == NORM_BATCH ? 1 : B;
  const int HW = Ho * Wo;
  const int rows = norm == NORM_BATCH ? B * HW : HW;
  const int G = norm == NORM_GROUP ? groups : Cout;
  const int CG = Cout / G;
  const int rows_per_chunk = (rows + chunks - 1) / chunks;
  float* pn = stats;
  float* pmean = pn + (size_t)sets * chunks * Cout;
  float* pm2 = pmean + (size_t)sets * chunks * Cout;
  float* mean = pm2 + (size_t)sets * chunks * Cout;
  float* rstd = mean + (size_t)sets * G;
  stats_partial_kernel<<<dim3((Cout + 31) / 32, chunks, sets), dim3(32, 8), 0, stream>>>(
      pre, pn, pmean, pm2, rows, Cout, rows_per_chunk, chunks);
  err = (int)cudaGetLastError();
  if (err) return err;
  stats_final_kernel<<<sets * G, 32, 0, stream>>>(pn, pmean, pm2, mean, rstd, G, CG, Cout, chunks, eps);
  err = (int)cudaGetLastError();
  if (err) return err;
  norm_act_kernel<T><<<grid_for(total), 256, 0, stream>>>(pre, y, mean, rstd, gamma, beta, total, Cout, HW, G, CG,
                                                          norm != NORM_BATCH, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fused_conv_block_f32(const void* x, const void* w, const float* bias, const float* gamma, const float* beta,
                         void* y, float* pre, float* part, float* stats, int B, int H, int W, int Cin, int Cout,
                         int k, int stride, int pad, int deconv, int norm, int groups, int act, float eps,
                         int splitk, int per, int chunks, int narrow, int tile_rows, int vec, void* stream) {
  return conv_block<float>(x, w, bias, gamma, beta, y, pre, part, stats, B, H, W, Cin, Cout, k, stride, pad,
                           deconv, norm, groups, act, eps, splitk, per, chunks, narrow, tile_rows, vec, stream);
}

int fused_conv_block_bf16(const void* x, const void* w, const float* bias, const float* gamma, const float* beta,
                          void* y, float* pre, float* part, float* stats, int B, int H, int W, int Cin, int Cout,
                          int k, int stride, int pad, int deconv, int norm, int groups, int act, float eps,
                          int splitk, int per, int chunks, int narrow, int tile_rows, int vec, void* stream) {
  return conv_block<__nv_bfloat16>(x, w, bias, gamma, beta, y, pre, part, stats, B, H, W, Cin, Cout, k, stride,
                                   pad, deconv, norm, groups, act, eps, splitk, per, chunks, narrow, tile_rows, vec,
                                   stream);
}

// (B,H,W,C) -> (B,H,W,(reps+1)*C); blocks of ct channels (a power of two
// <= 32) x rb output rows, 2*min(H, rb + 2*reps*(window/2))*W*ct*4 bytes of
// shared memory (the wrapper keeps it within the 48 KB default).
int sppf_pyramid_f32(const void* x, void* out, int B, int H, int W, int C, int ct, int rb, int window,
                     int reps, void* stream) {
  return launch_sppf<float>(x, out, B, H, W, C, ct, rb, window, reps, static_cast<cudaStream_t>(stream));
}

int sppf_pyramid_bf16(const void* x, void* out, int B, int H, int W, int C, int ct, int rb, int window,
                      int reps, void* stream) {
  return launch_sppf<__nv_bfloat16>(x, out, B, H, W, C, ct, rb, window, reps,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
