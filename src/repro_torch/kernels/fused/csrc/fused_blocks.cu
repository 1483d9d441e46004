// Fused serving blocks for Hopper (sm_90a): conv/deconv + bias + norm + act,
// and the SPPF max-pool pyramid. Plain C interface, loaded with ctypes by
// ../kernel.py; every entry launches on the caller's stream, allocates
// nothing (the wrapper passes outputs and scratch) and returns
// cudaGetLastError().
//
// Layouts are the JAX package's: activations NHWC, weights (kh, kw, Cin, Cout),
// all contiguous float32 (SPPF also bfloat16).
//
// conv_block (fused_conv_block_f32, deconv = 0)
//   Replaces: repro/kernels/fused/kernel.py, conv_block_pallas
//   (_conv_block_kernel, _norm_act).
//   Bound on this card: fp32 FMA operations for the wide layers (K = k*k*Cin up
//   to 8192), weight bytes for the deep 1x1/2x2 layers whose M = B*Ho*Wo is
//   1..4 rows.
//   Design: the TPU kernel keeps a whole sample in VMEM; a 128x128x64 fp32
//   sample (4 MB) is far beyond 227 KB of shared memory, so the block splits
//   into (a) an implicit-GEMM conv, M = B*Ho*Wo, N = Cout, K = k*k*Cin, tiled
//   64x64x16 through shared memory with fp32 FMA (no TF32), bias (and the act,
//   when there is no norm) in the epilogue; deep layers with few output tiles
//   split K over more blocks into a partial buffer that one pass reduces in a
//   fixed order (no atomics, so results are bit-reproducible); (b) per-(stats
//   set, group) mean and variance by Welford per thread and Chan's merge
//   across threads and row chunks; the stats set is the sample for
//   instance/group norm and the whole batch for batch norm, so B > 1 batch
//   norm is exact; (c) normalise, scale, shift and activate in place.
//
// deconv_block (fused_conv_block_f32, deconv = 1)
//   Replaces: repro/kernels/fused/kernel.py, deconv_block_pallas
//   (_deconv_block_kernel, reusing repro/kernels/deconv/kernel.py
//   _phase_matmuls).
//   Bound on this card: weight bytes for the 1x1..8x8 up blocks at batch 1,
//   operations for the wide ones, bytes for the Cout-3 final layer.
//   Design: the k4/s2 crop-1 deconv is the phase GEMM of
//   ../../deconv/csrc/phase_gemm.cuh, which deconv2d.cu launches too (four
//   parity-phase GEMMs of M = B*H*W, K = 4*Cin on the tensor cores, 3xTF32,
//   bias and, without a norm, the act in the epilogue), or for Cout <= 4 its
//   phase-fused narrow kernel; then the same (b)/(c) passes as conv_block.
//
// sppf_pyramid (sppf_pyramid_f32 / sppf_pyramid_bf16)
//   Replaces: repro/kernels/fused/kernel.py, sppf_pyramid_pallas (_sppf_kernel).
//   Bound on this card: bytes (read C, write 4C per pixel; 25 compares each).
//   Design: one block per (sample, channel tile) holds the H x W x c_tile tile
//   and its pooled successor in shared memory, runs the cascaded window x
//   window stride-1 max pools there with out-of-range taps skipped (the -inf
//   halo), and writes each pyramid level straight to its slice of the 4C
//   concat. Taps are visited in row-major order with torch's max_pool rule
//   (take v when v > m or v is NaN), so the result is bit-exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "../../deconv/csrc/phase_gemm.cuh"

namespace {

using phase_gemm::ACT_NONE;
using phase_gemm::activate;
using phase_gemm::from_f;
using phase_gemm::grid_for;
using phase_gemm::to_f;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int GEMM_THREADS = 256;

enum { NORM_NONE = 0, NORM_BATCH = 1, NORM_INSTANCE = 2, NORM_GROUP = 3 };

struct ConvGeom {
  int B, H, W, Cin, Cout, k, stride, pad, Ho, Wo;
  int gh, gw;        // the GEMM's output grid: (Ho, Wo)
  int Mp;            // GEMM rows: B * gh * gw
  int Mtot;          // output rows: B * Ho * Wo
  int K;             // k*k*Cin
  int kt_per_split;  // K tiles each split of K covers
  int splitk;
};

// One 64x64 output tile and one split of K. 256 threads, each
// accumulating a 4x4 micro-tile in registers.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, ConvGeom g, int act) {
  __shared__ float As[BK][BM + 4];  // +4: the transposed store hits 8 banks, not 1
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = (int)blockIdx.z;

  // A loads: 16 consecutive threads walk 16 consecutive K indices (channels)
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[4], a_ih[4], a_iw[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + a_m + 16 * j;
    a_ok[j] = m < g.Mp;
    const int mm = a_ok[j] ? m : 0;
    const int b = mm / (g.gh * g.gw);
    const int r = mm - b * g.gh * g.gw;
    const int oh = r / g.gw;
    const int ow = r - oh * g.gw;
    a_base[j] = b * g.H * g.W * g.Cin;
    a_ih[j] = oh * g.stride - g.pad;
    a_iw[j] = ow * g.stride - g.pad;
  }
  // B loads: 64 consecutive threads walk 64 consecutive output channels
  const int b_n = tid % BN;
  const int b_k = tid / BN;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nkt = (g.K + BK - 1) / BK;
  const int kt0 = split * g.kt_per_split;
  const int kt1 = min(nkt, kt0 + g.kt_per_split);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int kbase = kt * BK;
    {
      const int kk = kbase + a_k;
      const bool kok = kk < g.K;
      const int tap = kok ? kk / g.Cin : 0;
      const int ci = kk - tap * g.Cin;
      const int di = tap / g.k;
      const int dj = tap - di * g.k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ih = a_ih[j] + di, iw = a_iw[j] + dj;
        float v = 0.f;
        if (kok && a_ok[j] && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = x[a_base[j] + (ih * g.W + iw) * g.Cin + ci];
        As[a_k][a_m + 16 * j] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kr = b_k + 4 * j;
      const int kk = kbase + kr;
      const int n = n0 + b_n;
      float v = 0.f;
      if (kk < g.K && n < g.Cout) v = w[(size_t)kk * g.Cout + n];
      Bs[kr][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.Mp) continue;
    const int orow = m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.Cout) continue;
      if (g.splitk == 1)
        out[(size_t)orow * g.Cout + n] = activate(acc[i][j] + bias[n], act);
      else
        out[((size_t)split * g.Mtot + orow) * g.Cout + n] = acc[i][j];
    }
  }
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

__global__ void norm_act_kernel(float* __restrict__ y, const float* __restrict__ mean,
                                const float* __restrict__ rstd, const float* __restrict__ gamma,
                                const float* __restrict__ beta, int total, int C, int HW, int G,
                                int CG, int per_sample, int act) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c = i % C;
    const int s = per_sample ? i / C / HW : 0;
    const int k = s * G + c / CG;
    y[i] = activate((y[i] - mean[k]) * rstd[k] * gamma[c] + beta[c], act);
  }
}

template <typename T>
__global__ void sppf_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
                            int ct, int window, int reps) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + H * W * ct;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * ct;
  const int n = H * W * ct;
  const size_t OC = (size_t)(reps + 1) * C;
  const size_t pix0 = (size_t)b * H * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % ct, p = i / ct;
    if (c0 + c < C) {
      const T v = x[(pix0 + p) * C + c0 + c];
      cur[i] = to_f(v);
      out[(pix0 + p) * OC + c0 + c] = v;
    }
  }
  __syncthreads();
  const int pad = window / 2;
  for (int r = 1; r <= reps; ++r) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i % ct, p = i / ct;
      const int h = p / W, w = p - h * W;
      float m = -INFINITY;
      for (int dh = -pad; dh <= pad; ++dh) {
        const int hh = h + dh;
        if (hh < 0 || hh >= H) continue;
        for (int dw = -pad; dw <= pad; ++dw) {
          const int ww = w + dw;
          if (ww < 0 || ww >= W) continue;
          const float v = cur[(hh * W + ww) * ct + c];
          if (v > m || isnan(v)) m = v;
        }
      }
      nxt[i] = m;
      if (c0 + c < C) out[(pix0 + p) * OC + (size_t)r * C + c0 + c] = from_f<T>(m);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T>
int launch_sppf(const void* x, void* out, int B, int H, int W, int C, int ct, int window, int reps,
                cudaStream_t stream) {
  const size_t smem = 2 * (size_t)H * W * ct * sizeof(float);
  dim3 grid((C + ct - 1) / ct, B);
  sppf_kernel<T><<<grid, 256, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), H, W,
                                              C, ct, window, reps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// conv (deconv = 0): (B,H,W,Cin) * (k,k,Cin,Cout), stride, pad -> (B,Ho,Wo,Cout);
// splitk splits of kt_per_split K tiles each.
// deconv (deconv = 1): (B,H,W,Cin) * (4,4,Cin,Cout), k4/s2, crop 1 -> (B,2H,2W,Cout):
// narrow: phase_gemm.cuh's phase-fused kernel (Cout <= 4), tile_rows input
// rows per block; else its phase GEMM, tile_rows (64 or 128) rows per tile,
// vec: 16-byte staging; splitk splits of kt_per_split live K tiles each.
// part: splitk * B*Ho*Wo*Cout floats when splitk > 1, else unused.
// stats: 3*sets*chunks*Cout + 2*sets*G floats when norm != none, else unused,
// with sets = (norm == batch ? 1 : B) and G = (norm == group ? groups : Cout).
int fused_conv_block_f32(const float* x, const float* w, const float* bias, const float* gamma,
                         const float* beta, float* y, float* part, float* stats, int B, int H,
                         int W, int Cin, int Cout, int k, int stride, int pad, int deconv,
                         int norm, int groups, int act, float eps, int splitk, int kt_per_split,
                         int chunks, int narrow, int tile_rows, int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ConvGeom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.k = k; g.stride = stride; g.pad = pad;
  if (deconv) {
    g.Ho = 2 * H; g.Wo = 2 * W;
  } else {
    g.Ho = (H + 2 * pad - k) / stride + 1; g.Wo = (W + 2 * pad - k) / stride + 1;
  }
  g.gh = g.Ho; g.gw = g.Wo; g.K = k * k * Cin;
  g.Mp = B * g.gh * g.gw;
  g.Mtot = B * g.Ho * g.Wo;
  g.splitk = splitk;
  g.kt_per_split = kt_per_split;
  const int epi_act = norm == NORM_NONE ? act : ACT_NONE;
  const int total = g.Mtot * Cout;
  int err;
  if (deconv) {
    const phase_gemm::PhaseGeom pg = phase_gemm::make_geom(B, H, W, Cin, Cout, splitk, kt_per_split, epi_act);
    err = narrow ? phase_gemm::launch_narrow<float>(x, w, bias, y, pg, tile_rows, stream)
                 : phase_gemm::launch_phase_gemm<float>(x, w, bias, y, part, pg, tile_rows, vec, stream);
    if (err) return err;
  } else {
    dim3 grid((g.Mp + BM - 1) / BM, (Cout + BN - 1) / BN, splitk);
    gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(x, w, bias, splitk > 1 ? part : y, g, epi_act);
    err = (int)cudaGetLastError();
    if (err) return err;
    if (splitk > 1) {
      phase_gemm::splitk_reduce_kernel<float><<<grid_for(total), 256, 0, stream>>>(part, bias, y, splitk,
                                                                                    total, Cout, epi_act);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
  }
  if (norm == NORM_NONE) return 0;
  const int sets = norm == NORM_BATCH ? 1 : B;
  const int HW = g.Ho * g.Wo;
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
      y, pn, pmean, pm2, rows, Cout, rows_per_chunk, chunks);
  err = (int)cudaGetLastError();
  if (err) return err;
  stats_final_kernel<<<sets * G, 32, 0, stream>>>(pn, pmean, pm2, mean, rstd, G, CG, Cout, chunks,
                                                  eps);
  err = (int)cudaGetLastError();
  if (err) return err;
  norm_act_kernel<<<grid_for(total), 256, 0, stream>>>(y, mean, rstd, gamma, beta, total, Cout, HW,
                                                       G, CG, norm != NORM_BATCH, act);
  return (int)cudaGetLastError();
}

// (B,H,W,C) -> (B,H,W,(reps+1)*C); ct channels per block, 2*H*W*ct*4 bytes of
// shared memory (the wrapper keeps it within the 48 KB default).
int sppf_pyramid_f32(const void* x, void* out, int B, int H, int W, int C, int ct, int window,
                     int reps, void* stream) {
  return launch_sppf<float>(x, out, B, H, W, C, ct, window, reps, static_cast<cudaStream_t>(stream));
}

int sppf_pyramid_bf16(const void* x, void* out, int B, int H, int W, int C, int ct, int window,
                      int reps, void* stream) {
  return launch_sppf<__nv_bfloat16>(x, out, B, H, W, C, ct, window, reps,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
