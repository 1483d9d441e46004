// Flash attention (forward) for Hopper (sm_90a): GQA, causal and
// sliding-window masks with whole KV tiles skipped, optional logit softcap,
// ends aligned for Sq <= Sk. Plain C interface, loaded with ctypes by
// ../kernel.py; every entry launches on the caller's stream, allocates
// nothing (the wrapper passes the output) and returns cudaGetLastError().
//
// Layouts are the JAX package's: q (B, Sq, Hq, D), k and v (B, Sk, Hk, D),
// o (B, Sq, Hq, D); all float32 or all bfloat16, fp32 arithmetic inside.
// Query head h reads KV head h / (Hq / Hk). Query row i sits at key
// position i + Sk - Sq. A key is seen when it is causal (kp <= qp, if
// causal) and inside the left window (qp - kp < window, if window > 0).
//
// Replaces: repro/kernels/attention/kernel.py:80, flash_attention
// (_flash_kernel), the Pallas kernel whose grid (B, Hq, Sq/bq) streams the
// KV sequence through VMEM with an online softmax.
//
// Bound on this card: fp32 FMA operations. Each (query, key) pair inside
// the mask costs 2 D multiply-adds (the score and its share of P.V); at
// the Hymba-1.5B prefill (S 4096, D 64) a query tile of a window-1024
// layer reads 17 of 64 KV tiles and a global layer's reads up to all 64,
// against D * 2 bytes per row read: ~64 operations per byte, far above
// the HBM line even in fp32.
//
// Design: one block of 256 threads per (64-query tile, query head, batch
// row). The block loops over 64-key tiles from the first tile the window
// reaches to the last the causal mask reaches (tiles outside are never
// loaded: the skipping the TPU kernel does, which is this kernel's reason
// to exist), staging K and V in shared memory as fp32. Each thread owns a
// 4 x 4 block of the 64 x 64 score tile (rows 4*ty.., keys tx + 16*j) and
// 4 rows x D/16 columns of the output accumulator, in registers; the 16
// threads of a row group share the running max and sum through warp
// shuffles. Masked scores are a finite -1e30 (as the TPU kernel's NEG_INF)
// and their probabilities are set to 0, so a tile row that is fully masked
// adds nothing and never makes exp(-inf + inf). Query and key tails past
// Sq / Sk are masked in the kernel, so any length runs. fp32 FMA, no
// tensor cores: mma.sync / wgmma are later work. Query tiles are issued
// last-first, so the longest causal rows start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;  // padded row stride of the probability tile
constexpr float NEG = -1e30f;

struct Params {
  int B, Sq, Sk, Hq, Hk, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K with a padded row (D + 1: a warp reading one column of 16 rows
  // hits 16 banks), V unpadded (read along rows), P padded
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Params p) {
  static_assert(D % 16 == 0, "16 threads share a row's D columns");
  constexpr int DP = D + 1;
  constexpr int DT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output-column lane of a row group
  const int ty = tid >> 4;   // row group: query rows 4*ty .. 4*ty+3
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int off = p.Sk - p.Sq;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < p.Sq ? to_f(q[((size_t)(b * p.Sq + qi) * p.Hq + h) * D + c]) : 0.f;
  }

  // the keys this tile's rows can see: [k_lo, k_hi)
  const int qp_first = q0 + off;
  const int qp_last = min(q0 + BQ, p.Sq) - 1 + off;
  const int k_hi = p.causal ? min(p.Sk, qp_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, qp_first - p.window + 1) : 0;

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < p.Sk) {
        const size_t g = ((size_t)(b * p.Sk + kp) * p.Hk + hk) * D + c;
        kv = to_f(k[g]);
        vv = to_f(v[g]);
      }
      Ks[r * DP + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * ty + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i + off;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        ok[j] = kp < p.Sk && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
        s[i][j] = ok[j] ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pj;
        Ps[(4 * ty + i) * PS + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DT; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)(b * p.Sq + qi) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) out[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                       static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int Hq, int Hk,
             int D, int causal, int window, float scale, float softcap, void* stream) {
  const Params p{B, Sq, Sk, Hq, Hk, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, p, s);
    case 32: return launch<T, 32>(q, k, v, o, p, s);
    case 64: return launch<T, 64>(q, k, v, o, p, s);
    case 128: return launch<T, 128>(q, k, v, o, p, s);
    case 256: return launch<T, 256>(q, k, v, o, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int Hq,
                        int Hk, int D, int causal, int window, float scale, float softcap, void* stream) {
  return dispatch<float>(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal, window, scale, softcap, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int Hq,
                         int Hk, int D, int causal, int window, float scale, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hk, D, causal, window, scale, softcap, stream);
}

const char* flash_attention_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
