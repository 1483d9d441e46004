// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), with the final
// state. Plain C interface, loaded with ctypes by ../kernel.py; every entry
// launches on the caller's stream, allocates nothing (the wrapper passes y
// and the state) and returns cudaGetLastError().
//
// Layouts are the JAX package's: x (b, s, h, p), dt (b, s, h), A (h,)
// float32, B and C (b, s, g, n), y (b, s, h, p); x, dt, B, C and y all
// float32 or all bfloat16, the optional final state (b, h, p, n) float32.
// Head h reads group h / (h_total / g). It computes ssd_chunked
// (repro_torch/kernels/ssd/ref.py): per chunk of T steps, with cum the
// running sum of dt * A from the chunk's start,
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//        + exp(cum_i) C_i . h_prev
//   h    = h_prev exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// Chunking does not change that function, only where sums are rounded: the
// kernel steps T = 64 at a time whatever chunk the caller's plain version
// uses (a 256-step chunk's B and C tiles at n = 128 would not fit in shared
// memory beside the rest). A ragged tail is steps with dt = 0, as
// ssd_chunked pads it: they neither decay nor feed the state.
//
// Replaces: repro/kernels/ssd/kernel.py:67, ssd_pallas (_ssd_kernel), whose
// grid (b, h, s/chunk) carries the (p, n) state in VMEM scratch along its
// sequential ("arbitrary") chunk axis.
//
// Bound on this card: bytes for bfloat16 operands (at Hymba-1.5B, p 64 and
// n 16, the scan does some tens of operations per byte of x and y, below
// the bf16 tensor-core line of ~295 per byte), fp32 FMA operations for
// float32 (above the fp32 line of ~20 per byte).
//
// Design: blocks run in no order and carry nothing between them, so the
// sequential chunk axis becomes a loop inside one block, and the state
// stays in shared memory across it. A block owns one (batch row, head) and
// 16 of its p channels: the state's rows p are independent (y_i[p] reads
// only h[p, :] and x[:, p]), so the p axis splits across blocks and the
// Hymba prefill (b 2, h 50, p 64) runs 400 blocks on 132 SMs where one
// block per (b, h) would give 100. Each block recomputes the 64 x 64
// C.B^T decay matrix of its head (n multiply-adds an entry, cheap at
// n 16). Per step of 64: load x, dt, B, C as fp32; a warp scan gives cum;
// the lower triangle of the decay matrix is built with the mask applied
// BEFORE exp (above the diagonal cum_i - cum_j is positive and exp could
// overflow to inf, and inf * 0 is NaN); then y, then the state update. fp32
// FMA throughout, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 64;        // steps per kernel chunk
constexpr int PT = 16;       // p channels per block
constexpr int THREADS = 128;
constexpr int TS = T + 1;    // padded row stride of the decay matrix

struct Geom {
  int b, s, h, p, g;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename X> __device__ __forceinline__ X from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int N>
constexpr size_t smem_bytes() {
  // x (T x PT), B and C (T x N+1), decay matrix (T x TS), state (PT x N+1),
  // dt, cum and the state weights (T each)
  return sizeof(float) * (size_t)(T * PT + 2 * T * (N + 1) + T * TS + PT * (N + 1) + 3 * T);
}

template <typename X, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const X* __restrict__ x, const X* __restrict__ dt, const float* __restrict__ A,
           const X* __restrict__ Bm, const X* __restrict__ Cm, X* __restrict__ y,
           float* __restrict__ state, Geom gm) {
  constexpr int NP = N + 1;
  extern __shared__ float smem[];
  float* xs = smem;              // T x PT
  float* Bs = xs + T * PT;       // T x NP
  float* Cs = Bs + T * NP;       // T x NP
  float* Ls = Cs + T * NP;       // T x TS: (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
  float* hs = Ls + T * TS;       // PT x NP: the state's rows p0 .. p0+PT-1
  float* dts = hs + PT * NP;     // T
  float* cum = dts + T;          // T
  float* wst = cum + T;          // T: exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int gg = hh / (gm.h / gm.g);
  const float a = A[hh];

  for (int e = tid; e < PT * NP; e += THREADS) hs[e] = 0.f;

  for (int t0 = 0; t0 < gm.s; t0 += T) {
    for (int e = tid; e < T * PT; e += THREADS) {
      const int r = e / PT, c = e % PT;
      const int t = t0 + r;
      xs[e] = t < gm.s ? to_f(x[((size_t)(bb * gm.s + t) * gm.h + hh) * gm.p + p0 + c]) : 0.f;
    }
    for (int e = tid; e < T * N; e += THREADS) {
      const int r = e / N, n = e % N;
      const int t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < gm.s) {
        const size_t gi = ((size_t)(bb * gm.s + t) * gm.g + gg) * N + n;
        bv = to_f(Bm[gi]);
        cv = to_f(Cm[gi]);
      }
      Bs[r * NP + n] = bv;
      Cs[r * NP + n] = cv;
    }
    for (int r = tid; r < T; r += THREADS) {
      const int t = t0 + r;
      dts[r] = t < gm.s ? to_f(dt[(size_t)(bb * gm.s + t) * gm.h + hh]) : 0.f;  // tail: dt = 0
    }
    __syncthreads();

    if (tid < 32) {  // inclusive scan of dt * A over the T = 64 steps, two per lane
      const float d0 = dts[2 * tid] * a, d1 = dts[2 * tid + 1] * a;
      float sc = d0 + d1;
#pragma unroll
      for (int w = 1; w < 32; w <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, sc, w);
        if (tid >= w) sc += up;
      }
      cum[2 * tid] = sc - d1;
      cum[2 * tid + 1] = sc;
    }
    __syncthreads();

    for (int e = tid; e < T * T; e += THREADS) {
      const int i = e / T, j = e % T;
      float v = 0.f;
      if (j <= i) {  // mask first: exp only of cum_i - cum_j <= 0
        float dot = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) dot = fmaf(Cs[i * NP + n], Bs[j * NP + n], dot);
        v = dot * expf(cum[i] - cum[j]) * dts[j];
      }
      Ls[i * TS + j] = v;
    }
    if (tid < T) wst[tid] = expf(cum[T - 1] - cum[tid]) * dts[tid];
    __syncthreads();

    for (int e = tid; e < T * PT; e += THREADS) {
      const int i = e / PT, c = e % PT;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(Ls[i * TS + j], xs[j * PT + c], intra);
      float inter = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) inter = fmaf(Cs[i * NP + n], hs[c * NP + n], inter);
      const int t = t0 + i;
      if (t < gm.s)
        y[((size_t)(bb * gm.s + t) * gm.h + hh) * gm.p + p0 + c] = from_f<X>(intra + inter * expf(cum[i]));
    }
    __syncthreads();  // y has read the state this chunk entered with

    const float decay = expf(cum[T - 1]);
    for (int e = tid; e < PT * N; e += THREADS) {
      const int c = e / N, n = e % N;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < T; ++j) acc = fmaf(wst[j] * xs[j * PT + c], Bs[j * NP + n], acc);
      hs[c * NP + n] = fmaf(hs[c * NP + n], decay, acc);
    }
    __syncthreads();
  }

  if (state != nullptr) {
    for (int e = tid; e < PT * N; e += THREADS) {
      const int c = e / N, n = e % N;
      state[((size_t)(bb * gm.h + hh) * gm.p + p0 + c) * N + n] = hs[c * NP + n];
    }
  }
}

template <typename X, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
           const Geom& gm, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_kernel<X, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(gm.p / PT, gm.h, gm.b);
  ssd_kernel<X, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(dt), static_cast<const float*>(A),
      static_cast<const X*>(B), static_cast<const X*>(C), static_cast<X*>(y), static_cast<float*>(state), gm);
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
             int b, int s, int h, int p, int g, int n, void* stream) {
  const Geom gm{b, s, h, p, g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch<X, 16>(x, dt, A, B, C, y, state, gm, st);
    case 32: return launch<X, 32>(x, dt, A, B, C, y, state, gm, st);
    case 64: return launch<X, 64>(x, dt, A, B, C, y, state, gm, st);
    case 128: return launch<X, 128>(x, dt, A, B, C, y, state, gm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_f32(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
            int b, int s, int h, int p, int g, int n, void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, state, b, s, h, p, g, n, stream);
}

int ssd_bf16(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, void* state,
             int b, int s, int h, int p, int g, int n, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, s, h, p, g, n, stream);
}

const char* ssd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
