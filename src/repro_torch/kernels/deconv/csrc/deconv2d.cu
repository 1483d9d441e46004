// deconv2d for Hopper (sm_90a): the k4/s2 transposed convolution with the
// torch padding=1 border crop folded in, plus an optional bias. Plain C
// interface, loaded with ctypes by ../kernel.py; every entry launches on the
// caller's stream, allocates nothing (the wrapper passes the output and the
// split-K scratch) and returns cudaGetLastError().
//
// Layouts are the JAX package's: x (B, H, W, Cin) NHWC, w (4, 4, Cin, Cout)
// as lax.conv_transpose applies it, y (B, 2H, 2W, Cout); x, w and y all
// float32 or all bfloat16, bias float32; fp32 accumulation throughout.
//
// Replaces: repro/kernels/deconv/kernel.py, deconv2d_pallas (_deconv_kernel,
// _phase_matmuls), with the bias the JAX wrapper adds outside
// (repro/kernels/deconv/ops.py) moved into the epilogue.
//
// Bound on this card: at the Pix2Pix up blocks' shapes, bytes for the deep
// 1x1..8x8 inputs (the 4x4xCinxCout weight, up to 32 MB, is read for 4..256
// output pixels per image) and fp32 FMA operations for the wide 16x16..128x128
// ones (4*Cin multiply-adds per output element).
//
// Design: output stationary, one GEMM per output parity phase. Output pixel
// (2u+a, 2v+b) sums, over its phase's 2x2 taps (i, j) and Cin, x[u+a-1+i,
// v+b-1+j] * w[a+2i, b+2j]: rows M = B*H*W, K = 4*Cin ordered tap-major,
// N = Cout (grid z = phase x split of K). No zero is inserted and no cropped
// output is computed. K tiles are staged through shared memory as fp32; each
// thread keeps a TM x TN micro-tile in registers (no tensor cores, no TF32).
//  - A tap whose input row or column falls outside [0,H) x [0,W) for every
//    row of the block's tile is skipped before its weights are loaded: at the
//    1x1 bottleneck each phase reads 1 of its 4 taps, so 3/4 of the weight
//    bytes are never read.
//  - The N tile follows Cout: 64 wide, or 4 wide with 256 rows for Cout <= 4
//    (the final RGB layer, which a 64-wide tile would fill to 3/64).
//  - Layers with too few output tiles to fill the card split K over more
//    blocks into a partial buffer that one pass sums in a fixed order and
//    adds the bias to (no atomics: results are bit-reproducible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 16;
constexpr int THREADS = 256;

struct Geom {
  int B, H, W, Cin, Cout;
  int M;     // GEMM rows per phase: B*H*W
  int K;     // 4*Cin
  int Mtot;  // output pixels: B*2H*2W
  int splitk, kt_per_split;
  int has_bias;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One BM x BN output tile of one phase and one split of K; each of the 256
// threads owns TM rows x TN columns of it.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
deconv2d_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                T* __restrict__ y, float* __restrict__ part, Geom g) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one thread per micro-tile");
  static_assert(BM <= THREADS, "the tap vote gives each tile row one thread");
  static_assert(THREADS % BK == 0 && (BK * BM) % THREADS == 0, "whole A loads per thread");
  constexpr int A_PER = BK * BM / THREADS;
  constexpr int A_STRIDE = THREADS / BK;
  constexpr int NT = BN / TN;
  __shared__ float As[BK][BM + 4];  // +4: the transposed store spreads over banks
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int phase = (int)blockIdx.z / g.splitk;
  const int split = (int)blockIdx.z - phase * g.splitk;
  const int pa = phase >> 1, pb = phase & 1;
  const int HW = g.H * g.W;

  // Which of the phase's 4 taps reach a real input for some row of this tile.
  bool live[4];
  {
    const int m = m0 + tid;
    int u = -4, v = -4;  // rows past the tile or the tensor reach nothing
    if (tid < BM && m < g.M) {
      const int r = m % HW;
      u = r / g.W;
      v = r - u * g.W;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ih = u + pa - 1 + (t >> 1), iw = v + pb - 1 + (t & 1);
      live[t] = __syncthreads_or(ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) != 0;
    }
  }

  // A loads: 16 consecutive threads walk 16 consecutive K indices (channels).
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[A_PER], a_ih[A_PER], a_iw[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int m = m0 + a_m + A_STRIDE * j;
    if (m < g.M) {
      const int b = m / HW;
      const int r = m - b * HW;
      const int u = r / g.W;
      a_base[j] = b * HW * g.Cin;
      a_ih[j] = u + pa - 1;
      a_iw[j] = r - u * g.W + pb - 1;
    } else {
      a_base[j] = 0;
      a_ih[j] = -4;  // never in range: the row loads zeros
      a_iw[j] = -4;
    }
  }

  const int tx = tid % NT, ty = tid / NT;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nkt = (g.K + BK - 1) / BK;
  const int kt0 = split * g.kt_per_split;
  const int kt1 = min(nkt, kt0 + g.kt_per_split);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int kbase = kt * BK;
    const int t_lo = kbase / g.Cin;
    const int t_hi = (min(kbase + BK, g.K) - 1) / g.Cin;
    bool any = false;
    for (int t = t_lo; t <= t_hi; ++t) any = any || live[t];
    if (!any) continue;  // the same for every thread of the block
    {
      const int kk = kbase + a_k;
      const bool kok = kk < g.K;
      const int tap = kok ? kk / g.Cin : 0;
      const int ci = kk - tap * g.Cin;
      const int di = tap >> 1, dj = tap & 1;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const int ih = a_ih[j] + di, iw = a_iw[j] + dj;
        float v = 0.f;
        if (kok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = to_f(x[a_base[j] + (ih * g.W + iw) * g.Cin + ci]);
        As[a_k][a_m + A_STRIDE * j] = v;
      }
    }
    // B loads: consecutive threads walk consecutive output channels.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kr = e / BN, nn = e - kr * BN;
      const int kk = kbase + kr, n = n0 + nn;
      float v = 0.f;
      if (kk < g.K && n < g.Cout) {
        const int tap = kk / g.Cin;
        const int ci = kk - tap * g.Cin;
        const int th = pa + 2 * (tap >> 1), tw = pb + 2 * (tap & 1);
        v = to_f(w[((size_t)(th * 4 + tw) * g.Cin + ci) * g.Cout + n]);
      }
      Bs[kr][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.M) continue;
    const int b = m / HW;
    const int r = m - b * HW;
    const int u = r / g.W;
    const int v = r - u * g.W;
    const size_t orow = ((size_t)b * 2 * g.H + 2 * u + pa) * (2 * g.W) + 2 * v + pb;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= g.Cout) continue;
      if (g.splitk == 1)
        y[orow * g.Cout + n] = from_f<T>(acc[i][j] + (g.has_bias ? bias[n] : 0.f));
      else
        part[((size_t)split * g.Mtot + orow) * g.Cout + n] = acc[i][j];
    }
  }
}

// Sum the K splits in a fixed order, add the bias, round to the output type.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                                     T* __restrict__ y, int splitk, int total, int C,
                                     int has_bias) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splitk; ++z) s += part[(size_t)z * total + i];
    y[i] = from_f<T>(s + (has_bias ? bias[i % C] : 0.f));
  }
}

template <typename T, int BM, int BN, int TM, int TN>
int launch(const void* x, const void* w, const void* bias, void* y, void* part, const Geom& g,
           cudaStream_t stream) {
  dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN, 4 * g.splitk);
  deconv2d_kernel<T, BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<float*>(part), g);
  int err = (int)cudaGetLastError();
  if (err || g.splitk == 1) return err;
  const int total = g.Mtot * g.Cout;
  int blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                      static_cast<const float*>(bias),
                                                      static_cast<T*>(y), g.splitk, total, g.Cout,
                                                      g.has_bias);
  return (int)cudaGetLastError();
}

template <typename T>
int deconv2d(const void* x, const void* w, const void* bias, void* y, void* part, int B, int H,
             int W, int Cin, int Cout, int narrow, int splitk, int kt_per_split, void* stream_ptr) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.M = B * H * W;
  g.K = 4 * Cin;
  g.Mtot = B * 4 * H * W;
  g.splitk = splitk;
  g.kt_per_split = kt_per_split;
  g.has_bias = bias != nullptr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (narrow) return launch<T, 256, 4, 1, 4>(x, w, bias, y, part, g, stream);
  return launch<T, 64, 64, 4, 4>(x, w, bias, y, part, g, stream);
}

}  // namespace

extern "C" {

const char* deconv2d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x (B,H,W,Cin), w (4,4,Cin,Cout), bias (Cout) float32 or null -> y (B,2H,2W,Cout).
// narrow: the 256x4 tile (Cout <= 4) instead of 64x64. part: splitk *
// B*2H*2W*Cout floats when splitk > 1, else unused.
int deconv2d_f32(const void* x, const void* w, const void* bias, void* y, void* part, int B, int H,
                 int W, int Cin, int Cout, int narrow, int splitk, int kt_per_split,
                 void* stream) {
  return deconv2d<float>(x, w, bias, y, part, B, H, W, Cin, Cout, narrow, splitk, kt_per_split,
                         stream);
}

int deconv2d_bf16(const void* x, const void* w, const void* bias, void* y, void* part, int B,
                  int H, int W, int Cin, int Cout, int narrow, int splitk, int kt_per_split,
                  void* stream) {
  return deconv2d<__nv_bfloat16>(x, w, bias, y, part, B, H, W, Cin, Cout, narrow, splitk,
                                 kt_per_split, stream);
}

}  // extern "C"
