// Flash attention (forward) for Hopper (sm_90a): GQA, causal and
// sliding-window masks with whole KV tiles skipped, optional logit softcap,
// ends aligned for Sq <= Sk. Plain C interface, loaded with ctypes by
// ../kernel.py; every entry launches on the caller's stream, allocates
// nothing (the wrapper passes the output) and returns cudaGetLastError().
//
// Layouts are the JAX package's: q (B, Sq, Hq, D), k and v (B, Sk, Hk, D),
// o (B, Sq, Hq, D); all float32 or all bfloat16, fp32 accumulation inside.
// Query head h reads KV head h / (Hq / Hk). Query row i sits at key
// position i + Sk - Sq. A key is seen when it is causal (kp <= qp, if
// causal) and inside the left window (qp - kp < window, if window > 0).
//
// Replaces: repro/kernels/attention/kernel.py:80, flash_attention
// (_flash_kernel), the Pallas kernel whose grid (B, Hq, Sq/bq) streams the
// KV sequence through VMEM with an online softmax.
//
// Both entries share the tiling: one block per (64-query tile, query head,
// batch row), a loop over KV tiles from the first tile the window reaches
// to the last the causal mask reaches (tiles outside are never loaded: the
// skipping the TPU kernel does), an online softmax in fp32. Masked scores
// are a finite -1e30 and their probabilities are 0, so a tile row that is
// fully masked adds nothing and never makes exp(-inf + inf). Query and key
// tails past Sq / Sk are masked in the kernel, so any length runs. Query
// tiles are issued last-first, so the longest causal rows start first.
//
// float32 (flash_kernel): bound by fp32 FMA operations (no tensor-core
// type keeps the JAX package's f32 pin: TF32 would not). Each thread owns
// a 4 x 4 block of the 64 x 64 score tile and 4 rows x D/16 columns of the
// output; K, V and P are staged in shared memory.
//
// bfloat16 (flash_kernel_tc): bound by bf16 tensor-core operations, 4 D
// per (query, key) pair inside the mask; at the Hymba-1.5B prefill (S
// 4096, D 64) ~64 operations per byte read, far above the HBM line. Four
// warps, each owning 16 query rows, run both products as
// mma.sync.m16n8k16 bf16 -> fp32 tiles, fragments loaded with ldmatrix
// (V with .trans). K and V stay bf16 in shared memory (rows padded by 16
// bytes, so the 8 rows an ldmatrix phase reads fall on distinct banks),
// double-buffered: tile j+1 is copied with 16-byte cp.async (rows past Sk
// zero-filled) while tile j is multiplied, one __syncthreads per tile.
// KV tiles are 64 keys (32 at D 256). Q's fragments are loaded once into
// registers (re-read from shared memory at D 256, where the 16 x 256
// output accumulator takes the registers). A score weighs 2^(x w - m w):
// one FFMA and one ex2.approx per score, the scale folded into w. The
// score accumulators are the A fragments of P.V: P never leaves the
// registers. P is carried as two bf16 terms, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi), two MMAs against the same V fragment: one bf16 term
// would put an error of ~2^-9 |p| into outputs near 0, beyond one bf16 ulp
// of the f32 result, which the port's bf16 check holds the kernel to. The
// mask is evaluated only on tiles that straddle the causal diagonal, the
// window edge or Sk for the warp's rows; interior tiles skip it. The
// output is staged through the warp's own Q rows and stored in 16-byte
// writes. wgmma with TMA and warp specialisation is the step after this.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

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
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ---------------------------------------------------------------- bfloat16

constexpr int TC_WARPS = 4;  // each owns 16 of the tile's BQ query rows
constexpr int TC_THREADS = 32 * TC_WARPS;
static_assert(BQ == 16 * TC_WARPS, "a warp owns one m16 tile of query rows");
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tc {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per KV tile
  static constexpr int DP = D + 8;               // padded row of a bf16 tile in shared memory
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * DP;  // Q, 2 stages of K and V
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below 2^-126 to 0 (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<unsigned*>(&v); }

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi): hi + lo is x within 2^-16 |x|
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. An fp32
// accumulator c[4] holds rows g (c0, c1) and g + 8 (c2, c3) at columns
// 2t, 2t + 1 of its 16 x 8 block; an A fragment a[4] holds rows g (a0, a2)
// and g + 8 (a1, a3) at columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9
// (a2, a3), two bf16 to a register. So the accumulators of key blocks 2 kk
// and 2 kk + 1 of S are P's A fragment for key step kk.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Params p) {
  static_assert(D % 16 == 0, "k16 steps over the head dim");
  constexpr int BKT = Tc<D>::BK, DP = Tc<D>::DP;
  constexpr int CH = D / 8;     // 16-byte chunks of a row
  constexpr int NS = BKT / 8;   // n8 blocks of a warp's 16 x BKT scores
  constexpr int NO = D / 8;     // n8 blocks of its 16 x D output
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // BQ x DP
  __nv_bfloat16* Ks = Qs + BQ * DP;                             // 2 stages x BKT x DP
  __nv_bfloat16* Vs = Ks + 2 * BKT * DP;                           // 2 stages x BKT x DP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int off = p.Sk - p.Sq;
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hk * D;
  const __nv_bfloat16* qg = q + ((size_t)b * p.Sq * p.Hq + h) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * p.Sk * p.Hk + hk) * D;
  const __nv_bfloat16* vg = v + ((size_t)b * p.Sk * p.Hk + hk) * D;

  // the keys this tile's rows can see: [k_lo, k_hi), in whole KV tiles
  const int qp_first = q0 + off;
  const int qp_last = min(q0 + BQ, p.Sq) - 1 + off;
  const int k_hi = p.causal ? min(p.Sk, qp_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, qp_first - p.window + 1) : 0;
  const int tile0 = k_lo / BKT;
  const int n_tiles = (k_hi - tile0 * BKT + BKT - 1) / BKT;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BKT;
    for (int c = tid; c < BKT * CH; c += TC_THREADS) {
      const int r = c / CH, cc = c % CH;
      const int kp = k0 + r;
      const size_t src = (size_t)min(kp, p.Sk - 1) * kv_row + cc * 8;
      const int dst = (stage * BKT + r) * DP + cc * 8;
      cp_async16(smem_u32(Ks + dst), kg + src, kp < p.Sk);
      cp_async16(smem_u32(Vs + dst), vg + src, kp < p.Sk);
    }
  };
  for (int c = tid; c < BQ * CH; c += TC_THREADS) {
    const int r = c / CH, cc = c % CH;
    const int qi = q0 + r;
    cp_async16(smem_u32(Qs + r * DP + cc * 8), qg + (size_t)min(qi, p.Sq - 1) * q_row + cc * 8, qi < p.Sq);
  }
  load_kv(tile0, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // ldmatrix row addresses of this lane (lr: row of an 8 x 8 matrix, lm: matrix)
  const int lr = lane & 7, lm = lane >> 3;
  const int row0 = warp * 16;  // the warp's first query row in the tile
  // Q (A, x4 = rows 0-7 / 8-15 x cols 0-7 / 8-15), K (B: keys 0-7 / 8-15 x
  // d 0-7 / 8-15), V (B transposed: keys 0-7 / 8-15 x d 0-7 / 8-15)
  const unsigned q_addr = smem_u32(Qs + (row0 + lr + 8 * (lm & 1)) * DP + 8 * (lm >> 1));
  const unsigned k_addr = smem_u32(Ks + (lr + 8 * (lm >> 1)) * DP + 8 * (lm & 1));
  const unsigned v_addr = smem_u32(Vs + (lr + 8 * (lm & 1)) * DP + 8 * (lm >> 1));
  constexpr unsigned STAGE_BYTES = BKT * DP * 2;

  // a score x (s = Q.K, or softcap tanh(s scale / softcap)) weighs
  // 2^(x w - m w), m the running row max of x: one FFMA and one ex2
  const bool cap = p.softcap > 0.f;
  const float w = cap ? LOG2E : p.scale * LOG2E;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const int qp_lo = q0 + row0 + off;  // the warp's first query position
  const int qp_g = qp_lo + g;         // this thread's rows: qp_g, qp_g + 8

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qf[Tc<D>::Q_IN_REGS ? D / 16 : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < n_tiles) {
      load_kv(tile0 + j + 1, (j + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if constexpr (Tc<D>::Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) ldsm_x4(q_addr + kd * 32, qf[kd]);
      }
    }
    const int k0 = (tile0 + j) * BKT;
    const unsigned ks = k_addr + (j & 1) * STAGE_BYTES;
    const unsigned vs = v_addr + (j & 1) * STAGE_BYTES;

    // S = Q K^T, 16 x BKT per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      unsigned a[4];
      if constexpr (Tc<D>::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldsm_x4(q_addr + kd * 32, a);
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        unsigned kb[4];
        ldsm_x4(ks + (n2 * 16 * DP + kd * 16) * 2, kb);
        mma_bf16(s[2 * n2], a, kb[0], kb[1]);
        mma_bf16(s[2 * n2 + 1], a, kb[2], kb[3]);
      }
    }

    // softcap; mask only where the tile straddles the causal diagonal, the
    // window edge or Sk for this warp's rows
    const bool edge = k0 + BKT > p.Sk || (p.causal && k0 + BKT - 1 > qp_lo) ||
                      (p.window > 0 && qp_lo + 15 - k0 >= p.window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap ? p.softcap * tanhf(s[n][e] * cap_in) : s[n][e];
        if (edge) {
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          const int qp = qp_g + 8 * (e >> 1);
          const bool ok = kp < p.Sk && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
          x = ok ? x : NEG;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float muc[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float mu = m_new == NEG ? 0.f : m_new;  // a row with no key yet: masked scores weigh 2^(-1e30 w) = 0
      alpha[r] = ex2((m[r] - mu) * w);
      muc[r] = mu * w;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P = p_hi + p_lo straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        const float p0 = ex2(fmaf(s[n][0], w, -muc[0])), p1 = ex2(fmaf(s[n][1], w, -muc[0]));
        const float p2 = ex2(fmaf(s[n][2], w, -muc[1])), p3 = ex2(fmaf(s[n][3], w, -muc[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        split_bf16x2(p0, p1, ph[2 * half], pl[2 * half]);
        split_bf16x2(p2, p3, ph[2 * half + 1], pl[2 * half + 1]);
      }
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        unsigned vb[4];
        ldsm_x4_trans(vs + (kk * 16 * DP + n2 * 16) * 2, vb);
        mma_bf16(acc[2 * n2], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * n2], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * n2 + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * n2 + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // epilogue: the quad's row sums, O / l in bf16 through the warp's own Q
  // rows (no other warp reads them), 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* Os = Qs + row0 * DP;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * DP + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * DP + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, cc = c % CH;
    const int qi = q0 + row0 + r;
    if (qi < p.Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)(b * p.Sq + qi) * p.Hq + h) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(Os + r * DP + cc * 8);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p, cudaStream_t stream) {
  void (*kern)(const T*, const T*, const T*, T*, Params);
  size_t smem;
  int threads;
  if constexpr (std::is_same<T, float>::value) {
    kern = flash_kernel<T, D>;
    smem = smem_bytes<D>();
    threads = THREADS;
  } else {
    kern = flash_kernel_tc<D>;
    smem = Tc<D>::SMEM;
    threads = TC_THREADS;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
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

// dynamic shared memory of the bf16 kernel at head width D (0: not instantiated)
int flash_attention_bf16_smem_bytes(int D) {
  switch (D) {
    case 16: return (int)Tc<16>::SMEM;
    case 32: return (int)Tc<32>::SMEM;
    case 64: return (int)Tc<64>::SMEM;
    case 128: return (int)Tc<128>::SMEM;
    case 256: return (int)Tc<256>::SMEM;
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
