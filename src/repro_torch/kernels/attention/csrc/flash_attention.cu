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
// batch row), four warps each owning 16 query rows, a loop over KV tiles
// from the first tile the window reaches to the last the causal mask
// reaches (tiles outside are never loaded: the skipping the TPU kernel
// does), an online softmax in fp32. Masked scores are a finite -1e30 and
// their probabilities are 0, so a tile row that is fully masked adds
// nothing and never makes exp(-inf + inf). Query and key tails past Sq /
// Sk are masked in the kernel, so any length runs; the mask is evaluated
// only on tiles that straddle the causal diagonal, the window edge or Sk
// for the warp's rows. Query tiles are issued last-first,
// so the longest causal rows start first. K and V are double-buffered in
// shared memory: tile j+1 is copied with 16-byte cp.async (rows past Sk
// zero-filled) while tile j is multiplied, one __syncthreads per tile. A
// score weighs 2^(x w - m w): one FFMA and one ex2.approx per score, the
// scale folded into w. The score accumulators are the A fragments of P.V:
// P never leaves the registers. Bound on this card by tensor-core
// operations, 4 D per (query, key) pair inside the mask; at the Hymba-1.5B
// prefill (S 4096, D 64) ~64 operations per byte read, far above the HBM
// line. wgmma with TMA and warp specialisation is the step after this.
//
// bfloat16 (flash_kernel_tc): both products as mma.sync.m16n8k16 bf16 ->
// fp32 tiles, fragments loaded with ldmatrix (V with .trans). K and V stay
// bf16 in shared memory (rows padded by 16 bytes, so the 8 rows an
// ldmatrix phase reads fall on distinct banks). KV tiles are 64 keys (32 at
// D 256). Q's fragments are loaded once into registers (re-read from shared
// memory at D 256, where the 16 x 256 output accumulator takes the
// registers). P is carried as two bf16 terms, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi), two MMAs against the same V fragment: one bf16 term
// would put an error of ~2^-9 |p| into outputs near 0, beyond one bf16 ulp
// of the f32 result, which the port's bf16 check holds the kernel to. The
// output is staged through the warp's own Q rows and stored in 16-byte
// writes.
//
// float32 (flash_kernel_tf32): both products as mma.sync.m16n8k8 TF32 with
// the 3xTF32 split of ../../deconv/csrc/phase_gemm.cuh: every operand
// becomes hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi), and a
// product takes lo.hi + hi.lo + hi.hi (the 165 TFLOP/s fp32-accurate rate;
// one TF32 term misses the port's f32 checks,
// tests/test_torch_flash_f32_tc.py). K and V stay fp32 in shared memory at
// a row pitch of D + 4 floats, which puts both the K fragment reads (key g,
// dim t) and the V fragment reads (keys 2t and 2t + 1, dim g) of a warp on
// 32 distinct banks. KV tiles are 64 keys up to D 32 and 32 above. Up to D
// 64 a thread keeps to 168 registers, so that three blocks share an SM (52
// KB of shared memory each at D 64; ~200 KB at D 256, one block): at
// Hymba's D 64 that ran faster than tiles of 64 keys at two blocks per SM.
// Q's split fragments stay in registers up to D 32; above that they are
// re-read from shared memory and split at use. P stays in registers
// without a shuffle: the accumulator holds columns 2t and 2t + 1 of rows
// g, g + 8, the m16n8k8 A fragment columns t and t + 4, so each 8-key step
// of P.V takes A column t as key 2t and column t + 4 as key 2t + 1, (c0,
// c1, c2, c3) -> (a0, a2, a1, a3), and reads V's B fragment in the same key
// order. An MMA rounds its sum toward zero, so each KV tile's P.V runs in
// a fresh accumulator chain, added to the rescaled running output by one
// FMA: one chain over 4096 keys would drift. The chains of up to 8 n8
// blocks of the output run side by side (one after another, each chain's
// dependent MMAs stall the warp). The softcap uses tanhf: tanh.approx's
// ~2^-11 relative error is ~0.02 on a score at softcap 50, far past the
// f32 pin. The output is stored from the fragments, 8 bytes a lane (a quad
// writes a 32-byte sector of a row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "../../deconv/csrc/phase_gemm.cuh"  // the mma.sync, ldmatrix, cp.async and TF32-split helpers

namespace {

using phase_gemm::cp_async16;
using phase_gemm::ldsm_x4;
using phase_gemm::ldsm_x4_trans;
using phase_gemm::mma_bf16;
using phase_gemm::mma_tf32;
using phase_gemm::smem_u32;
using phase_gemm::split_tf32;

constexpr int BQ = 64;
constexpr int WARPS = 4;  // each owns 16 of the tile's BQ query rows
constexpr int THREADS = 32 * WARPS;
static_assert(BQ == 16 * WARPS, "a warp owns one m16 tile of query rows");
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int B, Sq, Sk, Hq, Hk, causal, window;
  float scale, softcap;
};

// The tiles of each entry at head width D: keys per KV tile, the padded
// row pitch (in elements) of the tiles in shared memory, whether Q's
// fragments live in registers, and the dynamic shared memory of Q and two
// stages of K and V.
template <typename T, int D> struct Tile;
template <int D> struct Tile<__nv_bfloat16, D> {
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int DP = D + 8;
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * DP;
};
template <int D> struct Tile<float, D> {
  static constexpr int BK = D <= 32 ? 64 : 32;
  static constexpr int DP = D + 4;
  static constexpr bool Q_IN_REGS = D <= 32;
  static constexpr int NG = D / 8 < 8 ? D / 8 : 8;  // n8 blocks of the output whose P.V chains run side by side
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;  // per SM: at most 168 registers a thread up to D 64
  static constexpr size_t SMEM = sizeof(float) * (size_t)(BQ + 4 * BK) * DP;
};

// 2^x, flushing results below 2^-126 to 0 (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- bfloat16

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
__global__ void __launch_bounds__(THREADS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Params p) {
  static_assert(D % 16 == 0, "k16 steps over the head dim");
  using Tl = Tile<__nv_bfloat16, D>;
  constexpr int BKT = Tl::BK, DP = Tl::DP;
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
    for (int c = tid; c < BKT * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const int kp = k0 + r;
      const size_t src = (size_t)min(kp, p.Sk - 1) * kv_row + cc * 8;
      const int dst = (stage * BKT + r) * DP + cc * 8;
      cp_async16(smem_u32(Ks + dst), kg + src, kp < p.Sk);
      cp_async16(smem_u32(Vs + dst), vg + src, kp < p.Sk);
    }
  };
  for (int c = tid; c < BQ * CH; c += THREADS) {
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
  unsigned qf[Tl::Q_IN_REGS ? D / 16 : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < n_tiles) {
      load_kv(tile0 + j + 1, (j + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if constexpr (Tl::Q_IN_REGS) {
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
      if constexpr (Tl::Q_IN_REGS) {
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

// ----------------------------------------------------------------- float32

// The steps of flash_kernel_tf32. (flash_kernel_tc keeps its own inline
// copies: written through these helpers its machine code changed and it ran
// slower at Hymba-1.5B's shape.)

// The KV tiles of bk keys that query tile q0's rows can see: [first, first + count)
struct KvTiles {
  int first, count;
};

__device__ __forceinline__ KvTiles kv_tiles(const Params& p, int q0, int bk) {
  const int off = p.Sk - p.Sq;
  const int qp_first = q0 + off;
  const int qp_last = min(q0 + BQ, p.Sq) - 1 + off;
  const int k_hi = p.causal ? min(p.Sk, qp_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, qp_first - p.window + 1) : 0;
  const int first = k_lo / bk;
  return {first, (k_hi - first * bk + bk - 1) / bk};
}

// ROWS rows of D floats, row r from src + min(r0 + r, n - 1) * stride,
// into shared memory at a pitch of DP floats, in 16-byte cp.async chunks;
// rows at or past n are zero-filled. TWO: the same rows of a second tensor
// too (K and V).
template <int D, int DP, int ROWS, bool TWO>
__device__ __forceinline__ void copy_rows(float* da, float* db, const float* sa, const float* sb, size_t stride,
                                          int r0, int n, int tid) {
  constexpr int CH = D / 4;  // chunks of a row
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const int row = r0 + r;
    const size_t src = (size_t)min(row, n - 1) * stride + cc * 4;
    const int dst = r * DP + cc * 4;
    cp_async16(smem_u32(da + dst), sa + src, row < n);
    if constexpr (TWO) cp_async16(smem_u32(db + dst), sb + src, row < n);
  }
}

// How a score x weighs: 2^(x w - m w), with x = s (s = Q.K) or, with a
// softcap, x = softcap tanh(s cap_in)
struct Weigh {
  bool cap;
  float w, cap_in;
};

__device__ __forceinline__ Weigh weigh(const Params& p) {
  const bool cap = p.softcap > 0.f;
  return {cap, cap ? LOG2E : p.scale * LOG2E, cap ? p.scale / p.softcap : 0.f};
}

// One KV tile of the online softmax for a warp's 16 query rows. s: the 16
// x 8 NS scores in accumulator layout (s[n][e]: key k0 + 8 n + 2 t + (e & 1)
// of this lane's row qp_g + 8 (e >> 1)); qp_lo: the warp's first query
// position. Applies the softcap and, where the tile straddles the causal
// diagonal, the window edge or Sk for the warp's rows, the mask; moves the
// running row max m, scales this lane's row sums l, and returns per row
// alpha (the factor of the running sums) and muc = mu w, so that a score x
// weighs 2^(x w - muc).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float (&muc)[2], const Params& p, const Weigh& wg, int k0, int qp_lo,
                                             int qp_g, int t) {
  constexpr int BKT = 8 * NS;
  const bool edge = k0 + BKT > p.Sk || (p.causal && k0 + BKT - 1 > qp_lo) ||
                    (p.window > 0 && qp_lo + 15 - k0 >= p.window);
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = wg.cap ? p.softcap * tanhf(s[n][e] * wg.cap_in) : s[n][e];
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float mu = m_new == NEG ? 0.f : m_new;  // a row with no key yet: masked scores weigh 2^(-1e30 w) = 0
    alpha[r] = ex2((m[r] - mu) * wg.w);
    muc[r] = mu * wg.w;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
}

// The quad's row sums -> 1 / l per row
__device__ __forceinline__ void row_inverse(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k8 tf32; lane = 4 g + t): A a0 (row
// g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t,
// n g), b1 (k t + 4, n g); the accumulator as for bf16.
template <int D>
__global__ void __launch_bounds__(THREADS, Tile<float, D>::MIN_BLOCKS)
flash_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ o, Params p) {
  static_assert(D % 16 == 0, "16-byte rows of Q, K and V; k8 steps over the head dim");
  using Tl = Tile<float, D>;
  constexpr int BKT = Tl::BK, DP = Tl::DP;
  constexpr int NS = BKT / 8;  // n8 blocks of a warp's 16 x BKT scores; k8 steps of P.V
  constexpr int NO = D / 8;    // n8 blocks of its 16 x D output
  constexpr int KD = D / 8;    // k8 steps of Q.K^T
  constexpr int NG = Tl::NG;
  static_assert(NO % NG == 0, "whole groups of n8 blocks");
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // BQ x DP
  float* Ks = Qs + BQ * DP;                        // 2 stages x BKT x DP
  float* Vs = Ks + 2 * BKT * DP;                   // 2 stages x BKT x DP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hk * D;
  const float* qg = q + ((size_t)b * p.Sq * p.Hq + h) * D;
  const float* kg = k + ((size_t)b * p.Sk * p.Hk + hk) * D;
  const float* vg = v + ((size_t)b * p.Sk * p.Hk + hk) * D;
  const KvTiles kt = kv_tiles(p, q0, BKT);

  auto load_kv = [&](int tile, int stage) {
    copy_rows<D, DP, BKT, true>(Ks + stage * BKT * DP, Vs + stage * BKT * DP, kg, vg, kv_row, tile * BKT, p.Sk,
                                tid);
  };
  copy_rows<D, DP, BQ, false>(Qs, nullptr, qg, nullptr, q_row, q0, p.Sq, tid);
  load_kv(kt.first, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  const int row0 = warp * 16;                  // the warp's first query row in the tile
  const float* qa = Qs + (row0 + g) * DP + t;  // A of Q.K^T: row g, dim t
  // Q's k8 step kd as hi and lo A fragments
  auto q_frag = [&](int kd, unsigned (&hi)[4], unsigned (&lo)[4]) {
    const float* a = qa + kd * 8;
    split_tf32(a[0], hi[0], lo[0]);
    split_tf32(a[8 * DP], hi[1], lo[1]);
    split_tf32(a[4], hi[2], lo[2]);
    split_tf32(a[8 * DP + 4], hi[3], lo[3]);
  };

  const Weigh wg = weigh(p);
  const int qp_lo = q0 + row0 + p.Sk - p.Sq;  // the warp's first query position
  const int qp_g = qp_lo + g;                 // this thread's rows: qp_g, qp_g + 8

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qh[Tl::Q_IN_REGS ? KD : 1][4], ql[Tl::Q_IN_REGS ? KD : 1][4];

  for (int j = 0; j < kt.count; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + 1 < kt.count) {
      load_kv(kt.first + j + 1, (j + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if constexpr (Tl::Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) q_frag(kd, qh[kd], ql[kd]);
      }
    }
    const int k0 = (kt.first + j) * BKT;
    const float* kb = Ks + (j & 1) * BKT * DP + g * DP + t;      // B of Q.K^T: key 8 n + g, dim 8 kd + t
    const float* vb = Vs + (j & 1) * BKT * DP + 2 * t * DP + g;  // B of P.V: key 8 kk + 2 t, dim 8 n + g

    // S = Q K^T, 16 x BKT per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned ah[4], al[4];
      if constexpr (Tl::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kd][e];
          al[e] = ql[kd][e];
        }
      } else {
        q_frag(kd, ah, al);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(kb[n * 8 * DP + kd * 8], bh0, bl0);
        split_tf32(kb[n * 8 * DP + kd * 8 + 4], bh1, bl1);
        mma_tf32(s[n], al, bh0, bh1);
        mma_tf32(s[n], ah, bl0, bl1);
        mma_tf32(s[n], ah, bh0, bh1);
      }
    }

    float alpha[2], muc[2];
    softmax_tile(s, m, l, alpha, muc, p, wg, k0, qp_lo, qp_g, t);

    // P as hi and lo A fragments, key step n: A column t is key 2t, column t + 4 key 2t + 1
    unsigned ph[NS][4], pl[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = ex2(fmaf(s[n][0], wg.w, -muc[0])), p1 = ex2(fmaf(s[n][1], wg.w, -muc[0]));
      const float p2 = ex2(fmaf(s[n][2], wg.w, -muc[1])), p3 = ex2(fmaf(s[n][3], wg.w, -muc[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      split_tf32(p0, ph[n][0], pl[n][0]);
      split_tf32(p2, ph[n][1], pl[n][1]);
      split_tf32(p1, ph[n][2], pl[n][2]);
      split_tf32(p3, ph[n][3], pl[n][3]);
    }

    // O = O alpha + P V, this tile's P V in a fresh chain per n8 block,
    // NG chains side by side
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      float pv[NG][4];
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(vb[kk * 8 * DP + (n0 + i) * 8], bh0, bl0);
          split_tf32(vb[kk * 8 * DP + DP + (n0 + i) * 8], bh1, bl1);
          mma_tf32(pv[i], pl[kk], bh0, bh1);
          mma_tf32(pv[i], ph[kk], bl0, bl1);
          mma_tf32(pv[i], ph[kk], bh0, bh1);
        }
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        acc[n0 + i][0] = fmaf(acc[n0 + i][0], alpha[0], pv[i][0]);
        acc[n0 + i][1] = fmaf(acc[n0 + i][1], alpha[0], pv[i][1]);
        acc[n0 + i][2] = fmaf(acc[n0 + i][2], alpha[1], pv[i][2]);
        acc[n0 + i][3] = fmaf(acc[n0 + i][3], alpha[1], pv[i][3]);
      }
    }
  }

  // epilogue: O / l, 8 bytes a lane straight from the fragments
  float inv[2];
  row_inverse(l, inv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.Sq) continue;
    float* out = o + ((size_t)(b * p.Sq + qi) * p.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p, cudaStream_t stream) {
  void (*kern)(const T*, const T*, const T*, T*, Params);
  if constexpr (std::is_same<T, float>::value)
    kern = flash_kernel_tf32<D>;
  else
    kern = flash_kernel_tc<D>;
  constexpr size_t smem = Tile<T, D>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
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

template <typename T>
int smem_bytes(int D) {
  switch (D) {
    case 16: return (int)Tile<T, 16>::SMEM;
    case 32: return (int)Tile<T, 32>::SMEM;
    case 64: return (int)Tile<T, 64>::SMEM;
    case 128: return (int)Tile<T, 128>::SMEM;
    case 256: return (int)Tile<T, 256>::SMEM;
    default: return 0;
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

// dynamic shared memory of each entry's kernel at head width D (0: not instantiated)
int flash_attention_f32_smem_bytes(int D) { return smem_bytes<float>(D); }
int flash_attention_bf16_smem_bytes(int D) { return smem_bytes<__nv_bfloat16>(D); }

const char* flash_attention_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
