// The k4/s2 transposed convolution with the torch padding=1 crop folded in,
// for Hopper (sm_90a): the phase GEMM that deconv2d.cu and
// ../../fused/csrc/fused_blocks.cu (deconv_block) both launch, as the JAX
// package's deconv_block_pallas reuses deconv/kernel.py's _phase_matmuls.
// fused_blocks.cu's conv GEMM runs the same K loop (gemm_k_loop) over a
// conv's taps.
//
// Layouts are the JAX package's: x (B, H, W, Cin) NHWC, w (4, 4, Cin, Cout)
// as lax.conv_transpose applies it, y (B, 2H, 2W, Cout); x, w and y float32
// or bfloat16, bias float32, fp32 accumulation throughout.
//
// Semantics. Output pixel (2u+a, 2v+b) of parity phase (a, b) sums, over the
// phase's 2x2 taps (i, j) and Cin, x[u+a-1+i, v+b-1+j] * w[a+2i, b+2j]: one
// GEMM per phase with M = B*H*W rows, K = 4*Cin in tap-major order (tap
// 2i+j, then channel) and N = Cout. No zero is inserted, no cropped output
// is computed. Bias, and the activation when the caller has no norm after
// it, go in the epilogue.
//
// Bound on this card: weight bytes for the deep 1x1..8x8 inputs at batch 1
// (a 4x4xCinxCout weight, up to 32 MB, for 4..256 output pixels), operations
// for the wide 16x16..64x64 layers (4*Cin multiply-adds per output element),
// bytes for the Cout <= 4 final layer (x is read once, 3 outputs a pixel).
//
// phase_gemm_kernel<T, BM, VEC>: tensor cores through mma.sync.
//  - f32: m16n8k8 TF32 with the 3xTF32 split. At fragment load each operand
//    becomes hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi); the
//    accumulator takes lo*hi + hi*lo + hi*hi, the small terms first. One
//    TF32 product misses the port's 1e-4 f32 pin about tenfold at K = 4096;
//    the split lands where plain fp32 does (tests/test_torch_deconv_tc.py).
//    .tf32 reads only the top 19 bits of a register, so both terms go through
//    cvt.rna: a raw fp32 value would be truncated, not split. Each K tile's
//    products run in a fresh accumulator chain, added to the running sum in
//    fp32: an MMA rounds toward zero, and a chain over all of K drifts.
//  - bf16: m16n8k16, one term (products of two bf16 values are exact in fp32).
//  - A BM x 64 output tile of one phase (BM 64 or 128; warp tiles 64 x 32
//    for the f32 128-row tile, else 32 x 32), K tiles of 128 bytes (32 f32
//    or 64 bf16 channels). With VEC (Cin a multiple of the K tile, Cout of
//    16 bytes, 16-byte aligned x and w) a K tile is channels of one tap:
//    each A row is 128 contiguous bytes of one input pixel, loaded with
//    16-byte cp.async, zero-filled when the tap falls outside the input; B
//    rows are contiguous over Cout. Otherwise the threads stage the tile
//    element by element (K zero-padded): right, not fast. A 3-stage ring,
//    one __syncthreads per K tile; shared-memory rows padded so that
//    ldmatrix and the B fragment loads are conflict-free.
//  - A tap that reaches no input for any row of the block is skipped before
//    its weights load (the block votes): at the 1x1 bottleneck a phase reads
//    1 of its 4 taps, so 3/4 of the weight bytes are never read.
//  - Layers with too few output tiles to fill the card split the block's
//    live K tiles over blocks into a partial buffer that one pass sums in a
//    fixed order (no atomics: results are bit-reproducible).
//
// narrow_kernel<T, NC>: Cout = NC <= 4, the final RGB layer. A 64-wide tile
// of N would do 3/64 useful work, and a phase per block would read x four
// times (67 MB at batch 8, more than the 50 MB L2). So all four phases are
// fused: a block covers TR input rows x 64 columns, stages 32 channels at a
// time of those rows of x with a one-pixel halo, and the weights of those
// channels, in shared memory (fp32); each thread accumulates the 2x2 output
// pixels (the four phases) x NC of 2 x 2 input positions with fp32 FMA. x
// is read from HBM once. With TR < 8 (smaller batches) the block's 4 warps
// also split the channels and add their sums through shared memory at the
// end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// Internal linkage: deconv2d.cu's and fused_blocks.cu's libraries each keep
// their own copy. (With external linkage the function-local statics of the
// templates below would be STB_GNU_UNIQUE symbols, shared by the two
// libraries in one process: the second library would skip raising its own
// kernels' shared-memory limit, and their launches would be refused.)
namespace {
namespace phase_gemm {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_LRELU: return y >= 0.f ? y : 0.2f * y;
    case ACT_SILU: return y / (1.f + expf(-y));
    case ACT_TANH: return tanhf(y);
    default: return y;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct PhaseGeom {
  int B, H, W, Cin, Cout;
  int M;       // GEMM rows per phase: B*H*W
  int K;       // 4*Cin
  int Mtot;    // output pixels: B*2H*2W
  int splitk;  // splits of each block's live K tiles
  int per;     // live K tiles per split
  int act;     // applied in the epilogue (ACT_NONE when a norm follows)
};

constexpr int BN = 64;      // output channels per GEMM tile
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int NCOLS = 64;   // input columns per narrow block: 32 lanes x 2
constexpr int NCK = 32;     // channels per narrow staging pass
constexpr int NTHREADS = 128;

// A K tile is 128 bytes of an input pixel: 32 f32 or 64 bf16 channels.
// Shared-memory row pitches in elements: 16 bytes of padding on an A row
// (ldmatrix's 8 rows fall on distinct banks), 8 elements on a B row (f32:
// the scalar fragment loads t*72 + g hit 32 banks; bf16: ldmatrix.trans).
template <typename T> struct Tile {
  static constexpr int K = 128 / (int)sizeof(T);
  static constexpr int A = K + 16 / (int)sizeof(T);
  static constexpr int B = BN + 8;
};

template <typename T>
__host__ __device__ constexpr size_t gemm_smem_bytes(int bm) {
  return sizeof(T) * (size_t)STAGES * (bm * Tile<T>::A + Tile<T>::K * Tile<T>::B);
}

// a channel plane of the narrow tile: (TR + 2) x 66 floats, padded to 2 mod
// 32 words so that the channel-major staging stores are at most 2-way
// conflicted and every even column stays 8-byte aligned
__host__ __device__ constexpr int narrow_plane(int tr) {
  return (tr + 2) * (NCOLS + 2) + (((2 - (tr + 2) * (NCOLS + 2)) % 32) + 32) % 32;
}

__host__ __device__ constexpr size_t narrow_smem_bytes(int tr) {
  return sizeof(float) * ((size_t)NCK * narrow_plane(tr) + NCK * 16 * 4);  // x planes, weights (NC <= 4)
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// v -> (hi, lo) TF32 bit patterns, hi = rna(v), lo = rna(v - hi): hi + lo is
// v within about 2^-22 |v|. cvt leaves hi's 13 low mantissa bits zero, so
// hi read as a float is the rounded value and v - hi is exact.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  unsigned h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l;
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX ISA, mma.sync; lane = 4 g + t). Accumulator c[4]:
// rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1. m16n8k8 tf32: A
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), which is what
// ldmatrix.x4 gives when each 16-byte row holds 4 floats; B b0 (k t, n g),
// b1 (k t + 4, n g), loaded one float at a time (ldmatrix cannot transpose
// 32-bit elements). m16n8k16 bf16: A through ldmatrix.x4, B through
// ldmatrix.x4.trans from the (k, n) rows, as the flash kernel loads V.
//
// A warp's tile is WR x 32: WR = 64 for the f32 128-row tile (each split
// fragment feeds more MMAs), else 32; a block has (BM / WR) x 2 warps.
template <typename T, int BM>
__host__ __device__ constexpr int warp_rows() {
  return sizeof(T) == 4 && BM == 128 ? 64 : 32;
}

template <typename T, int BM>
__host__ __device__ constexpr int gemm_threads() {
  return 64 * BM / warp_rows<T, BM>();
}

// The K loop of both tensor-core implicit GEMMs, phase_gemm_kernel below and
// fused_blocks.cu's conv_gemm_kernel: from K tile kt, up to todo live tiles
// (tile_live(kt): the tile holds a tap the block voted live) through a
// STAGES-deep cp.async ring (load_tile(k_tile, stage) issues one tile's
// copies into stage), their MMAs summed into acc, the warp's WR x 32 tile of
// the block's BM x 64 output (fragment layout above).
template <typename T, int BM, typename Live, typename Load>
__device__ __forceinline__ void gemm_k_loop(const T* As, int kt, int todo, int nkt, Live tile_live, Load load_tile,
                                           float (&acc)[warp_rows<T, BM>() / 16][4][4]) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int WR = warp_rows<T, BM>(), MI = WR / 16;
  constexpr int BK = Tile<T>::K, AP = Tile<T>::A, BP = Tile<T>::B;
  constexpr int A_STAGE = BM * AP, B_STAGE = BK * BP;
  const T* Bs = As + STAGES * A_STAGE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // ldmatrix row addresses of this lane (lr: row of an 8 x 8 matrix, lm: matrix)
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned a_addr = smem_u32(As + (wm * WR + lr + 8 * (lm & 1)) * AP + (F32 ? 4 : 8) * (lm >> 1));
  const unsigned b_addr = smem_u32(Bs + (lr + 8 * (lm & 1)) * BP + wn * 32 + 8 * (lm >> 1));
  const T* b_frag = Bs + tq * BP + wn * 32 + gq;  // f32: B fragment element (k t, n g)

  int loaded = 0;
  auto load_next = [&]() {
    if (todo > 0 && kt < nkt) {
      load_tile(kt, loaded % STAGES);
      ++loaded;
      --todo;
      ++kt;
      while (kt < nkt && !tile_live(kt)) ++kt;
    }
    cp_async_commit();  // an empty group when there is nothing left: the count stays in step
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();

  for (int j = 0; j < loaded; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j is in; every warp is done with the stage the next load overwrites
    load_next();
    const int stage = j % STAGES;
    if constexpr (F32) {
      const unsigned as = a_addr + stage * A_STAGE * 4;
      const float* bs = b_frag + stage * B_STAGE;
      // this K tile's products, in a chain of their own: an MMA rounds its
      // sum toward zero, so one chain over all of K drifts (1.1e-4 at K =
      // 4096); per tile, added with round-to-nearest, the error is plain
      // fp32's
      float tacc[MI][4][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[mi][ni][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        unsigned ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          unsigned r[4];
          ldsm_x4(as + (mi * 16 * AP + ks * 8) * 4, r);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ah[mi][e], al[mi][e]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          split_tf32(bs[ks * 8 * BP + ni * 8], bh[ni][0], bl[ni][0]);
          split_tf32(bs[(ks * 8 + 4) * BP + ni * 8], bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma_tf32(tacc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
            mma_tf32(tacc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
            mma_tf32(tacc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
          }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += tacc[mi][ni][e];
    } else {
      const unsigned as = a_addr + stage * A_STAGE * 2;
      const unsigned bs = b_addr + stage * B_STAGE * 2;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        unsigned a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldsm_x4(as + (mi * 16 * AP + ks * 16) * 2, a[mi]);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned b[4];
          ldsm_x4_trans(bs + (ks * 16 * BP + nj * 16) * 2, b);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// One BM x 64 output tile of one phase and one split of its live K tiles.
// O: the output type, T's own or (fused_blocks.cu, when a norm follows a
// bf16 GEMM) float.
template <typename T, int BM, bool VEC, typename O = T>
__global__ void __launch_bounds__(gemm_threads<T, BM>())
phase_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                  O* __restrict__ y, float* __restrict__ part, PhaseGeom g) {
  constexpr int WR = warp_rows<T, BM>(), MI = WR / 16;  // MI m16 fragments down a warp's tile
  constexpr int THREADS = gemm_threads<T, BM>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = Tile<T>::K, AP = Tile<T>::A, BP = Tile<T>::B;
  constexpr int A_STAGE = BM * AP, B_STAGE = BK * BP;
  static_assert((BM == 64 || BM == 128) && THREADS >= BM, "2 warps across N; a thread per row for the tap vote");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's WR x 32 tile: rows WR wm, columns 32 wn
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int phase = (int)blockIdx.z / g.splitk;
  const int split = (int)blockIdx.z - phase * g.splitk;
  const int pa = phase >> 1, pb = phase & 1;
  const int HW = g.H * g.W;

  // Which of the phase's 4 taps reach a real input for some row of this tile.
  int live = 0;
  {
    int u = -4, v = -4;  // rows past the tile or the tensor reach nothing
    if (tid < BM && m0 + tid < g.M) {
      const int r = (m0 + tid) % HW;
      u = r / g.W;
      v = r - u * g.W;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ih = u + pa - 1 + (t >> 1), iw = v + pb - 1 + (t & 1);
      live |= (__syncthreads_or(ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) != 0) << t;
    }
  }
  const int nkt = (g.K + BK - 1) / BK;
  auto tile_live = [&](int kt) {
    const int k0 = kt * BK;
    const int t_lo = k0 / g.Cin, t_hi = (min(k0 + BK, g.K) - 1) / g.Cin;
    return ((live >> t_lo) & ((2 << (t_hi - t_lo)) - 1)) != 0;
  };
  // this split's share of the block's live K tiles: [split * per, split * per + per)
  int kt = 0;
  while (kt < nkt && !tile_live(kt)) ++kt;
  for (int i = split * g.per; i > 0 && kt < nkt; --i) {
    ++kt;
    while (kt < nkt && !tile_live(kt)) ++kt;
  }

  // VEC staging: thread -> (rows tid / CPR + i * A_ROWS, chunk tid % CPR) of A
  constexpr int CPR = BK / EPC;
  constexpr int A_IT = BM * CPR / THREADS;
  constexpr int A_ROWS = THREADS / CPR;
  constexpr int CPB = BN / EPC;
  const int a_ch = tid % CPR;
  int a_off[VEC ? A_IT : 1], a_ih[VEC ? A_IT : 1], a_iw[VEC ? A_IT : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int m = m0 + tid / CPR + i * A_ROWS;
      a_off[i] = 0;
      a_ih[i] = a_iw[i] = -4;  // never in range: the row loads zeros
      if (m < g.M) {
        const int b = m / HW;
        const int r = m - b * HW;
        const int u = r / g.W;
        a_off[i] = b * HW * g.Cin + a_ch * EPC;
        a_ih[i] = u + pa - 1;
        a_iw[i] = r - u * g.W + pb - 1;
      }
    }
  }

  auto load_tile = [&](int k_tile, int stage) {
    T* as = As + stage * A_STAGE;
    T* bs = Bs + stage * B_STAGE;
    const int k0 = k_tile * BK;
    if constexpr (VEC) {
      const int tap = k0 / g.Cin, c0 = k0 - tap * g.Cin;
      const int di = tap >> 1, dj = tap & 1;
#pragma unroll
      for (int i = 0; i < A_IT; ++i) {
        const int ih = a_ih[i] + di, iw = a_iw[i] + dj;
        const bool ok = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        const T* src = ok ? x + a_off[i] + (ih * g.W + iw) * g.Cin + c0 : x;
        cp_async16(smem_u32(as + (tid / CPR + i * A_ROWS) * AP + a_ch * EPC), src, ok);
      }
      const int th = pa + 2 * di, tw = pb + 2 * dj;
      const T* wrow = w + ((size_t)(th * 4 + tw) * g.Cin + c0) * g.Cout;
#pragma unroll
      for (int c = tid; c < BK * CPB; c += THREADS) {
        const int kr = c / CPB, ch = c - kr * CPB;
        const int n = n0 + ch * EPC;
        const bool ok = n < g.Cout;
        cp_async16(smem_u32(bs + kr * BP + ch * EPC), ok ? wrow + (size_t)kr * g.Cout + n : w, ok);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kc = e - r * BK;
        const int kk = k0 + kc, m = m0 + r;
        float v = 0.f;
        if (kk < g.K && m < g.M) {
          const int tap = kk / g.Cin, ci = kk - tap * g.Cin;
          const int b = m / HW;
          const int rr = m - b * HW;
          const int u = rr / g.W;
          const int ih = u + pa - 1 + (tap >> 1), iw = rr - u * g.W + pb - 1 + (tap & 1);
          if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) v = to_f(x[(b * HW + ih * g.W + iw) * g.Cin + ci]);
        }
        as[r * AP + kc] = from_f<T>(v);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kr = e / BN, nn = e - kr * BN;
        const int kk = k0 + kr, n = n0 + nn;
        float v = 0.f;
        if (kk < g.K && n < g.Cout) {
          const int tap = kk / g.Cin, ci = kk - tap * g.Cin;
          const int th = pa + 2 * (tap >> 1), tw = pb + 2 * (tap & 1);
          v = to_f(w[((size_t)(th * 4 + tw) * g.Cin + ci) * g.Cout + n]);
        }
        bs[kr * BP + nn] = from_f<T>(v);
      }
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
      const int b = m / HW;
      const int r = m - b * HW;
      const int u = r / g.W;
      const int v = r - u * g.W;
      const size_t orow = ((size_t)b * 2 * g.H + 2 * u + pa) * (2 * g.W) + 2 * v + pb;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq + e;
          if (n >= g.Cout) continue;
          const float s = acc[mi][ni][2 * h + e];
          if (g.splitk == 1)
            y[orow * g.Cout + n] = from_f<O>(activate(s + (bias ? bias[n] : 0.f), g.act));
          else
            part[((size_t)split * g.Mtot + orow) * g.Cout + n] = s;
        }
    }
}

// Sum the K splits in a fixed order, add the bias, activate, round to the
// output type. Element indices fit in int: the wrappers refuse tensors of
// 2^31 elements or more.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                                     T* __restrict__ y, int splitk, int total, int C, int act) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splitk; ++z) s += part[(size_t)z * total + i];
    y[i] = from_f<T>(activate(s + (bias ? bias[i % C] : 0.f), act));
  }
}

// Block (64 input columns, TR = 2 RP input rows, one image); 4 warps: warp
// w takes the row pair w % RP and every KS-th channel from w / RP, KS = 4 /
// RP. A thread owns the 2 x 2 input positions (rows 2 (w % RP), + 1;
// columns 2 lane, + 1): per channel 8 LDS.64 of x and 4 NC LDS.128 of the
// channel's 16 NC weights (broadcast) feed 64 NC FMAs, so the FMA pipe, not
// shared memory, sets the pace.
template <typename T, int NC>
__global__ void __launch_bounds__(NTHREADS)
narrow_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
              T* __restrict__ y, PhaseGeom g, int tr) {
  constexpr int NW = 16 * NC;  // a channel's weights: tap (th * 4 + tw) major, then n
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int plane = narrow_plane(tr);
  float* xs = reinterpret_cast<float*>(smem_raw);  // NCK planes of (tr + 2) x (NCOLS + 2)
  float* ws = xs + NCK * plane;                   // NCK x NW
  const int rp_n = tr / 2, ks_n = NTHREADS / 32 / rp_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rp = warp % rp_n, ks = warp / rp_n;
  const int col0 = blockIdx.x * NCOLS, row0 = blockIdx.y * tr, b = blockIdx.z;
  const int xr = tr + 2, xw = NCOLS + 2;

  float acc[2][2][2][2][NC];  // [row q][column p][a][b][n]
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[q][p][a][bb][n] = 0.f;

  for (int c0 = 0; c0 < g.Cin; c0 += NCK) {
    const int nc = min(NCK, g.Cin - c0);
    __syncthreads();  // the previous pass is done with the tile
    // a warp stages one pixel at a time, lane = channel: 32 consecutive
    // channels, coalesced; f32 through 4-byte cp.async (all in flight at
    // once, zero-filled outside the image), bf16 widened through registers
    for (int rr = 0; rr < xr; ++rr) {
      const int ih = row0 - 1 + rr;
      const bool row_ok = lane < nc && ih >= 0 && ih < g.H;
      const T* src_row = x + ((size_t)(b * g.H + ih) * g.W) * g.Cin + c0 + lane;
      for (int cc = warp; cc < xw; cc += NTHREADS / 32) {
        const int iw = col0 - 1 + cc;
        const bool ok = row_ok && iw >= 0 && iw < g.W;
        const T* src = ok ? src_row + (size_t)iw * g.Cin : x;
        float* dst = xs + lane * plane + rr * xw + cc;
        if constexpr (sizeof(T) == 4)
          cp_async4(smem_u32(dst), src, ok);
        else
          *dst = ok ? to_f(*src) : 0.f;
      }
    }
    for (int e = tid; e < NCK * NW; e += NTHREADS) {
      const int c = e / NW, r = e - c * NW;  // r = tap * NC + n
      const bool ok = c < nc;
      const T* src = ok ? w + ((size_t)(r / NC) * g.Cin + c0 + c) * NC + r % NC : w;
      if constexpr (sizeof(T) == 4)
        cp_async4(smem_u32(ws + e), src, ok);
      else
        ws[e] = ok ? to_f(*src) : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int c = ks; c < nc; c += ks_n) {
      // tile rows 2 rp .. 2 rp + 3 are input rows u - 1 .. u + 2, columns
      // 2 lane .. 2 lane + 3 are v - 1 .. v + 2, for the positions (u + q, v + p)
      const float* xp = xs + c * plane + 2 * rp * xw + 2 * lane;
      float xv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 lo = *reinterpret_cast<const float2*>(xp + r * xw);
        const float2 hi = *reinterpret_cast<const float2*>(xp + r * xw + 2);
        xv[r][0] = lo.x;
        xv[r][1] = lo.y;
        xv[r][2] = hi.x;
        xv[r][3] = hi.y;
      }
      float wv[NW];
#pragma unroll
      for (int k = 0; k < NW / 4; ++k) {
        const float4 f = reinterpret_cast<const float4*>(ws + c * NW)[k];
        wv[4 * k] = f.x;
        wv[4 * k + 1] = f.y;
        wv[4 * k + 2] = f.z;
        wv[4 * k + 3] = f.w;
      }
#pragma unroll
      for (int th = 0; th < 4; ++th)
#pragma unroll
        for (int tw = 0; tw < 4; ++tw) {
          // tap (th, tw) = (a + 2i, b + 2j) reads x[u + a - 1 + i, v + b - 1 + j]
          const int a = th & 1, i = th >> 1, bb = tw & 1, j = tw >> 1;
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int n = 0; n < NC; ++n)
                acc[q][p][a][bb][n] =
                    fmaf(xv[q + a + i][p + bb + j], wv[(th * 4 + tw) * NC + n], acc[q][p][a][bb][n]);
        }
    }
  }

  if (ks_n > 1) {  // add the channel groups' sums, in group order
    constexpr int NA = 2 * 2 * 2 * 2 * NC;
    float* red = xs;  // (ks_n - 1) x rp_n x 32 x NA floats, within the x tile
    float* mine = &acc[0][0][0][0][0];
    __syncthreads();
    if (ks > 0) {
      float* dst = red + (((ks - 1) * rp_n + rp) * 32 + lane) * NA;
#pragma unroll
      for (int k = 0; k < NA; ++k) dst[k] = mine[k];
    }
    __syncthreads();
    if (ks > 0) return;
    for (int k2 = 1; k2 < ks_n; ++k2) {
      const float* src = red + (((k2 - 1) * rp_n + rp) * 32 + lane) * NA;
#pragma unroll
      for (int k = 0; k < NA; ++k) mine[k] += src[k];
    }
  }

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = row0 + 2 * rp + q;
    if (u >= g.H) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int v = col0 + 2 * lane + p;
      if (v >= g.W) continue;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const size_t o = (((size_t)b * 2 * g.H + 2 * u + a) * (2 * g.W) + 2 * v + bb) * NC;
#pragma unroll
          for (int n = 0; n < NC; ++n)
            y[o + n] = from_f<T>(activate(acc[q][p][a][bb][n] + (bias ? bias[n] : 0.f), g.act));
        }
    }
  }
}

inline PhaseGeom make_geom(int B, int H, int W, int Cin, int Cout, int splitk, int per, int act) {
  PhaseGeom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.M = B * H * W;
  g.K = 4 * Cin;
  g.Mtot = B * 4 * H * W;
  g.splitk = splitk;
  g.per = per;
  g.act = act;
  return g;
}

inline int grid_for(int total) {
  const int blocks = (total + 255) / 256;
  return blocks < 132 * 16 ? (blocks ? blocks : 1) : 132 * 16;
}

// Raise a kernel's dynamic shared-memory limit to what it asks for, once
// per device (done: the caller's own bit mask of devices)
template <typename F>
int allow_smem(F* kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 32 && (done >> dev) & 1u) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T, int BM, bool VEC, typename O>
int launch_gemm_tile(const T* x, const T* w, const float* bias, O* out, float* part, const PhaseGeom& g,
                     cudaStream_t stream) {
  static unsigned done = 0;
  const size_t smem = gemm_smem_bytes<T>(BM);
  int err = allow_smem(phase_gemm_kernel<T, BM, VEC, O>, smem, done);
  if (err) return err;
  dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN, 4 * g.splitk);
  phase_gemm_kernel<T, BM, VEC, O><<<grid, gemm_threads<T, BM>(), smem, stream>>>(x, w, bias, out, part, g);
  return (int)cudaGetLastError();
}

// The phase GEMM, then (splitk > 1) the fixed-order sum of its splits, into
// y of type O (T's own, or float). bm: 64 or 128 rows per tile (128 only
// with vec). part: splitk * Mtot * Cout floats when splitk > 1, else unused.
template <typename T, typename O = T>
int launch_phase_gemm(const T* x, const T* w, const float* bias, O* y, float* part, const PhaseGeom& g,
                      int bm, int vec, cudaStream_t stream) {
  int err;
  if (vec && bm == 128)
    err = launch_gemm_tile<T, 128, true>(x, w, bias, y, part, g, stream);
  else if (vec)
    err = launch_gemm_tile<T, 64, true>(x, w, bias, y, part, g, stream);
  else
    err = launch_gemm_tile<T, 64, false>(x, w, bias, y, part, g, stream);
  if (err || g.splitk == 1) return err;
  const int total = g.Mtot * g.Cout;
  splitk_reduce_kernel<O><<<grid_for(total), 256, 0, stream>>>(part, bias, y, g.splitk, total, g.Cout, g.act);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_narrow_nc(const T* x, const T* w, const float* bias, T* y, const PhaseGeom& g, int tr,
                     cudaStream_t stream) {
  static unsigned done = 0;
  // the largest tile's bytes: one limit serves every tr
  int err = allow_smem(narrow_kernel<T, NC>, narrow_smem_bytes(8), done);
  if (err) return err;
  dim3 grid((g.W + NCOLS - 1) / NCOLS, (g.H + tr - 1) / tr, g.B);
  narrow_kernel<T, NC><<<grid, NTHREADS, narrow_smem_bytes(tr), stream>>>(x, w, bias, y, g, tr);
  return (int)cudaGetLastError();
}

// The phase-fused kernel for Cout <= 4; tr: input rows per block (2, 4 or 8).
template <typename T>
int launch_narrow(const T* x, const T* w, const float* bias, T* y, const PhaseGeom& g, int tr,
                  cudaStream_t stream) {
  if (tr != 2 && tr != 4 && tr != 8) return (int)cudaErrorInvalidValue;
  switch (g.Cout) {
    case 1: return launch_narrow_nc<T, 1>(x, w, bias, y, g, tr, stream);
    case 2: return launch_narrow_nc<T, 2>(x, w, bias, y, g, tr, stream);
    case 3: return launch_narrow_nc<T, 3>(x, w, bias, y, g, tr, stream);
    case 4: return launch_narrow_nc<T, 4>(x, w, bias, y, g, tr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace phase_gemm
}  // namespace
