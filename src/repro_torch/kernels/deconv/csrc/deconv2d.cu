// deconv2d for Hopper (sm_90a): the k4/s2 transposed convolution with the
// torch padding=1 border crop folded in, plus an optional bias. Plain C
// interface, loaded with ctypes by ../kernel.py; every entry launches on the
// caller's stream, allocates nothing (the wrapper passes the output and the
// split-K scratch) and returns cudaGetLastError().
//
// Replaces: repro/kernels/deconv/kernel.py, deconv2d_pallas (_deconv_kernel,
// _phase_matmuls), with the bias the JAX wrapper adds outside
// (repro/kernels/deconv/ops.py) moved into the epilogue.
//
// The kernels, their bound on this card and their design are in
// phase_gemm.cuh, which fused_blocks.cu's deconv_block launches too: the
// four-phase tensor-core GEMM (3xTF32 for float32, bf16 for bfloat16), and
// the phase-fused narrow kernel for Cout <= 4.

#include "phase_gemm.cuh"

namespace {

template <typename T>
int deconv2d(const void* x, const void* w, const void* bias, void* y, void* part, int B, int H, int W,
             int Cin, int Cout, int narrow, int tile_rows, int vec, int splitk, int per, void* stream_ptr) {
  const phase_gemm::PhaseGeom g =
      phase_gemm::make_geom(B, H, W, Cin, Cout, splitk, per, phase_gemm::ACT_NONE);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* b = static_cast<const float*>(bias);
  if (narrow) return phase_gemm::launch_narrow<T>(xt, wt, b, static_cast<T*>(y), g, tile_rows, stream);
  return phase_gemm::launch_phase_gemm<T>(xt, wt, b, static_cast<T*>(y), static_cast<float*>(part), g,
                                          tile_rows, vec, stream);
}

}  // namespace

extern "C" {

const char* deconv2d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one launch, in bytes: the phase GEMM with
// tile_rows rows per tile for esize-byte operands, or (narrow) the narrow
// kernel with tile_rows input rows per block.
long long deconv2d_smem_bytes(int esize, int narrow, int tile_rows) {
  if (narrow) return (long long)phase_gemm::narrow_smem_bytes(tile_rows);
  return (long long)(esize == 4 ? phase_gemm::gemm_smem_bytes<float>(tile_rows)
                                : phase_gemm::gemm_smem_bytes<__nv_bfloat16>(tile_rows));
}

// x (B,H,W,Cin), w (4,4,Cin,Cout), bias (Cout) float32 or null -> y (B,2H,2W,Cout).
// narrow: the phase-fused kernel (Cout <= 4), tile_rows input rows per block;
// else the phase GEMM, tile_rows (64 or 128) rows per tile, vec: 16-byte
// staging; splitk splits of per live K tiles each. part: splitk * B*2H*2W*Cout
// floats when splitk > 1, else unused.
int deconv2d_f32(const void* x, const void* w, const void* bias, void* y, void* part, int B, int H, int W,
                 int Cin, int Cout, int narrow, int tile_rows, int vec, int splitk, int per, void* stream) {
  return deconv2d<float>(x, w, bias, y, part, B, H, W, Cin, Cout, narrow, tile_rows, vec, splitk, per,
                         stream);
}

int deconv2d_bf16(const void* x, const void* w, const void* bias, void* y, void* part, int B, int H,
                  int W, int Cin, int Cout, int narrow, int tile_rows, int vec, int splitk, int per,
                  void* stream) {
  return deconv2d<__nv_bfloat16>(x, w, bias, y, part, B, H, W, Cin, Cout, narrow, tile_rows, vec, splitk,
                                 per, stream);
}

}  // extern "C"
