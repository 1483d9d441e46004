"""Build and bind the hand-written CUDA kernels in ``csrc/fused_blocks.cu``
(its deconv_block launches ``deconv/csrc/phase_gemm.cuh``'s kernels, with
the launch ``deconv.kernel.phase_geometry`` chooses; its conv GEMM shares
their K loop, ``gemm_k_loop``, and tiles, with the launch ``conv_geometry``
chooses).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate outputs and scratch with ``torch.empty``, launch on
the current stream and raise if the launch failed. Dispatch between the
kernels and their plain versions is ``ops.py``'s job.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path

import torch

from .. import _build
from .._build import require
from ..deconv.kernel import PHASE_BN, gemm_plan, phase_bk, phase_geometry

_SRC = Path(__file__).parent / "csrc" / "fused_blocks.cu"
_BUILD_DIR = Path(__file__).parent / "build"

NORMS = {"none": 0, "batch": 1, "instance": 2, "group": 3}
ACTS = {"none": 0, "relu": 1, "lrelu": 2, "silu": 3, "tanh": 4}

_ENTRY = {torch.float32: "fused_conv_block_f32", torch.bfloat16: "fused_conv_block_bf16"}
_SMS = 132  # streaming multiprocessors of an H100 SXM
# blocks wanted in flight: two per SM
_TARGET_BLOCKS = 2 * _SMS
_SPPF_SMEM = 48 * 1024
# taps the conv GEMM's block vote covers (one bit each of an unsigned)
VOTE_TAPS = 32


def build() -> dict:
    """Compile the kernels if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


def built() -> bool:
    """Whether this source's library is already built (so ``library()``
    only loads it)."""
    return _build.library_path(_SRC, _BUILD_DIR).exists()


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 9 + [i] * 12 + [f] + [i] * 6 + [p]
        getattr(lib, name).restype = i
    for name in ("sppf_pyramid_f32", "sppf_pyramid_bf16"):
        getattr(lib, name).argtypes = [p, p] + [i] * 8 + [p]
        getattr(lib, name).restype = i
    lib.fused_error_string.argtypes = [i]
    lib.fused_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.fused_error_string(err).decode()} ({err})")


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One launch of the conv GEMM: ``tile_rows`` (64 or 128) GEMM rows per
    tile; ``vec``: A and B staged with 16-byte copies (Cin and Cout hold
    whole 16-byte chunks); ``splitk`` splits of ``per`` live K tiles each."""

    tile_rows: int
    vec: bool
    splitk: int
    per: int


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def live_taps_1d(n_in: int, n_out: int, k: int, stride: int, pad: int) -> set[int]:
    """The kernel offsets along one axis that reach a real input for some
    output: output o reads input o*stride - pad + t through offset t."""
    return {t for t in range(k) if any(0 <= o * stride - pad + t < n_in for o in range(n_out))}


def conv_live_k_tiles(H: int, W: int, cin: int, k: int, stride: int, pad: int, bk: int) -> int:
    """The ``bk``-deep K tiles (tap-major: tap di*k + dj, then channel) that
    hold a tap reaching an input for some output: the bound on a block's
    live tiles. The block's vote keeps a bit a tap, so past ``VOTE_TAPS``
    taps the kernel walks every K tile, and so does this count."""
    K = k * k * cin
    if k * k > VOTE_TAPS:
        return math.ceil(K / bk)
    rows = live_taps_1d(H, conv_out(H, k, stride, pad), k, stride, pad)
    cols = live_taps_1d(W, conv_out(W, k, stride, pad), k, stride, pad)
    return sum(
        1 for kt in range(math.ceil(K / bk))
        if any(t // k in rows and t % k in cols for t in range(kt * bk // cin, (min(kt * bk + bk, K) - 1) // cin + 1))
    )


@functools.cache
def conv_geometry(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int, pad: int, esize: int = 4,
                  aligned: bool = True) -> ConvGeometry:
    """The conv GEMM's launch for a (B, H, W, cin) -> cout conv with
    ``esize``-byte operands: ``gemm_plan``'s tiles and K split over M =
    B*Ho*Wo rows and the live K tiles. ``aligned``: x and w start on a
    16-byte boundary (a condition of the 16-byte staging)."""
    epc = 16 // esize
    vec = aligned and cin % epc == 0 and cout % epc == 0
    M = B * conv_out(H, k, stride, pad) * conv_out(W, k, stride, pad)
    nkt = conv_live_k_tiles(H, W, cin, k, stride, pad, phase_bk(esize))
    bm, splitk, per = gemm_plan(M, math.ceil(cout / PHASE_BN), nkt, vec, esize)
    return ConvGeometry(bm, vec, splitk, per)


def stats_chunks(rows: int, cout: int, sets: int) -> int:
    """Row chunks per stats set, so the statistics pass has about
    ``_TARGET_BLOCKS`` blocks of 32 channels x 8 rows."""
    want = math.ceil(_TARGET_BLOCKS / (sets * math.ceil(cout / 32)))
    chunks = max(1, min(want, math.ceil(rows / 8)))
    per = math.ceil(rows / chunks)
    return math.ceil(rows / per)


def conv_block_cuda(x, w, b, gamma, beta, *, stride, padding, norm, groups, act, eps, deconv):
    """Launch the fused conv (``deconv=False``) or k4/s2 crop-1 deconv
    (``deconv=True``) + bias + norm + act kernel: x (B, H, W, Cin) and w
    (k, k, Cin, Cout) CUDA tensors of one dtype, float32 or bfloat16; b,
    gamma and beta float32 (Cout,) -> y in x's dtype. With a norm the
    statistics are taken over the GEMM's fp32 output: y itself for float32,
    a float32 scratch tensor for bfloat16."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"{'deconv_block' if deconv else 'conv_block'} takes float32 or bfloat16, got {x.dtype}")
    B, H, W, Cin = x.shape
    k, Cout = w.shape[0], w.shape[-1]
    require(x, "x", x.dtype)
    require(w, "w", x.dtype, (k, k, Cin, Cout))
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        require(t, name, torch.float32, (Cout,))
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    f32 = x.dtype == torch.float32
    esize, aligned = x.element_size(), x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if deconv:
        if k != 4:
            raise ValueError(f"deconv_block is the k=4 stride-2 crop-1 deconv; got k={k}")
        Ho, Wo = 2 * H, 2 * W
        # the narrow kernel writes x's dtype: a bf16 norm needs the GEMM's fp32 output
        geo = phase_geometry(B, H, W, Cin, Cout, esize, aligned, narrow_ok=f32 or norm == "none")
        narrow, tile_rows, vec, splitk, per = geo.narrow, geo.tile_rows, geo.vec, geo.splitk, geo.per
    else:
        Ho, Wo = conv_out(H, k, stride, padding), conv_out(W, k, stride, padding)
        if Ho < 1 or Wo < 1:
            raise ValueError(f"empty output for input {tuple(x.shape)}, k={k}, stride={stride}")
        geo = conv_geometry(B, H, W, Cin, Cout, k, stride, padding, esize, aligned)
        narrow, tile_rows, vec, splitk, per = False, geo.tile_rows, geo.vec, geo.splitk, geo.per
    out_elems = B * Ho * Wo * Cout
    if max(x.numel(), w.numel(), splitk * out_elems) >= 2**31:
        raise ValueError("the kernel indexes with 32-bit ints: tensors must hold < 2^31 elements")
    G = groups if norm == "group" else Cout
    if Cout % G:
        raise ValueError(f"groups {G} must divide Cout {Cout}")
    y = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    part = torch.empty((splitk, out_elems), dtype=torch.float32, device=x.device) if splitk > 1 else None
    pre = None
    if norm != "none":
        pre = y if f32 else torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    sets = 1 if norm == "batch" else B
    rows = B * Ho * Wo if norm == "batch" else Ho * Wo
    chunks = stats_chunks(rows, Cout, sets)
    stats = (
        torch.empty(3 * sets * chunks * Cout + 2 * sets * G, dtype=torch.float32, device=x.device)
        if norm != "none"
        else None
    )
    lib = library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            ptr(pre), ptr(part), ptr(stats), B, H, W, Cin, Cout, k, stride, padding, int(deconv), NORMS[norm], G,
            ACTS[act], float(eps), splitk, per, chunks, int(narrow), tile_rows, int(vec),
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "deconv_block" if deconv else "conv_block")
    return y


_SPPF_ENTRY = {torch.float32: "sppf_pyramid_f32", torch.bfloat16: "sppf_pyramid_bf16"}


@functools.cache
def sppf_geometry(B: int, H: int, W: int, C: int, window: int = 5, reps: int = 3) -> tuple[int, int]:
    """``(ct, rb)``: channels and output rows per block of the SPPF kernel.
    A block holds its rb rows and a halo of ``reps * (window // 2)`` rows on
    each side (clipped to the map) in two fp32 planes of shared memory.
    Lanes run along C, so a wider tile coalesces better: the widest ct of
    32, 16, ..., 1 (at most C), then the tallest rb, whose grid reaches one
    block per SM and whose planes fit the default 48 KB; where no tile
    reaches that many blocks, the fitting tile that makes the most. Cached:
    it runs on every launch."""
    halo = reps * (window // 2)
    fitting = []
    for ct in (32, 16, 8, 4, 2, 1):
        if ct > C and ct > 1:
            continue
        for rb in range(H, 0, -1):
            if sppf_smem_bytes(H, W, ct, rb, halo) > _SPPF_SMEM:
                continue
            blocks = B * -(-C // ct) * -(-H // rb)
            if blocks >= _SMS:
                return ct, rb
            fitting.append((blocks, ct, rb))
    if not fitting:
        raise ValueError(f"an {H}x{W} SPPF row with its halo does not fit {_SPPF_SMEM} bytes of shared memory")
    return max(fitting)[1:]


def sppf_smem_bytes(H: int, W: int, ct: int, rb: int, halo: int) -> int:
    """Shared memory of an SPPF block: two fp32 planes of its rows and halo."""
    return 2 * min(H, rb + 2 * halo) * W * ct * 4


def sppf_pyramid_cuda(x, *, window, reps):
    """Launch the SPPF pool-pyramid kernel on a float32/bfloat16 CUDA tensor."""
    if x.dtype not in _SPPF_ENTRY:
        raise TypeError(f"sppf_pyramid takes float32 or bfloat16, got {x.dtype}")
    require(x, "x", x.dtype)
    B, H, W, C = x.shape
    ct, rb = sppf_geometry(B, H, W, C, window, reps)
    out = torch.empty((B, H, W, (reps + 1) * C), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _SPPF_ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, H, W, C, ct, rb, window, reps,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "sppf_pyramid")
    return out
