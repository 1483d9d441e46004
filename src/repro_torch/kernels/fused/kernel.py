"""Build and bind the hand-written CUDA kernels in ``csrc/fused_blocks.cu``
(its deconv_block launches ``deconv/csrc/phase_gemm.cuh``'s kernels, with
the launch ``deconv.kernel.phase_geometry`` chooses).

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
import functools
import math
from pathlib import Path

import torch

from .. import _build
from .._build import require
from ..deconv.kernel import phase_geometry

_SRC = Path(__file__).parent / "csrc" / "fused_blocks.cu"
_BUILD_DIR = Path(__file__).parent / "build"

NORMS = {"none": 0, "batch": 1, "instance": 2, "group": 3}
ACTS = {"none": 0, "relu": 1, "lrelu": 2, "silu": 3, "tanh": 4}

# GEMM tile of the conv kernel (BM x BN output tile, BK deep K tile)
_BM, _BN, _BK = 64, 64, 16
# blocks wanted in flight: two per SM of an H100
_TARGET_BLOCKS = 2 * 132
_SPPF_SMEM = 48 * 1024


def build() -> dict:
    """Compile the kernels if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_conv_block_f32.argtypes = [p] * 8 + [i] * 12 + [f] + [i] * 6 + [p]
    lib.fused_conv_block_f32.restype = i
    for name in ("sppf_pyramid_f32", "sppf_pyramid_bf16"):
        getattr(lib, name).argtypes = [p, p] + [i] * 7 + [p]
        getattr(lib, name).restype = i
    lib.fused_error_string.argtypes = [i]
    lib.fused_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.fused_error_string(err).decode()} ({err})")


def gemm_split(rows: int, cout: int, k_total: int) -> tuple[int, int]:
    """``(splitk, k_tiles_per_split)`` for the conv GEMM's ``_BM x _BN``
    output tiles and ``_BK``-deep K tiles: layers with too few output tiles
    to fill the card (the deep 1x1/2x2 Pix2Pix layers) split K over more
    blocks, each split at least 8 K tiles deep."""
    tiles = math.ceil(rows / _BM) * math.ceil(cout / _BN)
    nkt = math.ceil(k_total / _BK)
    split = 1
    if tiles < _TARGET_BLOCKS:
        split = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), nkt // 8))
    per = math.ceil(nkt / split)
    return math.ceil(nkt / per), per


def stats_chunks(rows: int, cout: int, sets: int) -> int:
    """Row chunks per stats set, so the statistics pass has about
    ``_TARGET_BLOCKS`` blocks of 32 channels x 8 rows."""
    want = math.ceil(_TARGET_BLOCKS / (sets * math.ceil(cout / 32)))
    chunks = max(1, min(want, math.ceil(rows / 8)))
    per = math.ceil(rows / chunks)
    return math.ceil(rows / per)


def conv_block_cuda(x, w, b, gamma, beta, *, stride, padding, norm, groups, act, eps, deconv):
    """Launch the fused conv (``deconv=False``) or k4/s2 crop-1 deconv
    (``deconv=True``) + bias + norm + act kernel on float32 CUDA tensors."""
    B, H, W, Cin = x.shape
    k, Cout = w.shape[0], w.shape[-1]
    require(x, "x", torch.float32)
    require(w, "w", torch.float32, (k, k, Cin, Cout))
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        require(t, name, torch.float32, (Cout,))
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if deconv:
        if k != 4:
            raise ValueError(f"deconv_block is the k=4 stride-2 crop-1 deconv; got k={k}")
        Ho, Wo = 2 * H, 2 * W
        geo = phase_geometry(B, H, W, Cin, Cout, 4, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        narrow, tile_rows, vec, splitk, per = geo.narrow, geo.tile_rows, geo.vec, geo.splitk, geo.per
    else:
        Ho = (H + 2 * padding - k) // stride + 1
        Wo = (W + 2 * padding - k) // stride + 1
        narrow, tile_rows, vec = False, 0, False
        splitk, per = gemm_split(B * Ho * Wo, Cout, k * k * Cin)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"empty output for input {tuple(x.shape)}, k={k}, stride={stride}")
    if max(x.numel(), B * Ho * Wo * Cout) >= 2**31:
        raise ValueError("the kernel indexes with 32-bit ints: tensors must hold < 2^31 elements")
    G = groups if norm == "group" else Cout
    if Cout % G:
        raise ValueError(f"groups {G} must divide Cout {Cout}")
    y = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    part = (
        torch.empty((splitk, B * Ho * Wo * Cout), dtype=torch.float32, device=x.device)
        if splitk > 1
        else None
    )
    sets = 1 if norm == "batch" else B
    rows = B * Ho * Wo if norm == "batch" else Ho * Wo
    chunks = stats_chunks(rows, Cout, sets)
    stats = (
        torch.empty(3 * sets * chunks * Cout + 2 * sets * G, dtype=torch.float32, device=x.device)
        if norm != "none"
        else None
    )
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.fused_conv_block_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(),
            None if stats is None else stats.data_ptr(),
            B, H, W, Cin, Cout, k, stride, padding, int(deconv), NORMS[norm], G, ACTS[act],
            float(eps), splitk, per, chunks, int(narrow), tile_rows, int(vec),
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "deconv_block" if deconv else "conv_block")
    return y


_SPPF_ENTRY = {torch.float32: "sppf_pyramid_f32", torch.bfloat16: "sppf_pyramid_bf16"}


def sppf_channel_tile(H: int, W: int, C: int) -> int:
    """Channels per block: the widest of 32/16/.../1 whose two H x W tiles
    fit the default 48 KB of shared memory."""
    for ct in (32, 16, 8, 4, 2, 1):
        if 2 * H * W * ct * 4 <= _SPPF_SMEM:
            return min(ct, C)
    raise ValueError(f"an {H}x{W} SPPF tile does not fit {_SPPF_SMEM} bytes of shared memory")


def sppf_pyramid_cuda(x, *, window, reps):
    """Launch the SPPF pool-pyramid kernel on a float32/bfloat16 CUDA tensor."""
    if x.dtype not in _SPPF_ENTRY:
        raise TypeError(f"sppf_pyramid takes float32 or bfloat16, got {x.dtype}")
    require(x, "x", x.dtype)
    B, H, W, C = x.shape
    ct = sppf_channel_tile(H, W, C)
    out = torch.empty((B, H, W, (reps + 1) * C), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _SPPF_ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, H, W, C, ct, window, reps,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "sppf_pyramid")
    return out
