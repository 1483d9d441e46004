"""Build and bind the hand-written CUDA kernels in ``csrc/deconv2d.cu`` (the
phase GEMM and the narrow kernel of ``csrc/phase_gemm.cuh``, which the fused
``deconv_block`` launches too).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

``deconv2d_cuda`` takes CUDA tensors only: it checks device, dtype, shape
and contiguity, allocates the output and the split-K scratch with
``torch.empty``, launches on the current stream and raises if the launch
failed. Dispatch between the kernel and its plain version is ``ops.py``'s
job. ``phase_geometry`` chooses the launch for both kernels.
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

_SRC = Path(__file__).parent / "csrc" / "deconv2d.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_ENTRY = {torch.float32: "deconv2d_f32", torch.bfloat16: "deconv2d_bf16"}

# csrc/phase_gemm.cuh: a GEMM tile is 64 or 128 rows x PHASE_BN output
# channels of one phase, K tiles of 128 bytes (``phase_bk``); Cout <= NARROW_COUT takes the
# narrow kernel, whose block covers NARROW_COLS input columns x 2, 4 or 8
# input rows with NARROW_WARPS warps, each thread 2 x 2 input positions
PHASE_BN = 64
NARROW_COUT, NARROW_COLS, NARROW_WARPS = 4, 64, 4
# blocks wanted in flight: two per SM of an H100
_SMS = 132
_TARGET_BLOCKS = 2 * _SMS
# GEMM rows per phase below which a layer is bound by its weight bytes
_WEIGHT_BOUND_ROWS = 512


@dataclasses.dataclass(frozen=True)
class PhaseGeometry:
    """One launch of the phase GEMM or, when ``narrow``, the narrow kernel.

    ``tile_rows``: GEMM rows per tile (64 or 128), or the narrow kernel's
    input rows per block (2, 4 or 8: a warp takes 2 rows, and the warps
    split the channels ``NARROW_WARPS // (tile_rows // 2)`` ways). ``vec``: K tiles staged with
    16-byte copies (32 channels of one tap). ``splitk`` splits of ``per``
    live K tiles each: a block takes its split's share of the K tiles whose
    taps reach an input for some row of its tile."""

    narrow: bool
    tile_rows: int
    vec: bool = False
    splitk: int = 1
    per: int = 0


def phase_bk(esize: int) -> int:
    """K per GEMM tile: 128 bytes of an input pixel, 32 f32 or 64 bf16 channels."""
    return 128 // esize


def live_k_tiles(H: int, W: int, cin: int, bk: int) -> int:
    """The most ``bk``-deep K tiles any phase has whose taps reach an input
    for some output row: the bound on a block's live tiles. Every tap of
    every phase is live once H, W >= 2; at 1 x 1 one tap of each phase is."""
    k = 4 * cin
    most = 0
    for pa in (0, 1):
        for pb in (0, 1):
            taps = {2 * di + dj for di in (0, 1) for dj in (0, 1)
                    if max(0, 1 - pa - di) <= min(H - 1, H - pa - di)
                    and max(0, 1 - pb - dj) <= min(W - 1, W - pb - dj)}
            tiles = sum(1 for kt in range(math.ceil(k / bk))
                        if any(t in taps for t in range(kt * bk // cin, (min(kt * bk + bk, k) - 1) // cin + 1)))
            most = max(most, tiles)
    return most


def gemm_plan(M: int, n_tiles: int, nkt: int, vec: bool, esize: int) -> tuple[int, int, int]:
    """``(tile_rows, splitk, per)`` of a tensor-core implicit GEMM (the phase
    GEMM, and the conv GEMM of ``fused_blocks.cu``, which shares its tiles)
    with M rows, ``n_tiles`` column tiles (and phases) and ``nkt`` live K
    tiles: 128-row tiles where they give two blocks per SM, or for f32
    (whose 128-row tile has 64 x 32 warp tiles: more MMAs per split
    fragment) half a block per SM; K split where the tiles do not fill the
    SMs, never beyond the blocks that shared memory lets the SMs hold at
    once (four 64-row or two 128-row tiles each: a second wave would cost a
    whole tile's time): GEMMs of fewer than ``_WEIGHT_BOUND_ROWS`` rows (the
    deep layers, bound by their weight bytes) up to that limit, the others
    until about two blocks per SM; each split at least 2 live K tiles
    deep."""
    enough = _SMS // 2 if esize == 4 else _TARGET_BLOCKS
    bm = 128 if vec and math.ceil(M / 128) * n_tiles >= enough else 64
    tiles = math.ceil(M / bm) * n_tiles
    resident = (4 if bm == 64 else 2) * _SMS
    split = 1
    if tiles < _SMS:
        split = resident // tiles
        if M >= _WEIGHT_BOUND_ROWS:
            split = min(split, math.ceil(_TARGET_BLOCKS / tiles))
        split = max(1, min(split, nkt // 2))
    per = math.ceil(nkt / split)
    return bm, math.ceil(nkt / per), per


@functools.cache
def phase_geometry(B: int, H: int, W: int, cin: int, cout: int, esize: int = 4,
                   aligned: bool = True, narrow_ok: bool = True) -> PhaseGeometry:
    """The launch for a (B, H, W, cin) -> cout deconv with ``esize``-byte
    operands. The narrow kernel (Cout <= ``NARROW_COUT``, when
    ``narrow_ok``) takes the rows per block that still give two blocks per
    SM. The GEMM's tiles and K split are ``gemm_plan``'s over the four
    phases' rows per phase. ``aligned``: x and w start on a 16-byte
    boundary (a condition of the 16-byte staging)."""
    if cout <= NARROW_COUT and narrow_ok:
        for rows in (8, 4):
            if B * math.ceil(H / rows) * math.ceil(W / NARROW_COLS) >= _TARGET_BLOCKS:
                return PhaseGeometry(True, rows)
        return PhaseGeometry(True, 2)
    bk = phase_bk(esize)
    vec = aligned and cin % bk == 0 and (cout * esize) % 16 == 0
    bm, splitk, per = gemm_plan(B * H * W, 4 * math.ceil(cout / PHASE_BN), live_k_tiles(H, W, cin, bk), vec, esize)
    return PhaseGeometry(False, bm, vec, splitk, per)


def build() -> dict:
    """Compile the kernel if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 5 + [i] * 10 + [p]
        getattr(lib, name).restype = i
    lib.deconv2d_error_string.argtypes = [i]
    lib.deconv2d_error_string.restype = ctypes.c_char_p
    lib.deconv2d_smem_bytes.argtypes = [i, i, i]
    lib.deconv2d_smem_bytes.restype = ctypes.c_longlong
    return lib


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def deconv2d_cuda(x, w, b=None):
    """Launch the k4/s2 crop-1 deconv (+bias) kernel: x (B, H, W, Cin) and
    w (4, 4, Cin, Cout) float32 or bfloat16 of one dtype, b float32 (Cout,)
    or None -> (B, 2H, 2W, Cout) in x's dtype."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"deconv2d takes float32 or bfloat16, got {x.dtype}")
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    require(x, "x", x.dtype)
    require(w, "w", x.dtype, (4, 4, Cin, Cout))
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if b is not None:
        require(b, "b", torch.float32, (Cout,))
        if b.device != x.device:
            raise ValueError(f"b is on {b.device}, x on {x.device}")
    geo = phase_geometry(B, H, W, Cin, Cout, x.element_size(), _aligned(x, w))
    out_elems = B * 4 * H * W * Cout
    if max(x.numel(), w.numel(), geo.splitk * out_elems) >= 2**31:
        raise ValueError("the kernel indexes with 32-bit ints: tensors must hold < 2^31 elements")
    y = torch.empty((B, 2 * H, 2 * W, Cout), dtype=x.dtype, device=x.device)
    part = (torch.empty((geo.splitk, out_elems), dtype=torch.float32, device=x.device)
            if geo.splitk > 1 else None)
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), B, H, W, Cin, Cout, int(geo.narrow), geo.tile_rows,
            int(geo.vec), geo.splitk, geo.per, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"deconv2d launch failed: {lib.deconv2d_error_string(err).decode()} ({err})")
    return y
