"""Build and bind the hand-written CUDA kernel in ``csrc/deconv2d.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

``deconv2d_cuda`` takes CUDA tensors only: it checks device, dtype, shape
and contiguity, allocates the output and the split-K scratch with
``torch.empty``, launches on the current stream and raises if the launch
failed. Dispatch between the kernel and its plain version is ``ops.py``'s
job.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .._build import require
from ..fused.kernel import gemm_split

_SRC = Path(__file__).parent / "csrc" / "deconv2d.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_ENTRY = {torch.float32: "deconv2d_f32", torch.bfloat16: "deconv2d_bf16"}
# (BM, BN) output tile of one phase: 64 x 64, or 256 x 4 for Cout <= 4
_WIDE, _NARROW = (64, 64), (256, 4)


def build() -> dict:
    """Compile the kernel if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 5 + [i] * 8 + [p]
        getattr(lib, name).restype = i
    lib.deconv2d_error_string.argtypes = [i]
    lib.deconv2d_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(B: int, H: int, W: int, cin: int, cout: int) -> tuple[bool, int, int]:
    """``(narrow, splitk, k_tiles_per_split)``: the N tile follows Cout, and
    layers with too few output tiles to fill the card split K = 4*Cin."""
    narrow = cout <= _NARROW[1]
    bm, bn = _NARROW if narrow else _WIDE
    splitk, per = gemm_split(B * H * W, cout, 4 * cin, phases=4, bm=bm, bn=bn)
    return narrow, splitk, per


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
    narrow, splitk, per = launch_geometry(B, H, W, Cin, Cout)
    out_elems = B * 4 * H * W * Cout
    if max(x.numel(), w.numel(), splitk * out_elems) >= 2**31:
        raise ValueError("the kernel indexes with 32-bit ints: tensors must hold < 2^31 elements")
    y = torch.empty((B, 2 * H, 2 * W, Cout), dtype=x.dtype, device=x.device)
    part = torch.empty((splitk, out_elems), dtype=torch.float32, device=x.device) if splitk > 1 else None
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), B, H, W, Cin, Cout, int(narrow), splitk,
            per, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"deconv2d launch failed: {lib.deconv2d_error_string(err).decode()} ({err})")
    return y
