"""Build and bind the hand-written CUDA kernel in ``csrc/ssd.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

``ssd_cuda`` takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates y (and the final state, when asked) with
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

_SRC = Path(__file__).parent / "csrc" / "ssd.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_ENTRY = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
STATE_DIMS = (16, 32, 64, 128)  # the state widths n the source instantiates
P_TILE = 16  # head channels per block: p must be a multiple


def build() -> dict:
    """Compile the kernel if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 7 + [i] * 6 + [p]
        getattr(lib, name).restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(x, dt, A, B, C):
    """Raise on what the kernel does not take: x (b, s, h, p), dt (b, s, h),
    A (h,), B and C (b, s, g, n) with h % g == 0, p a multiple of
    ``P_TILE``, n one of ``STATE_DIMS``, s > 0."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(
            f"want x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}"
        )
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(B.shape[:2]) != (b, s) or h % g:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)} disagree")
    if min(b, s, h, p) == 0:
        raise ValueError("empty scan")
    if p % P_TILE or n not in STATE_DIMS:
        raise ValueError(f"the kernel takes p a multiple of {P_TILE} and n in {STATE_DIMS}; got p {p}, n {n}")


def ssd_cuda(x, dt, A, B, C, return_state: bool = False):
    """Launch the scan: x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n)
    of one dtype (float32 or bfloat16), A float32 (h,) -> y (b, s, h, p) in
    x's dtype, and with ``return_state`` the final state (b, h, p, n)
    float32."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"ssd takes float32 or bfloat16, got {x.dtype}")
    check_shapes(x, dt, A, B, C)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    for t, name in ((x, "x"), (dt, "dt"), (B, "B"), (C, "C")):
        require(t, name, x.dtype)
    require(A, "A", torch.float32)
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be on one device")
    if max(x.numel(), B.numel()) >= 2**31:
        raise ValueError("the kernel indexes rows with 32-bit ints: tensors must hold < 2^31 elements")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device) if return_state else None
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(), b, s, h, p, g, n,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd launch failed: {lib.ssd_error_string(err).decode()} ({err})")
    return (y, state) if return_state else y
