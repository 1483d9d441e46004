"""Build and bind the hand-written CUDA kernel in ``csrc/ssd.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

``ssd_cuda`` takes CUDA tensors only: it checks device, dtype, shape and
layout (x, B and C may be row-strided, see ``row_strided``), allocates y
(and the final state, when asked) and the pipeline's fp32 scratch
(``scratch_shapes``) with ``torch.empty``, launches its four passes on the
current stream and raises if a launch failed.
Dispatch between the kernel and its plain version is ``ops.py``'s job.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build
from .._build import aligned16, require

_SRC = Path(__file__).parent / "csrc" / "ssd.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_ENTRY = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
STATE_DIMS = (16, 32, 64, 128)  # the state widths n the source instantiates
P_TILE = 16  # the MMA tile along p: p must be a multiple
CHUNK = 64  # steps per chunk of the kernels (T in csrc/ssd.cu)


def build() -> dict:
    """Compile the kernel if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 10 + [i] * 9 + [p]
        getattr(lib, name).restype = i
    lib.ssd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
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


def scratch_shapes(b: int, s: int, h: int, p: int, g: int, n: int) -> dict:
    """The fp32 scratch of one call: C.B^T per (row, chunk, group), the
    chunk states (overwritten with the state entering each chunk) and the
    chunk decays."""
    nc = math.ceil(s / CHUNK)
    return {"cb": (b, nc, g, CHUNK, CHUNK), "states": (b, h, nc, p, n), "decay": (b, h, nc)}


def row_strided(t):
    """``(t, ld)``: ``t`` (b, s, ...) as the kernels read it, its (b, s)
    rows ``ld`` elements apart and the rest of each row contiguous, from a
    16-byte boundary, ld a whole number of 16-byte chunks (Mamba2Block's
    slices of its conv output are such views); or a contiguous, aligned
    copy of ``t`` when it is not laid out so."""
    b, s = t.shape[:2]
    inner = math.prod(t.shape[2:])
    st = t.stride()
    ld = st[1] if s > 1 else (st[0] if b > 1 else inner)
    ok = (
        all(st[i] == math.prod(t.shape[i + 1:]) for i in range(2, t.dim()))
        and (b == 1 or s == 1 or st[0] == s * ld)
        and ld >= inner and (ld * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0
    )
    return (t, ld) if ok else (aligned16(t.contiguous()), inner)


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
    for t, name in ((x, "x"), (B, "B"), (C, "C")):
        if t.device.type != "cuda" or t.dtype != x.dtype:
            raise ValueError(f"{name} must be a CUDA tensor of {x.dtype}, got {t.dtype} on {t.device}")
    require(dt, "dt", x.dtype)
    require(A, "A", torch.float32)
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be on one device")
    shapes = scratch_shapes(b, s, h, p, g, n)
    if max(x.numel(), B.numel(), *(math.prod(v) for v in shapes.values())) >= 2**31:
        raise ValueError("the kernels index rows with 32-bit ints: tensors must hold < 2^31 elements")
    (x, ldx), (B, ldb), (C, ldc) = row_strided(x), row_strided(B), row_strided(C)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device) if return_state else None
    scratch = {k: torch.empty(v, dtype=torch.float32, device=x.device) for k, v in shapes.items()}
    lib = library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(), scratch["cb"].data_ptr(),
            scratch["states"].data_ptr(), scratch["decay"].data_ptr(), b, s, h, p, g, n, ldx, ldb, ldc,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd launch failed: {lib.ssd_error_string(err).decode()} ({err})")
    return (y, state) if return_state else y
