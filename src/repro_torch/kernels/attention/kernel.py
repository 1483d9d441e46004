"""Build and bind the hand-written CUDA kernel in ``csrc/flash_attention.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build()``, through
``kernels._build``), under ``build/`` next to this file, and loaded with
``ctypes``.

``flash_attention_cuda`` takes CUDA tensors only: it checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``, launches
on the current stream and raises if the launch failed. float32 launches the
3xTF32 tensor-core kernel (``flash_kernel_tf32``), bfloat16 the bf16
tensor-core kernel (``flash_kernel_tc``). Both copy 16-byte chunks: a
tensor whose data does not start on a 16-byte boundary (a view at an odd
offset) is copied first. Dispatch between the kernel and its plain version
is ``ops.py``'s job.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build
from .._build import aligned16, require

_SRC = Path(__file__).parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the source instantiates


def build() -> dict:
    """Compile the kernel if this source has not been built yet (see
    ``kernels._build.build``)."""
    return _build.build(_SRC, _BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load(_SRC, _BUILD_DIR)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [p] * 4 + [i] * 8 + [f, f, p]
        getattr(lib, name).restype = i
    for name in ("flash_attention_f32_smem_bytes", "flash_attention_bf16_smem_bytes"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(q, k, v, causal: bool, window: int):
    """Raise on what the kernel does not take: q (B, Sq, Hq, D), k and v
    (B, Sk, Hk, D) with Hq % Hk == 0, D one of ``HEAD_DIMS``, no empty
    axis, and no query row that would see no key (Sq > Sk under a causal
    or window mask)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,Hq,D), k/v (B,Sk,Hk,D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head_dim, or Hq % Hk != 0")
    if min(B, Sq, Sk, Hq) == 0:
        raise ValueError("empty attention")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if Sq > Sk and (causal or window > 0):
        raise ValueError(f"Sq {Sq} > Sk {Sk}: the first query rows would see no key")


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0, softcap=None, scale=None):
    """Launch the kernel: q (B, Sq, Hq, D), k and v (B, Sk, Hk, D), all
    float32 or all bfloat16 -> (B, Sq, Hq, D) in q's dtype."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    window = int(window or 0)
    check_shapes(q, k, v, causal, window)
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    require(q, "q", q.dtype)
    require(k, "k", q.dtype)
    require(v, "v", q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("the kernel indexes rows with 32-bit ints: tensors must hold < 2^31 elements")
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    o = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq, Hk, D, int(bool(causal)),
            window, scale if scale is not None else 1.0 / math.sqrt(D), float(softcap or 0.0),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()} ({err})")
    return o
