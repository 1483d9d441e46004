"""Plain PyTorch version of the hardware-aware transposed convolution.

Torch semantics: out = stride*(in-1) + k - 2*padding, computed as the
pad-free (VALID) transposed conv followed by a border crop — the exact op
pair the paper substitutes for the DLA-illegal padded deconv (eq. 5+7 ==
eq. 6). ``ops.py`` takes it for CPU tensors; on the card the CUDA kernel is
held against it.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...nn.conv import deconv_weight, nchw, nhwc


def deconv2d_ref(x, w, b=None, stride: int = 2, padding: int = 1):
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout) as ``lax.conv_transpose``
    applies it; torch-style ``padding``."""
    y = nhwc(F.conv_transpose2d(nchw(x), deconv_weight(w.to(x.dtype)), stride=stride))
    if padding:
        y = y[:, padding:-padding, padding:-padding, :]
    if b is not None:
        y = y + b.to(x.dtype)
    return y
