"""The hardware-aware transposed conv: a CPU tensor goes to the plain
version in ``ref.py``, a CUDA tensor to the hand-written kernel in
``kernel.py`` (or the call raises: there is no fallback on the card).

The signature follows ``repro.kernels.deconv.ops.deconv2d`` without its
TPU knobs (``use_pallas``, ``interpret``, ``tile_h``). ``launches`` counts
the calls that launched the CUDA kernel — the proof that a run went
through it. Like the fused ops, it refuses to run where autograd would
need its gradient (``kernels.refuse_grad``).
"""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import deconv2d_cuda
from .ref import deconv2d_ref

launches = {"deconv2d": 0}


def reset_launches():
    launches["deconv2d"] = 0


def deconv2d(x, w, b=None, stride: int = 2, padding: int = 1):
    """Transposed conv with torch-style ``padding`` (the Pix2Pix up-op):
    x (B, H, W, Cin), w (k, k, Cin, Cout) -> (B, 2H, 2W, Cout) for the
    paper's k=4, stride=2, padding=1, in x's dtype.

    On the card only that configuration has a kernel; the JAX package sends
    the others to its reference, but no caller reaches them, so here they
    raise on a CUDA tensor."""
    refuse_grad("deconv2d", x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[-1] or w.shape[0] != w.shape[1]:
        raise ValueError(f"want x (B,H,W,Cin) and w (k,k,Cin,Cout); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return deconv2d_ref(x, w, b=b, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"deconv2d: no kernel for device {x.device}")
    if (w.shape[0], stride, padding) != (4, 2, 1):
        raise ValueError(
            f"deconv2d's kernel is the k=4, stride=2, padding=1 deconv; got k={w.shape[0]}, "
            f"stride={stride}, padding={padding}"
        )
    y = deconv2d_cuda(
        x.contiguous(), w.to(x.dtype).contiguous(),
        None if b is None else b.to(x.dtype).to(torch.float32).contiguous(),
    )
    launches["deconv2d"] += 1
    return y
