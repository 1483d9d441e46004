"""The fused serving blocks: a CPU tensor goes to the plain version in
``ref.py``, a CUDA tensor to the hand-written kernel in ``kernel.py`` (or
the call raises: there is no fallback on the card).

Signatures follow ``repro.kernels.fused.ops``, at both serving dtypes: x
float32 or bfloat16, w cast to x's dtype and bias, gamma and beta to
float32 on both routes (as ``ref.py`` does), the output in x's dtype. The
kernels take batch
statistics over the whole batch, so B > 1 batch norm is exact in the
kernel too. ``launches`` counts, per function, the calls that launched the
CUDA kernel — the proof that a run went through it. Every function refuses to
run where autograd would need its gradient (``kernels.refuse_grad``).
"""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import ACTS, NORMS, conv_block_cuda, sppf_pyramid_cuda
from .ref import conv_block_ref, deconv_block_ref, sppf_pyramid_ref

launches = {"conv_block": 0, "deconv_block": 0, "sppf_pyramid": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _affine(x, b, gamma, beta, cout):
    def fill(t, value):
        if t is None:
            return torch.full((cout,), value, dtype=torch.float32, device=x.device)
        return t.to(torch.float32).contiguous()

    return fill(b, 0.0), fill(gamma, 1.0), fill(beta, 0.0)


def _validate(x, w, norm, groups, act):
    if norm not in NORMS or act not in ACTS:
        raise ValueError(f"unknown norm/act {norm!r}/{act!r}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[-1] or w.shape[0] != w.shape[1]:
        raise ValueError(f"want x (B,H,W,Cin) and w (k,k,Cin,Cout); got {tuple(x.shape)}, {tuple(w.shape)}")
    if norm == "group" and w.shape[-1] % groups:
        raise ValueError(f"groups {groups} must divide Cout {w.shape[-1]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")


def _on_card(x, name):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def conv_block(
    x,
    w,
    b=None,
    gamma=None,
    beta=None,
    stride: int = 1,
    padding: int = 0,
    norm: str = "batch",
    groups: int = 1,
    act: str = "silu",
    eps: float = 1e-5,
):
    """Fused conv(+bias)+norm+act: (B, H, W, Cin) -> (B, Ho, Wo, Cout)."""
    refuse_grad("conv_block", x, w, b, gamma, beta)
    _validate(x, w, norm, groups, act)
    b, gamma, beta = _affine(x, b, gamma, beta, w.shape[-1])
    if not _on_card(x, "conv_block"):
        return conv_block_ref(
            x, w, b, gamma, beta, stride=stride, padding=padding, norm=norm,
            groups=groups, act=act, eps=eps,
        )
    y = conv_block_cuda(
        x, w.to(x.dtype).contiguous(), b, gamma, beta, stride=stride, padding=padding, norm=norm, groups=groups,
        act=act, eps=eps, deconv=False,
    )
    launches["conv_block"] += 1
    return y


def deconv_block(
    x,
    w,
    b=None,
    gamma=None,
    beta=None,
    norm: str = "batch",
    groups: int = 1,
    act: str = "relu",
    eps: float = 1e-5,
):
    """Fused k=4/s=2 deconv + crop (+bias) + norm + act: -> (B, 2H, 2W, Cout)."""
    refuse_grad("deconv_block", x, w, b, gamma, beta)
    _validate(x, w, norm, groups, act)
    if w.shape[0] != 4:
        raise ValueError(f"deconv_block is specialized to k=4, got {tuple(w.shape)}")
    b, gamma, beta = _affine(x, b, gamma, beta, w.shape[-1])
    if not _on_card(x, "deconv_block"):
        return deconv_block_ref(x, w, b, gamma, beta, norm=norm, groups=groups, act=act, eps=eps)
    y = conv_block_cuda(
        x, w.to(x.dtype).contiguous(), b, gamma, beta, stride=2, padding=1, norm=norm, groups=groups, act=act,
        eps=eps, deconv=True,
    )
    launches["deconv_block"] += 1
    return y


def sppf_pyramid(x, window: int = 5, reps: int = 3):
    """Fused SPPF pool pyramid + concat: (B, H, W, C) -> (B, H, W, (reps+1)*C).
    Max/concat only: bit-exact against the plain version at any batch."""
    refuse_grad("sppf_pyramid", x)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"want contiguous NHWC x, got shape {tuple(x.shape)}")
    if not _on_card(x, "sppf_pyramid"):
        return sppf_pyramid_ref(x, window=window, reps=reps)
    y = sppf_pyramid_cuda(x, window=window, reps=reps)
    launches["sppf_pyramid"] += 1
    return y
