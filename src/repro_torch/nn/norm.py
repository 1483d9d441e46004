"""Normalization layers (computed in fp32, cast back): RMSNorm and
LayerNorm over the last axis, and instance / group norm on NHWC tensors."""
from __future__ import annotations

import dataclasses

import torch

from .module import Module, ParamSpec, ones_init, zeros_init


def _normalize(x32, dims, eps):
    # population variance (correction=0), as jnp.var
    var, mean = torch.var_mean(x32, dim=dims, keepdim=True, correction=0)
    return (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))


@dataclasses.dataclass(frozen=True)
class RMSNorm(Module):
    d: int
    eps: float = 1e-6
    # gemma convention: weight stored as (1 + scale) with zero-init scale
    zero_centered: bool = False
    axis_name: str | None = None

    def specs(self):
        init = zeros_init() if self.zero_centered else ones_init()
        return {"scale": ParamSpec((self.d,), (self.axis_name,), init)}

    def __call__(self, p, x):
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.reciprocal(torch.sqrt(var + self.eps))
        scale = p["scale"].float()
        if self.zero_centered:
            scale = 1.0 + scale
        return (y * scale).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class InstanceNorm2D(Module):
    """Per-sample, per-channel statistics over (H, W) on NHWC tensors.

    Batch-independent drop-in for ``BatchNorm2D``'s batch-stats inference
    behaviour (identical math at batch size 1)."""

    c: int
    eps: float = 1e-5

    def specs(self):
        return {
            "scale": ParamSpec((self.c,), ("conv_out",), ones_init()),
            "bias": ParamSpec((self.c,), ("conv_out",), zeros_init()),
        }

    def __call__(self, p, x):
        y = _normalize(x.float(), (1, 2), self.eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class GroupNorm2D(Module):
    """Per-sample statistics over (H, W, C/groups) on NHWC tensors.

    ``groups=1`` is layer-norm-over-space, ``groups=c`` is instance norm;
    batch-independent for any group count."""

    c: int
    groups: int = 8
    eps: float = 1e-5

    def __post_init__(self):
        if self.c % self.groups:
            raise ValueError(f"channels {self.c} not divisible by groups {self.groups}")

    def specs(self):
        return {
            "scale": ParamSpec((self.c,), ("conv_out",), ones_init()),
            "bias": ParamSpec((self.c,), ("conv_out",), zeros_init()),
        }

    def __call__(self, p, x):
        b, h, w, _ = x.shape
        x32 = x.float().reshape(b, h, w, self.groups, self.c // self.groups)
        y = _normalize(x32, (1, 2, 4), self.eps).reshape(b, h, w, self.c)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerNorm(Module):
    d: int
    eps: float = 1e-5
    use_bias: bool = True
    axis_name: str | None = None

    def specs(self):
        s = {"scale": ParamSpec((self.d,), (self.axis_name,), ones_init())}
        if self.use_bias:
            s["bias"] = ParamSpec((self.d,), (self.axis_name,), zeros_init())
        return s

    def __call__(self, p, x):
        y = _normalize(x.float(), -1, self.eps) * p["scale"].float()
        if self.use_bias:
            y = y + p["bias"].float()
        return y.to(x.dtype)
