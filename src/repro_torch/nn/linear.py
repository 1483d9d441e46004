"""Dense layers in the JAX package's layouts: ``Linear`` (d_in, d_out),
``MultiLinear`` (d_in, heads, per_head) and ``OutputLinear`` (heads,
per_head, d_out), the attention projections' head layouts."""
from __future__ import annotations

import dataclasses

from .module import Module, ParamSpec, lecun_init, zeros_init


@dataclasses.dataclass(frozen=True)
class Linear(Module):
    """y = x @ w + b, contracting the last dim of x."""

    d_in: int
    d_out: int
    use_bias: bool = False
    in_axis: str | None = "embed"
    out_axis: str | None = "mlp"

    def specs(self):
        s = {"w": ParamSpec((self.d_in, self.d_out), (self.in_axis, self.out_axis), lecun_init((-2,)))}
        if self.use_bias:
            s["b"] = ParamSpec((self.d_out,), (self.out_axis,), zeros_init())
        return s

    def __call__(self, p, x):
        y = x @ p["w"].to(x.dtype)
        if self.use_bias:
            y = y + p["b"].to(x.dtype)
        return y


@dataclasses.dataclass(frozen=True)
class MultiLinear(Module):
    """x (..., d_in) -> (..., heads, per_head). Used for attention projections."""

    d_in: int
    heads: int
    per_head: int
    in_axis: str | None = "embed"
    head_axis: str | None = "heads"

    def specs(self):
        return {
            "w": ParamSpec(
                (self.d_in, self.heads, self.per_head), (self.in_axis, self.head_axis, None), lecun_init((-3,))
            )
        }

    def __call__(self, p, x):
        w = p["w"].to(x.dtype).reshape(self.d_in, self.heads * self.per_head)
        return (x @ w).reshape(*x.shape[:-1], self.heads, self.per_head)


@dataclasses.dataclass(frozen=True)
class OutputLinear(Module):
    """(..., heads, per_head) -> (..., d_out). Attention output projection."""

    heads: int
    per_head: int
    d_out: int
    head_axis: str | None = "heads"
    out_axis: str | None = "embed"

    def specs(self):
        return {
            "w": ParamSpec(
                (self.heads, self.per_head, self.d_out), (self.head_axis, None, self.out_axis), lecun_init((-3, -2))
            )
        }

    def __call__(self, p, x):
        w = p["w"].to(x.dtype).reshape(self.heads * self.per_head, self.d_out)
        return x.reshape(*x.shape[:-2], self.heads * self.per_head) @ w
