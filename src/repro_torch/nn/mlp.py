"""Gated / plain MLPs."""
from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from .linear import Linear
from .module import Module

# jax.nn.gelu is the tanh approximation by default (approximate=True), so
# both names map to torch's tanh form; torch's own default is the exact erf
ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
}


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Gated (SwiGLU/GeGLU) or plain MLP."""

    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True

    def specs(self):
        s = {
            "up": Linear(self.d_model, self.d_ff, in_axis="embed", out_axis="mlp"),
            "down": Linear(self.d_ff, self.d_model, in_axis="mlp", out_axis="embed"),
        }
        if self.gated:
            s["gate"] = Linear(self.d_model, self.d_ff, in_axis="embed", out_axis="mlp")
        return s

    def __call__(self, p, x):
        up = Linear(self.d_model, self.d_ff)(p["up"], x)
        act = ACTS[self.act]
        h = act(Linear(self.d_model, self.d_ff)(p["gate"], x)) * up if self.gated else act(up)
        return Linear(self.d_ff, self.d_model)(p["down"], h)
