"""Token embedding with the tied output head."""
from __future__ import annotations

import dataclasses
import math

from .module import Module, ParamSpec, normal_init


@dataclasses.dataclass(frozen=True)
class Embedding(Module):
    vocab: int
    d: int
    scale_by_sqrt_d: bool = False  # gemma multiplies embeddings by sqrt(d)

    def specs(self):
        return {"table": ParamSpec((self.vocab, self.d), ("vocab", "embed"), normal_init(0.02))}

    def __call__(self, p, tokens):
        x = p["table"][tokens]
        if self.scale_by_sqrt_d:
            x = x * x.new_tensor(math.sqrt(self.d))
        return x

    def attend(self, p, x):
        """Tied logits: (..., d) -> (..., vocab)."""
        return x @ p["table"].to(x.dtype).T
