"""Token embedding with the tied output head."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .module import Module, ParamSpec, normal_init


@dataclasses.dataclass(frozen=True)
class Embedding(Module):
    vocab: int
    d: int
    scale_by_sqrt_d: bool = False  # gemma multiplies embeddings by sqrt(d)

    def specs(self):
        return {"table": ParamSpec((self.vocab, self.d), ("vocab", "embed"), normal_init(0.02))}

    def __call__(self, p, tokens):
        from ..dist.sharding import reduce_partials, split_once

        # aten.embedding, not table[tokens] (aten.index): DTensor places the
        # lookup for any split of the tokens, the batch over "pod" and "data"
        # included, and gathers no more of a vocab-sharded table than one
        # split (its masked partial reduced at once); on plain tensors both
        # gather the same rows bit for bit
        x = reduce_partials(F.embedding(tokens, split_once(p["table"], 0)))
        if self.scale_by_sqrt_d:
            # the scale made on the device (a copy from the host would break a graph capture)
            x = x * torch.full((), math.sqrt(self.d), dtype=x.dtype, device=x.device)
        return x

    def attend(self, p, x):
        """Tied logits: (..., d) -> (..., vocab)."""
        return x @ p["table"].to(x.dtype).T
