"""Mixture-of-Experts (DeepSeekMoE-style: shared + fine-grained routed
experts), the counterpart of ``repro.nn.moe``.

Dispatch is the JAX package's sort + static-capacity gather/scatter, step
for step, so the same tokens go to the same experts and the same ones are
dropped: each expert takes at most ``C = max(8, ceil(T * top_k *
capacity_factor / E))`` tokens, in token order, and a token past that is
dropped from the expert (its slot reads a zero row and adds nothing).
Routed weights are stacked (E, ...) as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .mlp import MLP
from .module import Module, ParamSpec, lecun_init, normal_init


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass(frozen=True)
class MoE(Module):
    d_model: int
    d_ff_expert: int  # fine-grained expert width
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
    router_scale: bool = False  # deepseek-v2 uses routed_scaling_factor
    routed_scaling_factor: float = 1.0

    def specs(self):
        E, d, f = self.n_experts, self.d_model, self.d_ff_expert
        s = {
            "router": ParamSpec((d, E), ("embed", None), normal_init(0.02)),
            "w_gate": ParamSpec((E, d, f), ("expert", "embed", "mlp"), lecun_init((-2,))),
            "w_up": ParamSpec((E, d, f), ("expert", "embed", "mlp"), lecun_init((-2,))),
            "w_down": ParamSpec((E, f, d), ("expert", "mlp", "embed"), lecun_init((-2,))),
        }
        if self.n_shared:
            s["shared"] = MLP(d, f * self.n_shared, act=self.act, gated=True)
        return s

    def capacity(self, n_tokens: int) -> int:
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        return max(8, int(c))

    def route(self, p, xf):
        """xf (T, d) -> (router probs (T, E) f32, gates (T, k) f32, expert
        ids (T, k))."""
        logits = xf.float() @ p["router"].float()  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gates, eidx = top_k(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
        if self.router_scale:
            gates = gates * self.routed_scaling_factor
        return probs, gates, eidx

    def dispatch(self, eidx, gates, T: int):
        """The static-capacity slots: (token id per (expert, slot) row, with
        T for an empty row; gate per row, 0 for an empty row), both (E*C,)."""
        E, k, C = self.n_experts, self.top_k, self.capacity(T)
        dev = eidx.device
        flat_e = eidx.reshape(T * k)
        order = torch.argsort(flat_e, stable=True)  # (T*k,)
        tok = order // k  # source token per sorted slot
        sorted_e = flat_e[order]
        # index of each entry within its expert group
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.arange(T * k, device=dev) - first
        valid = pos < C
        slot = torch.where(valid, sorted_e * C + pos, E * C)  # overflow -> the dropped row E*C
        # out of place, as the combine below: over a mesh (DTensor operands) an in-place write into a
        # plain buffer is refused, and one into a partial sum is summed over the ranks
        slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev).index_put(
            (slot,), torch.where(valid, tok, T))
        slot_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev).index_put(
            (slot,), torch.where(valid, gates.reshape(T * k)[order], 0.0))
        return slot_tok[: E * C], slot_gate[: E * C]

    def __call__(self, p, x):
        """x: (B, S, d) -> (y, aux_loss)."""
        B, S, d = x.shape
        T = B * S
        E, k = self.n_experts, self.top_k
        C = self.capacity(T)
        xf = x.reshape(T, d)
        probs, gates, eidx = self.route(p, xf)
        slot_tok, slot_gate = self.dispatch(eidx, gates, T)

        x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
        ein = x_pad[slot_tok].reshape(E, C, d)

        # ---- expert GEMMs (E, C, d) x (E, d, f) ----
        g = torch.bmm(ein, p["w_gate"].to(ein.dtype))
        u = torch.bmm(ein, p["w_up"].to(ein.dtype))
        eout = torch.bmm(F.silu(g) * u, p["w_down"].to(ein.dtype))

        # ---- combine (scatter-add back to tokens, out of place) ----
        weighted = eout.reshape(E * C, d) * slot_gate[:, None].to(eout.dtype)
        y = weighted.new_zeros((T + 1, d)).index_add(0, slot_tok, weighted)[:T]
        y = y.reshape(B, S, d).to(x.dtype)

        if self.n_shared:
            y = y + MLP(self.d_model, self.d_ff_expert * self.n_shared, act=self.act)(p["shared"], x)

        # Switch-style load-balance aux loss
        me = probs.mean(dim=0)  # (E,)
        ce = F.one_hot(eidx, E).float().sum(dim=1).mean(dim=0)  # fraction routed per expert
        aux = (me * ce).sum() * E / k
        return y, aux
