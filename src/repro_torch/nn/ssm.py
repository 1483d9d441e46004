"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060): the counterpart of
``repro.nn.ssm``.

``ssd_chunked`` (the plain scan, kept in ``kernels/ssd/ref.py`` and
re-exported here) is the oracle of the SSD kernel. ``Mamba2Block`` is the
full block: in-projections -> causal depthwise conv -> SSD -> gated RMSNorm
-> out_proj, with a single-token ``decode`` path that carries (conv buffer,
ssm state). Its full-sequence scan goes through ``kernels.ssd.ops.ssd``
(the plain version on a CPU tensor, the CUDA kernel on a CUDA tensor) where
autograd needs no gradient through it, and through ``ssd_chunked`` where it
does, on both devices: the kernel has no backward, and the JAX package's
block always runs ``ssd_chunked``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..dist.sharding import blockwise
from ..kernels import grad_route
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ref import segsum, ssd_chunked  # noqa: F401  (re-exported)
from .module import Module, ParamSpec, RowMajorGrad, lecun_init, normal_init, ones_init, zeros_init
from .norm import RMSNorm


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD update.

    state: (b, h, p, n); x_t: (b, h, p); dt_t: (b, h); B_t/C_t: (b, g, n)
    Returns (y_t, new_state). Over DTensors, block by block over the batch
    and the heads (``dist.blockwise``).
    """
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)  # (b, h, n)
    Ch = C_t.repeat_interleave(rep, dim=1)
    return blockwise(_ssd_update, "bhpn,bhp,bh,h,bhn,bhn->bhp,bhpn", "bh", state, x_t, dt_t, A, Bh, Ch)


def _scan_blocks(x, dt, A, B, C, chunk, return_state):
    """``ssd_chunked``; over DTensors, block by block over the batch and the
    heads (``dist.blockwise``). A block of heads needs its own groups'
    projections, so B and C are spread from groups to heads first (the
    values the scan spreads them to itself)."""
    rep = x.shape[2] // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)  # (b, s, h, n)
    outs = "bshp,bhpn" if return_state else "bshp"
    return blockwise(lambda *t: ssd_chunked(*t, chunk=chunk, return_state=return_state), "bshp,bsh,h,bshn,bshn->" + outs,
                     "bh", x, dt, A, Bh, Ch)


def _ssd_update(state, x_t, dt_t, A, Bh, Ch):
    dA = torch.exp(dt_t * A)  # (b, h)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt_t, Bh, x_t)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


class _FlatHeads(torch.autograd.Function):
    """(b, s, h, p) -> (b, s, h * p), whose gradient is viewed back to
    heads only after a mesh dim that splits the flat dim into pieces of
    heads is gathered: DTensor cannot view such a split (GSPMD pads it).
    The out-projection's weights, sharded on that dim over the model axis,
    hand the gradient back so: hymba-1.5b's 3,200 = 50 heads x 64 over 16
    ranks. The values are unchanged."""

    @staticmethod
    def forward(ctx, y):
        ctx.heads = tuple(y.shape[2:])
        return y.reshape(*y.shape[:2], -1)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.heads[0]).reshape(*g.shape[:2], *ctx.heads)


def _whole_heads(g, heads: int):
    """``g`` with its last dim gathered where the mesh dims that shard it do
    not split ``heads`` evenly; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(g, DTensor):
        return g
    last = [i for i, pl in enumerate(g.placements) if isinstance(pl, Shard) and pl.dim == g.ndim - 1]
    if heads % math.prod(g.device_mesh.size(i) for i in last) == 0:
        return g
    return g.redistribute(g.device_mesh, [Replicate() if i in last else pl for i, pl in enumerate(g.placements)])


@dataclasses.dataclass(frozen=True)
class Mamba2Block(Module):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.n_groups * self.d_state

    def specs(self):
        d, di = self.d_model, self.d_inner
        H, gn = self.n_heads, self.n_groups * self.d_state
        return {
            "wz": ParamSpec((d, di), ("embed", "mlp"), lecun_init((-2,))),
            "wx": ParamSpec((d, di), ("embed", "mlp"), lecun_init((-2,))),
            "wB": ParamSpec((d, gn), ("embed", None), lecun_init((-2,))),
            "wC": ParamSpec((d, gn), ("embed", None), lecun_init((-2,))),
            "wdt": ParamSpec((d, H), ("embed", None), lecun_init((-2,))),
            "conv_w": ParamSpec((self.d_conv, self.conv_dim), (None, None), normal_init(0.1)),
            "conv_b": ParamSpec((self.conv_dim,), (None,), zeros_init()),
            "A_log": ParamSpec((H,), (None,), _a_log_init(H)),
            "D": ParamSpec((H,), (None,), ones_init()),
            "dt_bias": ParamSpec((H,), (None,), _dt_bias_init(H, self.dt_min, self.dt_max)),
            "norm": RMSNorm(di),
            "out_proj": ParamSpec((di, d), ("mlp", "embed"), lecun_init((-2,))),
        }

    def _project(self, p, x):
        """x (..., d) -> (z (..., di), xbc (..., conv_dim), dt (..., H))."""
        w = lambda name: p[name].to(x.dtype)  # noqa: E731
        z = x @ w("wz")
        xbc = torch.cat([x @ w("wx"), x @ w("wB"), x @ w("wC")], dim=-1)
        return z, xbc, x @ w("wdt")

    def _conv(self, p, xbc):
        """Causal depthwise conv over (B, S, conv_dim)."""
        w = p["conv_w"].to(xbc.dtype)  # (k, conv_dim)
        k, S = self.d_conv, xbc.shape[1]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        out = 0
        for i in range(k):  # the JAX package's sum() order: ((0 + t0) + t1) + ...
            out = out + pad[:, i : i + S, :] * w[i]
        return F.silu(out + p["conv_b"].to(xbc.dtype))

    def _scan(self, p, x, z, xbc_raw, dt, return_state):
        B_, S, _ = x.shape
        di, g, n, H, P = self.d_inner, self.n_groups, self.d_state, self.n_heads, self.head_dim
        xbc = self._conv(p, xbc_raw)
        xs = xbc[..., :di].reshape(B_, S, H, P)
        Bmat = xbc[..., di : di + g * n].reshape(B_, S, g, n)
        Cmat = xbc[..., di + g * n :].reshape(B_, S, g, n)
        dt = F.softplus(dt.float() + p["dt_bias"]).to(x.dtype)  # (B,S,H)
        if dt.requires_grad:
            dt = RowMajorGrad.apply(dt)
        A = -torch.exp(p["A_log"].float()).to(x.dtype)  # (H,)
        # the kernel on a CUDA tensor where autograd needs no gradient; the
        # plain scan elsewhere (the CPU, a dry run's meta tensors, training)
        kernel = xs.device.type == "cuda" and not grad_route("ssd", xs, dt, A, Bmat, Cmat)
        scan = ssd_ops.ssd if kernel else _scan_blocks
        out = scan(xs, dt, A, Bmat, Cmat, chunk=min(self.chunk, S), return_state=return_state)
        y, state = out if return_state else (out, None)
        y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
        y = _FlatHeads.apply(y) if y.requires_grad else y.reshape(B_, S, di)
        y = RMSNorm(di)(p["norm"], y) * F.silu(z)
        return y @ p["out_proj"].to(x.dtype), state

    def __call__(self, p, x):
        z, xbc, dt = self._project(p, x)
        return self._scan(p, x, z, xbc, dt, return_state=False)[0]

    def prefill(self, p, x, cache_dtype=torch.bfloat16):
        """Forward over the prompt, returning output + (conv, ssm) state."""
        z, xbc_raw, dt = self._project(p, x)
        out, final_state = self._scan(p, x, z, xbc_raw, dt, return_state=True)
        conv_tail = xbc_raw[:, -(self.d_conv - 1) :, :]
        return out, {"conv": conv_tail.to(cache_dtype), "ssm": final_state.to(torch.float32)}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, dtype=torch.bfloat16, device=None):
        return {
            "conv": torch.zeros((batch, self.d_conv - 1, self.conv_dim), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, self.n_heads, self.head_dim, self.d_state), dtype=torch.float32,
                               device=device),
        }

    def abstract_cache(self, batch: int, dtype=torch.bfloat16):
        """``init_cache``'s tree as ``meta`` tensors."""
        return self.init_cache(batch, dtype, "meta")

    def decode(self, p, x, cache):
        """x: (B, 1, d) -> (y (B,1,d), cache). The new states are copied
        into the given ``conv`` and ``ssm`` tensors, which are returned (the
        JAX cell's donated cache, updated in place)."""
        B_ = x.shape[0]
        di, g, n, H, P = self.d_inner, self.n_groups, self.d_state, self.n_heads, self.head_dim
        z, xbc, dt = self._project(p, x)  # (B,1,...)
        window = torch.cat([cache["conv"].to(x.dtype), xbc], dim=1)  # (B, k, conv_dim)
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
        xbc_t = F.silu(conv_out)  # (B, conv_dim)
        xs = xbc_t[:, :di].reshape(B_, H, P)
        Bmat = xbc_t[:, di : di + g * n].reshape(B_, g, n)
        Cmat = xbc_t[:, di + g * n :].reshape(B_, g, n)
        dt_t = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
        A = -torch.exp(p["A_log"].float())
        y, new_ssm = ssd_decode_step(cache["ssm"], xs.float(), dt_t, A, Bmat.float(), Cmat.float())
        y = y.to(x.dtype) + xs * p["D"].to(x.dtype)[None, :, None]
        y = RMSNorm(di)(p["norm"], y.reshape(B_, 1, di)) * F.silu(z)
        out = y @ p["out_proj"].to(x.dtype)
        return out, {"conv": cache["conv"].copy_(window[:, 1:, :]), "ssm": cache["ssm"].copy_(new_ssm)}


def _a_log_init(H):
    def f(g, shape, dtype):
        return torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=g.device)).to(dtype)

    return f


def _dt_bias_init(H, dt_min, dt_max):
    def f(g, shape, dtype):
        u = torch.rand((H,), generator=g, dtype=torch.float32, device=g.device)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inverse softplus

    return f
