"""Plain PyTorch version of the Mamba-2 SSD chunked scan: a copy of
``repro.nn.ssm.segsum`` / ``ssd_chunked`` (which ``repro_torch.nn.ssm``
re-exports). It runs in x's dtype, as the JAX function does. ``ops.py``
takes it for CPU tensors; on the card the CUDA kernel is held against it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(x):
    """Stable 'segment sum': out[..., i, j] = sum_{j < k <= i} x[..., k].

    Returns the lower-triangular log-decay matrix; upper triangle = -inf.
    x: (..., L) -> (..., L, L)
    """
    L = x.shape[-1]
    x = x[..., None].expand(*x.shape, L)  # [..., i, j] = x[..., i]
    ones = torch.ones((L, L), dtype=torch.bool, device=x.device)
    x = torch.where(torch.tril(ones, -1), x, torch.zeros((), dtype=x.dtype, device=x.device))
    x_segsum = torch.cumsum(x, dim=-2)
    return torch.where(torch.tril(ones, 0), x_segsum, torch.full((), -torch.inf, dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, return_state: bool = False):
    """Chunked SSD scan.

    x:  (b, s, h, p)   inputs per head
    dt: (b, s, h)      positive step sizes (softplus already applied)
    A:  (h,)           negative per-head decay
    B:  (b, s, g, n)   input projections (g groups broadcast over h)
    C:  (b, s, g, n)   output projections
    Returns y: (b, s, h, p) (and the final state (b, h, p, n) if return_state).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk:  # pad with dt=0 steps (identity updates: no decay, no input)
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    # (b, nc, l, h, n); B and C given per head are not copied again
    Bh, Ch = (M.reshape(b, nc, chunk, g, n) for M in (B, C))
    Bh, Ch = (M.repeat_interleave(rep, dim=3) if rep > 1 else M.contiguous() for M in (Bh, Ch))

    dA = torch.movedim(dtc * A, -1, 2)  # (b, nc, h, l) negative
    dA_cum = torch.cumsum(dA, dim=-1)

    # intra-chunk (quadratic within the chunk, dense matmuls)
    L = torch.exp(segsum(dA))  # (b, nc, h, l, l)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y_intra = torch.einsum("bchls,bcshp,bcsh->bclhp", scores * L, xc, dtc)

    # chunk states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)  # (b, nc, h, l)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bh, decay_states * torch.movedim(dtc, -1, 2), xc)

    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(dA_cum[..., -1])  # (b, nc, h)
    hstate = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (b, nc, h, p, n): the state entering each chunk

    # inter-chunk output
    decay_in = torch.exp(dA_cum)  # (b, nc, h, l): decay from the chunk start to position l
    y_inter = torch.einsum("bclhn,bchpn,bchl->bclhp", Ch, h_prevs, decay_in)

    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    if return_state:
        return y, hstate
    return y
