"""The Mamba-2 SSD scan: a CPU tensor goes to the plain version in
``ref.py`` (``ssd_chunked``), a CUDA tensor to the hand-written kernel in
``kernel.py`` (or the call raises: there is no fallback on the card, and
the kernel takes every length, ragged tails included).

The signature follows ``repro.kernels.ssd.ops.ssd`` without its TPU knobs
(``use_pallas``, ``interpret``), plus ``return_state``, which the decode
cache needs. On the card ``chunk`` sets nothing: the kernels cut the
sequence into chunks of ``kernel.CHUNK`` (64) steps and scan them in
parallel on the tensor cores, passing only the chunk states serially (see
``csrc/ssd.cu``): the same function rounded elsewhere. Their final state is
float32 (the plain version's is in x's dtype).
``launches`` counts the calls that launched the CUDA kernel. Like the
other kernel ops, it refuses to run where autograd would need its
gradient (``kernels.refuse_grad``).
"""
from __future__ import annotations

import torch

from .. import LM_HINT, refuse_grad
from .kernel import ssd_cuda
from .ref import ssd_chunked

launches = {"ssd": 0}


def reset_launches():
    launches["ssd"] = 0


def ssd(x, dt, A, B, C, chunk: int = 128, return_state: bool = False):
    """x (b, s, h, p), dt (b, s, h), A (h,), B/C (b, s, g, n) -> y like x
    (and the final state (b, h, p, n) with ``return_state``)."""
    refuse_grad("ssd", x, dt, A, B, C, hint=LM_HINT)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk=chunk, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    out = ssd_cuda(  # x, B and C as they come (row-strided views are read in place)
        x, dt.to(x.dtype).contiguous(), A.to(torch.float32).contiguous(), B.to(x.dtype), C.to(x.dtype),
        return_state=return_state,
    )
    launches["ssd"] += 1
    return out
