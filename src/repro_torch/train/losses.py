"""Losses: the LM cross-entropies (``cross_entropy``, and
``chunked_cross_entropy``, which fuses the LM head with the loss over
sequence chunks), the Pix2Pix GAN objectives and the simplified detection
loss."""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..dist.sharding import split_once


def _one_vocab_split(logits):
    """``logits`` with the vocab (last) dim split over one mesh dim at most,
    the largest of those that split it; a plain tensor as it is. DTensor's
    gather from a vocab-sharded tensor gives the index one masked partial
    per splitting mesh dim, all sharing one mask, and refuses a second mask
    as conflicting (phi4-mini's 200,064 tokens over "model" and "pod")."""
    return split_once(logits, -1)


def _token_nll(logits, labels):
    """Per-token NLL (..., V) -> (...): the max detached, the shifted
    logits in fp32 (subtracted in the logits' dtype, then cast, as the JAX
    package computes them), and the gold logit picked by its label."""
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    shifted = (logits - m).float()
    logz = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(_one_vocab_split(shifted), -1, labels.long()[..., None])
    # the trailing dim is dropped after the subtraction: a gather from
    # vocab-sharded logits stays a masked partial sum until then, and its
    # mask has the gather's rank
    return (logz[..., None] - gold)[..., 0]


def _masked_mean(nll, mask):
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) (any float dtype), labels (B,S) int -> the mean NLL in
    fp32, over the tokens where ``mask`` is set (a mask of zeros gives 0)."""
    return _masked_mean(_token_nll(logits, labels), mask)


def chunked_cross_entropy(head_fn, params, hidden, labels, mask=None, chunk: int = 512):
    """The LM head fused with the loss over sequence chunks: the (B, S, V)
    logits never exist at once. Each (B, chunk, V) block is computed by
    ``head_fn(params, h)`` for a hidden chunk h (B, chunk, d), reduced to
    per-token NLL, and recomputed in backward (``torch.utils.checkpoint``,
    non-reentrant, where autograd records). ``S % chunk`` or ``S <= chunk``
    falls through to ``cross_entropy`` on the whole head, as in the JAX
    package."""
    S = labels.shape[1]
    if S % chunk or S <= chunk:
        return cross_entropy(head_fn(params, hidden), labels, mask)

    def body(h, lb):
        return _token_nll(head_fn(params, h), lb)

    grad = torch.is_grad_enabled()
    nll = []
    for i in range(0, S, chunk):
        h, lb = hidden[:, i : i + chunk], labels[:, i : i + chunk]
        nll.append(torch.utils.checkpoint.checkpoint(body, h, lb, use_reentrant=False) if grad else body(h, lb))
    return _masked_mean(torch.cat(nll, dim=1), mask)


def bce_with_logits(logits, targets):
    logits = logits.float()
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def pix2pix_g_loss(disc_fake_logits, fake, real, lambda_l1: float = 100.0):
    """Generator loss: BCE(D(x, G(x)), 1) + lambda * L1(G(x), y) (paper §V.A.1)."""
    adv = bce_with_logits(disc_fake_logits, torch.ones_like(disc_fake_logits))
    l1 = torch.mean(torch.abs(fake.float() - real.float()))
    return adv + lambda_l1 * l1, {"g_adv": adv, "g_l1": l1}


def pix2pix_d_loss(disc_real_logits, disc_fake_logits):
    real = bce_with_logits(disc_real_logits, torch.ones_like(disc_real_logits))
    fake = bce_with_logits(disc_fake_logits, torch.zeros_like(disc_fake_logits))
    return real + fake, {"d_real": real, "d_fake": fake}


def yolo_loss(preds: dict, targets: dict, n_classes: int, reg_max: int = 16):
    """Simplified anchor-free detection loss on grid-assigned targets.

    targets per scale: {"cls": (B,H,W) int (-1 = background),
                        "box": (B,H,W,4) normalized l,t,r,b distances}.
    BCE on class logits + DFL-style CE on the discretized box distances
    for positive cells. (The paper consumes only detector throughput; this
    loss exists so the end-to-end training path is runnable.)
    """
    total = 0.0
    n_pos_total = 0.0
    for scale in ("p3", "p4", "p5"):
        p = preds[scale].float()
        box_logits = p[..., : 4 * reg_max]
        cls_logits = p[..., 4 * reg_max :]
        t = targets[scale]
        pos = (t["cls"] >= 0).float()
        onehot = F.one_hot(t["cls"].clamp_min(0).long(), n_classes).float() * pos[..., None]
        cls_bce = (
            torch.clamp_min(cls_logits, 0.0)
            - cls_logits * onehot
            + torch.log1p(torch.exp(-torch.abs(cls_logits)))
        )
        total = total + torch.sum(cls_bce) / cls_bce.numel()
        # DFL: each of 4 sides as distribution over reg_max bins
        B, H, W, _ = box_logits.shape
        bl = box_logits.reshape(B, H, W, 4, reg_max)
        tgt = torch.clamp(t["box"].float() * (reg_max - 1), 0, reg_max - 1)
        lo = torch.floor(tgt).long()
        hi = torch.clamp_max(lo + 1, reg_max - 1)
        w_hi = tgt - lo
        logp = F.log_softmax(bl, dim=-1)
        nll = -(
            (1 - w_hi) * torch.gather(logp, -1, lo[..., None])[..., 0]
            + w_hi * torch.gather(logp, -1, hi[..., None])[..., 0]
        )
        total = total + torch.sum(nll * pos[..., None]) / torch.clamp_min(torch.sum(pos) * 4, 1.0)
        n_pos_total = n_pos_total + torch.sum(pos)
    return total, {"n_pos": n_pos_total}
