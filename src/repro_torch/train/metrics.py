"""Image-quality metrics from the paper (§III.B eq. 1-3) + detection IoU.

Images are NHWC, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.conv import nchw, nhwc


def mse(original, generated):
    """Paper eq. (1). Images in [0, 255] convention for Table II parity."""
    o = original.float()
    g = generated.float()
    return torch.mean(torch.square(o - g), dim=(-3, -2, -1))


def psnr(original, generated, max_val: float = 255.0):
    """Paper eq. (2): 10 log10((L-1)^2 / MSE)."""
    m = mse(original, generated)
    return 10.0 * torch.log10(max_val**2 / torch.clamp_min(m, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(original, generated, max_val: float = 255.0, size: int = 11, sigma: float = 1.5):
    """Paper eq. (3), standard Gaussian-window SSIM, averaged over channels.

    Inputs (B, H, W, C) in [0, max_val]. The window runs as a depthwise
    VALID ``F.conv2d`` over each channel."""
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    C = original.shape[-1]
    kern = _gaussian_kernel(size, sigma, original.device).expand(C, 1, size, size)

    def filt(img):
        return nhwc(F.conv2d(nchw(img), kern, groups=C))

    o = original.float()
    g = generated.float()
    mu_o, mu_g = filt(o), filt(g)
    var_o = filt(o * o) - mu_o**2
    var_g = filt(g * g) - mu_g**2
    cov = filt(o * g) - mu_o * mu_g
    s = ((2 * mu_o * mu_g + c1) * (2 * cov + c2)) / (
        (mu_o**2 + mu_g**2 + c1) * (var_o + var_g + c2)
    )
    return torch.mean(s, dim=(-3, -2, -1))


def to_uint8_range(x):
    """[-1, 1] tanh output -> [0, 255]."""
    return (torch.clamp(x, -1.0, 1.0) + 1.0) * 127.5


def box_iou(a, b):
    """a, b: (..., 4) as (x1, y1, x2, y2)."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0) * torch.clamp_min(a[..., 3] - a[..., 1], 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0) * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-9)
