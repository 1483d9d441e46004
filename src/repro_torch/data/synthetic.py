"""Synthetic data: paired CT/MRI brain phantoms + lesion boxes + LM tokens.

The paper's datasets ([28] paired CT/MRI, [35] stroke detection) are not
available offline; these generators produce *structured* phantoms with a
deterministic CT<->MRI intensity relationship so that the full training /
evaluation / metric pipeline is executable and the Table II *trends*
(cropping/conv variants vs original) are measurable.

Geometry per sample: an elliptical skull ring, 3-6 soft-tissue ellipses,
ventricle pair, and (with probability ``lesion_p``) a bright lesion blob.
CT mapping: bone bright, tissue flat, lesion faint. MRI mapping: bone
dark, tissue textured by class, lesion bright — i.e. the translation task
carries real information.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PhantomConfig:
    img_size: int = 256
    lesion_p: float = 0.7
    n_tissue: tuple[int, int] = (3, 6)
    noise: float = 0.02


def _ellipse_mask(h, w, cy, cx, ry, rx, theta, yy, xx):
    ct, st = np.cos(theta), np.sin(theta)
    y = yy - cy
    x = xx - cx
    u = (ct * x + st * y) / rx
    v = (-st * x + ct * y) / ry
    return (u * u + v * v) <= 1.0


def make_phantom_pair(rng: np.random.Generator, cfg: PhantomConfig):
    """Returns (ct, mri, boxes, labels): images (H, W, 1) in [-1, 1];
    boxes (x1,y1,x2,y2) normalized; labels int (0 = lesion)."""
    s = cfg.img_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    ct = np.full((s, s), -1.0, np.float32)
    mri = np.full((s, s), -1.0, np.float32)

    cy, cx = s / 2 + rng.uniform(-8, 8), s / 2 + rng.uniform(-8, 8)
    ry, rx = s * rng.uniform(0.36, 0.44), s * rng.uniform(0.30, 0.38)
    theta = rng.uniform(-0.3, 0.3)
    skull_outer = _ellipse_mask(s, s, cy, cx, ry, rx, theta, yy, xx)
    skull_inner = _ellipse_mask(s, s, cy, cx, ry * 0.92, rx * 0.92, theta, yy, xx)
    brain = skull_inner
    ring = skull_outer & ~skull_inner
    # CT: bone very bright, brain mildly uniform
    ct[ring] = 0.95
    ct[brain] = -0.1
    # MRI: bone dark, brain bright-ish grey
    mri[ring] = -0.85
    mri[brain] = 0.15

    n_tis = rng.integers(cfg.n_tissue[0], cfg.n_tissue[1] + 1)
    for i in range(n_tis):
        tcy = cy + rng.uniform(-0.5, 0.5) * ry
        tcx = cx + rng.uniform(-0.5, 0.5) * rx
        tr = rng.uniform(0.08, 0.22) * min(ry, rx)
        m = _ellipse_mask(s, s, tcy, tcx, tr, tr * rng.uniform(0.6, 1.4), rng.uniform(0, np.pi), yy, xx) & brain
        cls = rng.integers(0, 3)
        ct[m] = ct[m] + [0.05, 0.12, -0.05][cls]
        mri[m] = mri[m] + [0.45, -0.25, 0.3][cls]  # tissue contrast lives in MRI

    # ventricles
    for sgn in (-1, 1):
        m = _ellipse_mask(s, s, cy, cx + sgn * 0.18 * rx, ry * 0.22, rx * 0.1, theta + sgn * 0.5, yy, xx) & brain
        ct[m] = -0.25
        mri[m] = -0.55

    boxes, labels = [], []
    if rng.uniform() < cfg.lesion_p:
        lcy = cy + rng.uniform(-0.45, 0.45) * ry
        lcx = cx + rng.uniform(-0.45, 0.45) * rx
        lr = rng.uniform(0.05, 0.12) * min(ry, rx)
        lrx = lr * rng.uniform(0.7, 1.3)
        m = _ellipse_mask(s, s, lcy, lcx, lr, lrx, rng.uniform(0, np.pi), yy, xx) & brain
        ct[m] = 0.35  # hyperdense on CT (hemorrhagic stroke)
        mri[m] = 0.9
        if m.any():
            ys, xs = np.where(m)
            boxes.append([xs.min() / s, ys.min() / s, (xs.max() + 1) / s, (ys.max() + 1) / s])
            labels.append(0)

    noise = rng.normal(0, cfg.noise, (2, s, s)).astype(np.float32)
    ct = np.clip(ct + noise[0], -1, 1)[..., None]
    mri = np.clip(mri + noise[1], -1, 1)[..., None]
    return ct, mri, np.array(boxes, np.float32).reshape(-1, 4), np.array(labels, np.int32)


def phantom_batches(
    batch: int, cfg: PhantomConfig = PhantomConfig(), seed: int = 0, channels: int = 3
) -> Iterator[dict]:
    """Infinite iterator of {"src": CT, "dst": MRI} batches (NHWC, [-1,1])."""
    rng = np.random.default_rng(seed)
    while True:
        cts, mris = [], []
        for _ in range(batch):
            ct, mri, _, _ = make_phantom_pair(rng, cfg)
            cts.append(np.repeat(ct, channels, axis=-1))
            mris.append(np.repeat(mri, channels, axis=-1))
        yield {"src": np.stack(cts), "dst": np.stack(mris)}


def grid_targets(boxes, labels, img_size: int, strides=(8, 16, 32), n_classes: int = 2):
    """Assign boxes to center cells per FPN scale (simplified TAL)."""
    out = {}
    for name, st in zip(("p3", "p4", "p5"), strides):
        g = img_size // st
        cls = np.full((g, g), -1, np.int32)
        box = np.zeros((g, g, 4), np.float32)
        for b, l in zip(boxes, labels):
            cx, cy = (b[0] + b[2]) / 2 * g, (b[1] + b[3]) / 2 * g
            ix, iy = int(np.clip(cx, 0, g - 1)), int(np.clip(cy, 0, g - 1))
            cls[iy, ix] = l
            # l, t, r, b distances normalized to [0,1] by scale extent
            box[iy, ix] = np.clip(
                [cx - b[0] * g, cy - b[1] * g, b[2] * g - cx, b[3] * g - cy], 0, g
            ) / g
        out[name] = {"cls": cls, "box": box}
    return out


def detection_batches(
    batch: int, cfg: PhantomConfig = PhantomConfig(), seed: int = 0, n_classes: int = 2
) -> Iterator[dict]:
    """Infinite iterator of {"image", "targets"} for the YOLO train step."""
    rng = np.random.default_rng(seed)
    while True:
        imgs, tgts = [], []
        for _ in range(batch):
            ct, _, boxes, labels = make_phantom_pair(rng, cfg)
            imgs.append(np.repeat(ct, 3, axis=-1))
            tgts.append(grid_targets(boxes, labels, cfg.img_size, n_classes=n_classes))
        targets = {
            k: {
                f: np.stack([t[k][f] for t in tgts])
                for f in ("cls", "box")
            }
            for k in ("p3", "p4", "p5")
        }
        yield {"image": np.stack(imgs), "targets": targets}


def token_batches(
    batch: int, seq_len: int, vocab: int, seed: int = 0, order: int = 2
) -> Iterator[dict]:
    """Synthetic LM stream with learnable structure: a random order-2
    Markov chain over a vocab subset (so loss decreases measurably)."""
    rng = np.random.default_rng(seed)
    sub = min(vocab, 64)
    trans = rng.integers(0, sub, size=(sub, sub, 2))  # 2 likely successors

    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        state = rng.integers(0, sub, size=(batch, 2))
        for t in range(seq_len + 1):
            choice = rng.integers(0, 2, size=batch)
            explore = rng.uniform(size=batch) < 0.05
            nxt = trans[state[:, 0], state[:, 1], choice]
            nxt = np.where(explore, rng.integers(0, sub, size=batch), nxt)
            toks[:, t] = nxt
            state = np.stack([state[:, 1], nxt], axis=1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
