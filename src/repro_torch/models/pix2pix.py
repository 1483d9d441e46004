"""Pix2Pix (Isola et al., CVPR'17) — U-Net generator + PatchGAN discriminator,
following the TF tutorial architecture the paper uses ([27], Fig. 5):
8 downsample blocks / 7 upsample blocks + final deconv, generator params
54,425,859 for 3-channel I/O (matches paper Table II exactly).

``deconv_mode`` selects the paper's hardware-aware variants:
  * "padded"   — original: transposed conv with torch padding=1 (ONE fused
                 op; violates the DLA-analogue 'deconv padding must be zero').
  * "cropping" — pad-free deconv + Crop2D(1). Numerically IDENTICAL to
                 "padded" (paper eq. 5+7 == eq. 6); engine-legal.
  * "conv"     — pad-free deconv + 3x3 VALID conv (paper eq. 8/9): adds
                 parameters (64,637,268 — Table II) and capacity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..core.graph import LayerGraph, conv_meta, pointwise_meta
from ..nn import (
    BatchNorm2D,
    Conv2D,
    ConvTranspose2D,
    Crop2D,
    GroupNorm2D,
    InstanceNorm2D,
    Module,
    leaky_relu,
)
from ..kernels.deconv import ops as deconv_ops

DOWN_CHANNELS = (64, 128, 256, 512, 512, 512, 512, 512)
UP_CHANNELS = (512, 512, 512, 512, 256, 128, 64)


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    name: str = "pix2pix"
    img_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    deconv_mode: str = "padded"  # padded | cropping | conv
    deconv_backend: str = "xla"  # "xla" | "pallas" (phase-decomposed kernel)
    # "batch" is the TF-tutorial original (batch stats at inference too);
    # "instance"/"group" are batch-independent, so merged micro-batches
    # (serve.StreamExecutor merge_batches) leave every frame's math intact
    norm: str = "batch"  # batch | instance | group
    norm_groups: int = 8
    base: int = 64
    dropout_rate: float = 0.5
    lambda_l1: float = 100.0
    act_dtype: Any = torch.float32

    @property
    def batch_independent(self) -> bool:
        """True when per-frame outputs do not depend on batch companions."""
        return self.norm in ("instance", "group")

    def norm2d(self, ch: int):
        if self.norm == "batch":
            return BatchNorm2D(ch)
        if self.norm == "instance":
            return InstanceNorm2D(ch)
        if self.norm == "group":
            return GroupNorm2D(ch, groups=math.gcd(self.norm_groups, ch))
        raise ValueError(f"unknown norm {self.norm!r} (want batch|instance|group)")

    @property
    def n_downs(self):
        # downsample to 1x1 bottleneck (8 blocks at 256; fewer on smoke sizes)
        return int(math.log2(self.img_size))

    def down_channels(self):
        b = self.base
        return tuple(min(8 * b, b * (2**i)) for i in range(self.n_downs))

    def up_channels(self):
        return tuple(reversed(self.down_channels()[:-1]))


@dataclasses.dataclass(frozen=True)
class UpBlockDeconv(Module):
    """One upsampling stage in the configured deconv mode.

    ``backend="pallas"`` routes padded/cropping modes through the
    hand-written deconv kernel (``kernels.deconv``) — one op, crop folded
    into its indexing (the plain version on CPU tensors)."""

    c_in: int
    c_out: int
    mode: str
    use_bias: bool = False  # TF tutorial: final output deconv carries a bias
    backend: str = "xla"

    def specs(self):
        pad = 1 if self.mode == "padded" else 0
        s = {"deconv": ConvTranspose2D(self.c_in, self.c_out, 4, 2, padding=pad, use_bias=self.use_bias)}
        if self.mode == "conv":
            s["conv"] = Conv2D(self.c_out, self.c_out, 3, 1, padding=0, use_bias=False)
        return s

    def __call__(self, p, x):
        if self.backend == "pallas" and self.mode in ("padded", "cropping"):
            b = p["deconv"].get("b") if self.use_bias else None
            return deconv_ops.deconv2d(x, p["deconv"]["w"], b=b, stride=2, padding=1)
        if self.mode == "padded":
            return ConvTranspose2D(self.c_in, self.c_out, 4, 2, padding=1, use_bias=self.use_bias)(p["deconv"], x)
        y = ConvTranspose2D(self.c_in, self.c_out, 4, 2, padding=0, use_bias=self.use_bias)(p["deconv"], x)
        if self.mode == "cropping":
            return Crop2D(1)(None, y)
        return Conv2D(self.c_out, self.c_out, 3, 1, padding=0, use_bias=False)(p["conv"], y)


@dataclasses.dataclass(frozen=True)
class Pix2PixGenerator(Module):
    cfg: Pix2PixConfig

    def specs(self):
        c = self.cfg
        downs = []
        c_prev = c.in_channels
        for i, ch in enumerate(c.down_channels()):
            blk = {"conv": Conv2D(c_prev, ch, 4, 2, padding=1, use_bias=False)}
            if i != 0:
                blk["bn"] = c.norm2d(ch)
            downs.append(blk)
            c_prev = ch
        ups = []
        for i, ch in enumerate(c.up_channels()):
            blk = {"up": UpBlockDeconv(c_prev, ch, c.deconv_mode, backend=c.deconv_backend), "bn": c.norm2d(ch)}
            ups.append(blk)
            c_prev = ch * 2  # skip concat
        final = UpBlockDeconv(c_prev, c.out_channels, c.deconv_mode, use_bias=True, backend=c.deconv_backend)
        return {"downs": downs, "ups": ups, "final": final}

    def __call__(self, p, x, generator=None, train=False):
        """``train=True`` with a ``torch.Generator`` (on x's device) applies
        the dropout of up blocks 0-2, drawn from ``generator``; the JAX
        package draws it from its ``rng`` key, so the two masks differ."""
        c = self.cfg
        x = x.to(c.act_dtype)
        skips = []
        c_prev = c.in_channels
        for i, ch in enumerate(c.down_channels()):
            x = Conv2D(c_prev, ch, 4, 2, padding=1, use_bias=False)(p["downs"][i]["conv"], x)
            if i != 0:
                x = c.norm2d(ch)(p["downs"][i]["bn"], x)
            x = leaky_relu(x)
            skips.append(x)
            c_prev = ch
        skips = skips[:-1][::-1]
        for i, ch in enumerate(c.up_channels()):
            x = UpBlockDeconv(c_prev, ch, c.deconv_mode, backend=c.deconv_backend)(p["ups"][i]["up"], x)
            x = c.norm2d(ch)(p["ups"][i]["bn"], x)
            if train and i < 3 and generator is not None:
                keep = 1.0 - c.dropout_rate
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, 0.0).to(x.dtype)
            x = F.relu(x)
            x = torch.cat([x, skips[i]], dim=-1)
            c_prev = ch * 2
        x = UpBlockDeconv(c_prev, c.out_channels, c.deconv_mode, use_bias=True, backend=c.deconv_backend)(p["final"], x)
        return torch.tanh(x)

    # ---- layer graph for the scheduler ----------------------------------------
    def layer_graph(self, batch: int = 1, dtype_bytes: int = 2) -> LayerGraph:
        c = self.cfg
        layers = []
        idx = 0

        def add(meta):
            nonlocal idx
            meta.idx = idx
            layers.append(meta)
            idx += 1

        # (start_idx, span, kind, norm, act) of each pallas_fused block
        fuse_groups: list[tuple[int, int, str, str, str]] = []

        h = c.img_size
        c_prev = c.in_channels
        for i, ch in enumerate(c.down_channels()):
            fuse_groups.append((idx, 2 if i == 0 else 3, "conv", "none" if i == 0 else c.norm, "lrelu"))
            add(conv_meta(idx, f"down{i}.conv", batch, h, h, c_prev, ch, 4, 2, 1, dtype_bytes))
            h //= 2
            if i != 0:
                add(pointwise_meta(idx, f"down{i}.bn", "bn", (batch, h, h, ch), dtype_bytes, 2.0, 2 * ch))
            add(pointwise_meta(idx, f"down{i}.lrelu", "act", (batch, h, h, ch), dtype_bytes))
            c_prev = ch

        def add_up(i, name, ch, h, c_prev):
            if c.deconv_mode == "padded":
                add(conv_meta(idx, f"{name}.deconv", batch, h, h, c_prev, ch, 4, 2, 1, dtype_bytes, transposed=True))
                return 2 * h
            add(conv_meta(idx, f"{name}.deconv", batch, h, h, c_prev, ch, 4, 2, 0, dtype_bytes, transposed=True))
            if c.deconv_mode == "cropping":
                add(
                    pointwise_meta(idx, f"{name}.crop", "crop", (batch, 2 * h, 2 * h, ch), dtype_bytes, 0.0)
                )
            else:
                add(conv_meta(idx, f"{name}.conv", batch, 2 * h + 2, 2 * h + 2, ch, ch, 3, 1, 0, dtype_bytes))
            return 2 * h

        # deconv spans: padded fuses deconv+bn+relu, cropping also folds the
        # crop; "conv" mode's 3x3 refine has no fused kernel -> downs only
        up_span = {"padded": 2, "cropping": 3}.get(c.deconv_mode, 0)
        for i, ch in enumerate(c.up_channels()):
            if up_span:
                fuse_groups.append((idx, up_span + 1, "deconv", c.norm, "relu"))
            h = add_up(i, f"up{i}", ch, h, c_prev)
            add(pointwise_meta(idx, f"up{i}.bn", "bn", (batch, h, h, ch), dtype_bytes, 2.0, 2 * ch))
            add(pointwise_meta(idx, f"up{i}.relu", "act", (batch, h, h, ch), dtype_bytes))
            add(pointwise_meta(idx, f"up{i}.concat", "concat", (batch, h, h, 2 * ch), dtype_bytes, 0.0))
            c_prev = ch * 2
        if up_span:
            fuse_groups.append((idx, up_span, "deconv", "none", "tanh"))
        h = add_up(7, "final", c.out_channels, h, c_prev)
        add(pointwise_meta(idx, "tanh", "tanh", (batch, h, h, c.out_channels), dtype_bytes))

        # mark pallas_fused blocks: lead layer carries the fused analytic
        # totals (in + out + params only — the intermediate activations
        # never round-trip through HBM), folded members point back at it
        for lo, span, kind, norm, act in fuse_groups:
            members = layers[lo : lo + span]
            fused_bytes = dtype_bytes * (
                math.prod(members[0].in_shape) + math.prod(members[-1].out_shape)
            ) + 4.0 * sum(m.params for m in members)
            layers[lo].attrs["fuse"] = {
                "span": span,
                "flops": sum(m.flops for m in members),
                "bytes": fused_bytes,
                "kind": kind,
                "norm": norm,
                "act": act,
            }
            for m in members[1:]:
                m.attrs["fused_into"] = members[0].name

        g = LayerGraph(f"{c.name}.G[{c.deconv_mode}]", layers)
        # skip tensors stay live across the bottleneck: widen boundary bytes
        # (a partition between down_i and up_{7-i} must also move the skips)
        return g.renumber()


def generator_ops(cfg: Pix2PixConfig, impl: str = "xla"):
    """Per-layer executable ops aligned 1:1 with ``layer_graph`` indices.

    Each op is ``(name, fn)`` with ``fn(params, state) -> state`` where
    ``state = {"x": activations, "skips": [...]}``. Slicing this list at the
    scheduler's partition points yields runnable engine segments; composing
    all ops reproduces ``Pix2PixGenerator.__call__`` exactly (property-
    tested). The state dict (x + live skips) is what crosses a partition —
    matching ``LayerMeta.boundary_bytes`` accounting.

    ``impl="pallas_fused"`` returns the same-length list with each fused
    block (the graph's ``attrs["fuse"]`` groups) collapsed onto its lead op
    — one ``kernels.fused`` call doing conv/deconv+norm+act in a single
    kernel — and the folded members replaced by identity ops. Cut points
    interior to a fused block simply see the already-final activations.
    """
    ops = []
    c_prev = cfg.in_channels
    downs = list(enumerate(cfg.down_channels()))
    n_ups = len(cfg.up_channels())

    def mk_down_conv(i, ci, co):
        def f(p, s):
            s = dict(s)
            s["x"] = Conv2D(ci, co, 4, 2, padding=1, use_bias=False)(p["downs"][i]["conv"], s["x"])
            return s

        return f

    def mk_down_bn(i, ch):
        def f(p, s):
            s = dict(s)
            s["x"] = cfg.norm2d(ch)(p["downs"][i]["bn"], s["x"])
            return s

        return f

    def mk_down_act():
        def f(p, s):
            s = dict(s)
            s["x"] = leaky_relu(s["x"])
            s["skips"] = s["skips"] + [s["x"]]
            return s

        return f

    for i, ch in downs:
        ops.append((f"down{i}.conv", mk_down_conv(i, c_prev, ch)))
        if i != 0:
            ops.append((f"down{i}.bn", mk_down_bn(i, ch)))
        ops.append((f"down{i}.lrelu", mk_down_act()))
        c_prev = ch

    def up_params(p, i):
        return p["final"] if i == n_ups else p["ups"][i]["up"]

    def mk_deconv(i, ci, co, bias):
        pad = 1 if cfg.deconv_mode == "padded" else 0

        def f(p, s):
            s = dict(s)
            pp = up_params(p, i)
            s["x"] = ConvTranspose2D(ci, co, 4, 2, padding=pad, use_bias=bias)(pp["deconv"], s["x"])
            return s

        return f

    def mk_crop():
        def f(p, s):
            s = dict(s)
            s["x"] = Crop2D(1)(None, s["x"])
            return s

        return f

    def mk_upconv(i, co):
        def f(p, s):
            s = dict(s)
            pp = up_params(p, i)
            s["x"] = Conv2D(co, co, 3, 1, padding=0, use_bias=False)(pp["conv"], s["x"])
            return s

        return f

    def mk_up_bn(i, ch):
        def f(p, s):
            s = dict(s)
            s["x"] = cfg.norm2d(ch)(p["ups"][i]["bn"], s["x"])
            return s

        return f

    def mk_up_relu():
        def f(p, s):
            s = dict(s)
            s["x"] = F.relu(s["x"])
            return s

        return f

    def mk_concat(skip_idx):
        def f(p, s):
            s = dict(s)
            s["x"] = torch.cat([s["x"], s["skips"][skip_idx]], dim=-1)
            return s

        return f

    skips_rev = list(range(len(downs) - 2, -1, -1))  # skip index for up i
    for i, ch in enumerate(cfg.up_channels()):
        ops.append((f"up{i}.deconv", mk_deconv(i, c_prev, ch, False)))
        if cfg.deconv_mode == "cropping":
            ops.append((f"up{i}.crop", mk_crop()))
        elif cfg.deconv_mode == "conv":
            ops.append((f"up{i}.conv", mk_upconv(i, ch)))
        ops.append((f"up{i}.bn", mk_up_bn(i, ch)))
        ops.append((f"up{i}.relu", mk_up_relu()))
        ops.append((f"up{i}.concat", mk_concat(skips_rev[i])))
        c_prev = ch * 2

    ops.append(("final.deconv", mk_deconv(n_ups, c_prev, cfg.out_channels, True)))
    if cfg.deconv_mode == "cropping":
        ops.append(("final.crop", mk_crop()))
    elif cfg.deconv_mode == "conv":
        ops.append(("final.conv", mk_upconv(n_ups, cfg.out_channels)))

    def mk_tanh():
        def f(p, s):
            s = dict(s)
            s["x"] = torch.tanh(s["x"])
            return s

        return f

    ops.append(("tanh", mk_tanh()))
    if impl == "xla":
        return ops
    if impl != "pallas_fused":
        raise ValueError(f"unknown impl {impl!r} (want xla|pallas_fused)")

    from ..kernels.fused.ops import conv_block, deconv_block

    pos = {name: k for k, (name, _) in enumerate(ops)}

    def identity(p, s):
        return s

    def norm_groups(ch):
        return math.gcd(cfg.norm_groups, ch) if cfg.norm == "group" else 1

    def mk_down_fused(i, ch):
        def f(p, s):
            s = dict(s)
            blk = p["downs"][i]
            bn = blk.get("bn")
            s["x"] = conv_block(
                s["x"].contiguous(),
                blk["conv"]["w"],
                gamma=None if bn is None else bn["scale"],
                beta=None if bn is None else bn["bias"],
                stride=2,
                padding=1,
                norm="none" if bn is None else cfg.norm,
                groups=norm_groups(ch),
                act="lrelu",
            )
            s["skips"] = s["skips"] + [s["x"]]
            return s

        return f

    def mk_up_fused(i, ch):
        def f(p, s):
            s = dict(s)
            bn = p["ups"][i]["bn"]
            s["x"] = deconv_block(
                s["x"].contiguous(),
                up_params(p, i)["deconv"]["w"],
                gamma=bn["scale"],
                beta=bn["bias"],
                norm=cfg.norm,
                groups=norm_groups(ch),
                act="relu",
            )
            return s

        return f

    def mk_final_fused():
        def f(p, s):
            s = dict(s)
            pp = up_params(p, n_ups)["deconv"]
            s["x"] = deconv_block(s["x"].contiguous(), pp["w"], b=pp["b"], norm="none", act="tanh")
            return s

        return f

    def fold(lead, fused_fn, *folded):
        ops[pos[lead]] = (lead, fused_fn)
        for name in folded:
            ops[pos[name]] = (name, identity)

    for i, ch in downs:
        folded = ([f"down{i}.bn"] if i != 0 else []) + [f"down{i}.lrelu"]
        fold(f"down{i}.conv", mk_down_fused(i, ch), *folded)
    if cfg.deconv_mode in ("padded", "cropping"):
        crop = ["crop"] if cfg.deconv_mode == "cropping" else []
        for i, ch in enumerate(cfg.up_channels()):
            folded = [f"up{i}.{t}" for t in crop + ["bn", "relu"]]
            fold(f"up{i}.deconv", mk_up_fused(i, ch), *folded)
        fold("final.deconv", mk_final_fused(), *[f"final.{t}" for t in crop], "tanh")
    return ops


@dataclasses.dataclass(frozen=True)
class Pix2PixDiscriminator(Module):
    """70x70 PatchGAN on concat(condition, image) — 6 input channels."""

    cfg: Pix2PixConfig

    def specs(self):
        c = self.cfg
        ci = c.in_channels + c.out_channels
        return {
            "c1": Conv2D(ci, 64, 4, 2, padding=1, use_bias=False),
            "c2": Conv2D(64, 128, 4, 2, padding=1, use_bias=False),
            "bn2": BatchNorm2D(128),
            "c3": Conv2D(128, 256, 4, 2, padding=1, use_bias=False),
            "bn3": BatchNorm2D(256),
            "c4": Conv2D(256, 512, 4, 1, padding=0, use_bias=False),  # zero-pad then VALID
            "bn4": BatchNorm2D(512),
            "c5": Conv2D(512, 1, 4, 1, padding=0, use_bias=True),
        }

    def __call__(self, p, x, y):
        c = self.cfg
        h = torch.cat([x, y], dim=-1).to(c.act_dtype)
        ci = c.in_channels + c.out_channels
        h = leaky_relu(Conv2D(ci, 64, 4, 2, padding=1, use_bias=False)(p["c1"], h))
        h = Conv2D(64, 128, 4, 2, padding=1, use_bias=False)(p["c2"], h)
        h = leaky_relu(BatchNorm2D(128)(p["bn2"], h))
        h = Conv2D(128, 256, 4, 2, padding=1, use_bias=False)(p["c3"], h)
        h = leaky_relu(BatchNorm2D(256)(p["bn3"], h))
        h = F.pad(h, (0, 0, 1, 1, 1, 1))
        h = Conv2D(256, 512, 4, 1, padding=0, use_bias=False)(p["c4"], h)
        h = leaky_relu(BatchNorm2D(512)(p["bn4"], h))
        h = F.pad(h, (0, 0, 1, 1, 1, 1))
        return Conv2D(512, 1, 4, 1, padding=0, use_bias=True)(p["c5"], h)


@dataclasses.dataclass(frozen=True)
class Pix2Pix(Module):
    cfg: Pix2PixConfig

    def specs(self):
        return {
            "generator": Pix2PixGenerator(self.cfg),
            "discriminator": Pix2PixDiscriminator(self.cfg),
        }

    def generate(self, p, x, generator=None, train=False):
        return Pix2PixGenerator(self.cfg)(p["generator"], x, generator=generator, train=train)

    def discriminate(self, p, x, y):
        return Pix2PixDiscriminator(self.cfg)(p["discriminator"], x, y)

    def layer_graph(self, batch: int = 1, dtype_bytes: int = 2) -> LayerGraph:
        return Pix2PixGenerator(self.cfg).layer_graph(batch, dtype_bytes)
