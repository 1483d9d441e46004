"""The arithmetic and the launch geometry of ``conv_block``'s tensor-core
GEMM (``conv_gemm_kernel`` in ``repro_torch/kernels/fused/csrc/
fused_blocks.cu``), emulated in plain torch on the CPU and held against the
plain version, ``conv_block_ref``.

The GEMM is the phase GEMM's K loop (``phase_gemm.cuh``) over a conv's tap
map: M = B*Ho*Wo rows, K = k*k*Cin in tap-major order (tap di*k + dj, then
channel), output row (oh, ow) reading input (oh*s - p + di, ow*s - p + dj)
through tap (di, dj), zero outside. A block of ``tile_rows`` rows votes on
the taps that reach an input for one of its rows and skips the 128-byte K
tiles (32 f32 or 64 bf16 channels) that hold none; ``conv_geometry``'s
``splitk`` splits take ``per`` of the block's live tiles each, summed in
order by a second pass. f32: 3xTF32 MMAs (lo.hi + hi.lo + hi.hi) rounded
toward zero, a fresh chain per K tile added in fp32; bf16: m16n8k16 MMAs in
one chain. Bias (and without a norm the act) in the epilogue, in fp32; with
a norm the GEMM writes fp32, the statistics are taken over those fp32
values, and only the normalised, activated output is rounded to bf16, as
the JAX kernel norms its fp32 accumulator.

f32 is held at the port's pin, 1e-4 (``chip_smoke.Bench.run``); bf16
against the plain bf16 version at the JAX package's 5e-2, and against the
plain version in f32 on the same (bf16) values within one bf16 ulp.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels.deconv import kernel as dk  # noqa: E402
from repro_torch.kernels.fused import kernel as fk  # noqa: E402
from repro_torch.kernels.fused.ref import _act, _norm, conv_block_ref  # noqa: E402


def tf32_rna(v):
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32)."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def rz32(v):
    """float64 -> float32 rounded toward zero: how an MMA rounds its sum."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def conv_operands(x, w, stride, pad):
    """A (B*Ho*Wo, k*k*Cin), tap-major, zeros where a tap reaches padding;
    B (k*k*Cin, Cout) = w flattened."""
    B, H, W, C = x.shape
    k = w.shape[0]
    Ho, Wo = fk.conv_out(H, k, stride, pad), fk.conv_out(W, k, stride, pad)
    xp = F.pad(x, (0, 0, pad, k, pad, k))  # input (ih, iw) at (ih + pad, iw + pad)
    cols = [xp[:, di : di + stride * Ho : stride, dj : dj + stride * Wo : stride].reshape(-1, C)
            for di in range(k) for dj in range(k)]
    return torch.cat(cols, 1), w.reshape(k * k * C, -1)


def block_live_taps(m0, rows, Ho, Wo, H, W, k, stride, pad):
    """The block's vote: the taps (di*k + dj) that reach a real input for
    some of GEMM rows m0 .. m0 + rows; every tap past ``VOTE_TAPS`` taps,
    where the kernel holds no vote."""
    if k * k > fk.VOTE_TAPS:
        return set(range(k * k))
    live = set()
    for m in range(m0, m0 + rows):
        r = m % (Ho * Wo)
        oh, ow = divmod(r, Wo)
        for di in range(k):
            for dj in range(k):
                if 0 <= oh * stride - pad + di < H and 0 <= ow * stride - pad + dj < W:
                    live.add(di * k + dj)
    return live


def block_splits(live_taps, K, cin, bk, splitk, per):
    """Each split's K tiles: the block's live tiles, ``per`` a split, in order."""
    tiles = [kt for kt in range(math.ceil(K / bk))
             if any(t in live_taps for t in range(kt * bk // cin, (min(kt * bk + bk, K) - 1) // cin + 1))]
    return [tiles[s * per : (s + 1) * per] for s in range(splitk)]


def emulate_conv_gemm(x, w, stride, pad, esize):
    """The conv GEMM's fp32 output (bias not added) for operands holding the
    kernel's inputs (bf16 values when ``esize`` is 2), block by block."""
    B, H, W, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    Ho, Wo = fk.conv_out(H, k, stride, pad), fk.conv_out(W, k, stride, pad)
    geo = fk.conv_geometry(B, H, W, cin, cout, k, stride, pad, esize)
    bk = dk.phase_bk(esize)
    A, Bm = conv_operands(x, w, stride, pad)
    K = A.shape[1]
    if esize == 4:
        ah, bh = tf32_rna(A), tf32_rna(Bm)
        pairs, step = [(tf32_rna(A - ah), bh), (ah, tf32_rna(Bm - bh)), (ah, bh)], 8
    else:
        pairs, step = [(A, Bm)], 16
    pairs = [(a.double(), b.double()) for a, b in pairs]
    M = A.shape[0]
    out = torch.empty(M, cout)
    for m0 in range(0, M, geo.tile_rows):
        rows = slice(m0, min(m0 + geo.tile_rows, M))
        live = block_live_taps(m0, rows.stop - m0, Ho, Wo, H, W, k, stride, pad)
        total = torch.zeros(rows.stop - m0, cout)
        for tiles in block_splits(live, K, cin, bk, geo.splitk, geo.per):
            acc = torch.zeros_like(total)
            for kt in tiles:
                tacc = torch.zeros_like(acc) if esize == 4 else acc
                for k0 in range(kt * bk, min(kt * bk + bk, K), step):
                    kk = slice(k0, k0 + step)
                    for a, b in pairs:
                        tacc = rz32(tacc.double() + a[rows, kk] @ b[kk])
                acc = acc + tacc if esize == 4 else tacc
            total = total + acc if geo.splitk > 1 else acc
        out[rows] = total
    return out.reshape(B, Ho, Wo, cout)


def emulate_conv_block(x, w, b, gamma, beta, stride, pad, norm, groups, act, eps=1e-5):
    """The whole call: GEMM + bias in fp32, the norm over those fp32 values,
    the act, one rounding to x's dtype at the end."""
    esize = x.element_size()
    y = emulate_conv_gemm(x.float(), w.float(), stride, pad, esize) + b
    y = _norm(y.double(), gamma.double(), beta.double(), norm=norm, groups=groups, eps=eps).float()
    return _act(y, act).to(x.dtype)


# (in_shape, k, stride, pad, cout, norm, act): the JAX package's CONV_CASES
# plus the Pix2Pix 2x2 -> 1x1 bottleneck conv (4 of 16 taps live), a K
# split, Cin 16 (two taps per f32 K tile), Cout 2 (element-staged B) and a
# 7x7 kernel on a 2x2 map (49 taps, past the vote; 4 reach the input)
CASES = [
    ((1, 32, 32, 8), 4, 2, 1, 16, "batch", "lrelu"),
    ((1, 32, 32, 3), 3, 2, 1, 16, "batch", "silu"),
    ((2, 16, 16, 8), 4, 2, 1, 16, "instance", "lrelu"),
    ((1, 16, 16, 8), 4, 2, 1, 16, "group", "lrelu"),
    ((1, 2, 2, 128), 4, 2, 1, 64, "batch", "lrelu"),
    ((1, 16, 16, 16), 3, 1, 1, 32, "batch", "silu"),
    ((1, 8, 8, 64), 1, 1, 0, 2, "none", "none"),
    ((1, 4, 4, 256), 4, 2, 1, 64, "none", "lrelu"),
    ((1, 2, 2, 64), 7, 2, 3, 64, "none", "lrelu"),
]


def _inputs(shape, k, cout, seed=0):
    rs = np.random.RandomState(seed)
    cin = shape[-1]
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy((rs.randn(k, k, cin, cout) * math.sqrt(2.0 / (k * k * cin))).astype(np.float32))
    b = torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * rs.randn(cout)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rs.randn(cout)).astype(np.float32))
    return x, w, b, gamma, beta


@pytest.mark.parametrize("shape,k,stride,pad,cout,norm,act", CASES)
def test_f32_conv_gemm_meets_the_f32_pin(shape, k, stride, pad, cout, norm, act):
    x, w, b, gamma, beta = _inputs(shape, k, cout)
    groups = 4 if norm == "group" else 1
    kw = dict(stride=stride, padding=pad, norm=norm, groups=groups, act=act)
    got = emulate_conv_block(x, w, b, gamma, beta, stride, pad, norm, groups, act)
    want = conv_block_ref(x, w, b, gamma, beta, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,k,stride,pad,cout,norm,act", CASES)
def test_bf16_epilogue_norms_the_fp32_values(shape, k, stride, pad, cout, norm, act):
    """bf16 x, w and y: within the JAX pin (5e-2) of the plain bf16 version
    (which rounds the conv output to bf16 before its norm), and within one
    bf16 ulp (2^-7 |y|) plus 1e-3 of the plain version in f32 on the same
    bf16 values: only the output is rounded."""
    x, w, b, gamma, beta = _inputs(shape, k, cout)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    groups = 4 if norm == "group" else 1
    kw = dict(stride=stride, padding=pad, norm=norm, groups=groups, act=act)
    got = emulate_conv_block(x, w, b, gamma, beta, stride, pad, norm, groups, act)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), conv_block_ref(x, w, b, gamma, beta, **kw).float(), atol=5e-2, rtol=0)
    want32 = conv_block_ref(x.float(), w.float(), b, gamma, beta, **kw)
    torch.testing.assert_close(got.float(), want32, atol=1e-3, rtol=2.0**-7)


def test_bottleneck_conv_reads_4_of_16_taps():
    """The Pix2Pix 2x2 -> 1x1 conv (k4 s2 p1): its one output reads input
    rows and columns through offsets 1 and 2 only, so 4 of the 16 taps are
    live and 3/4 of the 8192-deep K (the weight bytes) is never loaded."""
    assert fk.live_taps_1d(2, 1, 4, 2, 1) == {1, 2}
    assert block_live_taps(0, 1, 1, 1, 2, 2, 4, 2, 1) == {5, 6, 9, 10}
    bk = dk.phase_bk(4)
    assert fk.conv_live_k_tiles(2, 2, 512, 4, 2, 1, bk) == 4 * 512 // bk == 64
    geo = fk.conv_geometry(1, 2, 2, 512, 512, 4, 2, 1)
    assert geo.splitk * geo.per >= 64 > (geo.splitk - 1) * geo.per


# (B, H, W, cin, cout, k, stride, pad, esize): the served conv shapes'
# kinds (Pix2Pix stem, down blocks, bottleneck; YOLOv8 stem, 3x3 and 1x1
# layers, the head's Cout-2 conv) in both dtypes
GEO_CASES = [
    (1, 256, 256, 3, 64, 4, 2, 1, 4), (1, 128, 128, 64, 128, 4, 2, 1, 4), (1, 4, 4, 512, 512, 4, 2, 1, 4),
    (1, 2, 2, 512, 512, 4, 2, 1, 2), (1, 256, 256, 3, 16, 3, 2, 1, 2), (1, 64, 64, 16, 32, 3, 1, 1, 4),
    (1, 32, 32, 64, 2, 1, 1, 0, 4), (2, 32, 32, 64, 64, 3, 1, 1, 2), (1, 8, 8, 256, 256, 3, 1, 1, 2),
    (1, 2, 2, 64, 64, 7, 2, 3, 4), (1, 2, 2, 64, 64, 7, 2, 3, 2),
]


@pytest.mark.parametrize("B,H,W,cin,cout,k,stride,pad,esize", GEO_CASES)
def test_conv_geometry_covers_every_output_and_live_k_tile_once(B, H, W, cin, cout, k, stride, pad, esize):
    """Every output row falls in one block; each block's splits take its
    live K tiles (by the block's own vote) exactly once, none beyond
    ``per``; the layer-wide live count bounds every block's; 16-byte
    staging only where Cin and Cout hold whole 16-byte chunks."""
    geo = fk.conv_geometry(B, H, W, cin, cout, k, stride, pad, esize)
    Ho, Wo = fk.conv_out(H, k, stride, pad), fk.conv_out(W, k, stride, pad)
    M, K, bk = B * Ho * Wo, k * k * cin, dk.phase_bk(esize)
    assert geo.tile_rows in (64, 128) and (geo.tile_rows == 64 or geo.vec)
    assert geo.vec == (cin % (16 // esize) == 0 and cout % (16 // esize) == 0)
    nkt = fk.conv_live_k_tiles(H, W, cin, k, stride, pad, bk)
    assert (geo.splitk - 1) * geo.per < nkt <= geo.splitk * geo.per
    for m0 in range(0, M, geo.tile_rows):
        live = block_live_taps(m0, min(geo.tile_rows, M - m0), Ho, Wo, H, W, k, stride, pad)
        splits = block_splits(live, K, cin, bk, geo.splitk, geo.per)
        taken = [kt for s in splits for kt in s]
        assert len(taken) == len(set(taken)) <= nkt
        assert all(len(s) <= geo.per for s in splits)
        every = block_splits(live, K, cin, bk, 1, 10**9)[0]
        assert taken == every  # all of them, in order


@pytest.mark.parametrize("esize", [4, 2])
def test_past_the_vote_every_k_tile_is_split(esize):
    """A 7x7 kernel has 49 taps, more than the vote's 32 bits: the kernel
    walks every K tile, from tile ``split * per`` of split ``split``, so
    ``conv_live_k_tiles`` must count them all and the splits must reach
    the last. At 2x2 -> 1x1 (stride 2, pad 3) only taps 24, 25, 31, 32
    reach the input, and they lie past the first splits' tiles: counting
    the live tiles alone (8 f32) would sum dead taps and drop those."""
    bk = dk.phase_bk(esize)
    K = 49 * 64
    assert fk.live_taps_1d(2, 1, 7, 2, 3) == {3, 4}
    assert fk.conv_live_k_tiles(2, 2, 64, 7, 2, 3, bk) == math.ceil(K / bk)
    geo = fk.conv_geometry(1, 2, 2, 64, 64, 7, 2, 3, esize)
    walked = [kt for s in range(geo.splitk) for kt in range(s * geo.per, min((s + 1) * geo.per, math.ceil(K / bk)))]
    assert walked == list(range(math.ceil(K / bk)))
    live_tiles = {t * 64 // bk for t in (24, 25, 31, 32)}
    assert live_tiles <= set(walked)
