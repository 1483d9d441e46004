"""The PyTorch port's fused serving blocks against the JAX package's oracles.

On the CPU ``repro_torch.kernels.fused.ops`` runs the plain versions in
``ref.py``; these pin them to ``repro.kernels.fused.ref`` on the JAX
package's own serving-block cases (f32 atol 1e-4, bf16 5e-2; SPPF
bit-exact), plus B=2 batch norm, which the CUDA kernel takes over the
whole batch. The CUDA kernels themselves run only on a card (``cuda``
marker), where they are held against the same plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused import ref as jref  # noqa: E402
from repro_torch.kernels.fused import kernel, ops  # noqa: E402
from repro_torch.kernels.fused import ref as tref  # noqa: E402

# (in_shape, kernel, stride, padding, cout, norm, act): the JAX package's
# CONV_CASES (tests/test_impl_planning.py) plus B=2 batch norm and the bare
# YOLO head conv
CONV_CASES = [
    ((1, 64, 64, 3), 4, 2, 1, 8, "none", "lrelu"),
    ((1, 32, 32, 8), 4, 2, 1, 16, "batch", "lrelu"),
    ((1, 64, 64, 3), 3, 2, 1, 16, "batch", "silu"),
    ((1, 32, 32, 16), 3, 2, 1, 32, "batch", "silu"),
    ((2, 16, 16, 8), 4, 2, 1, 16, "instance", "lrelu"),
    ((1, 16, 16, 8), 4, 2, 1, 16, "group", "lrelu"),
    ((2, 16, 16, 8), 3, 1, 1, 16, "batch", "silu"),
    ((1, 8, 8, 64), 1, 1, 0, 2, "none", "none"),
]
DECONV_CASES = [
    ((1, 4, 4, 64), 32, "batch", "relu"),
    ((1, 8, 8, 64), 16, "batch", "relu"),
    ((2, 8, 8, 16), 8, "instance", "relu"),
    ((2, 4, 4, 16), 8, "batch", "relu"),
    ((1, 8, 8, 16), 3, "none", "tanh"),
]
SPPF_CASES = [((1, 8, 8, 16), 5, 3), ((2, 4, 4, 8), 5, 3), ((1, 8, 8, 4), 3, 2)]
DTYPES = [(np.float32, torch.float32, jnp.float32, 1e-4), ("bf16", torch.bfloat16, jnp.bfloat16, 5e-2)]


def _inputs(shape, cin, cout, k, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32)
    gamma = np.full((cout,), 1.1, np.float32)
    beta = np.full((cout,), 0.05, np.float32)
    return x, w, b, gamma, beta


def _both(x, tdt, jdt):
    """The same values in both frameworks (both round f32 -> bf16 to nearest even)."""
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,k,stride,pad,cout,norm,act", CONV_CASES)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_conv_block_plain_matches_jax_ref(shape, k, stride, pad, cout, norm, act, dt):
    _, tdt, jdt, atol = dt
    x, w, b, gamma, beta = _inputs(shape, shape[-1], cout, k)
    xt, xj = _both(x, tdt, jdt)
    groups = 4 if norm == "group" else 1
    kw = dict(stride=stride, padding=pad, norm=norm, groups=groups, act=act)
    got = ops.conv_block(xt, *map(torch.from_numpy, (w, b, gamma, beta)), **kw)
    want = jref.conv_block_ref(xj, *map(jnp.asarray, (w, b, gamma, beta)), **kw)
    assert got.dtype == tdt and got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


@pytest.mark.parametrize("shape,cout,norm,act", DECONV_CASES)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_deconv_block_plain_matches_jax_ref(shape, cout, norm, act, dt):
    _, tdt, jdt, atol = dt
    x, w, b, gamma, beta = _inputs(shape, shape[-1], cout, 4)
    xt, xj = _both(x, tdt, jdt)
    got = ops.deconv_block(xt, *map(torch.from_numpy, (w, b, gamma, beta)), norm=norm, act=act)
    want = jref.deconv_block_ref(xj, *map(jnp.asarray, (w, b, gamma, beta)), norm=norm, act=act)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


@pytest.mark.parametrize("shape,window,reps", SPPF_CASES)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_sppf_pyramid_plain_bit_exact_vs_jax_ref(shape, window, reps, dt):
    _, tdt, jdt, _ = dt
    xt, xj = _both(np.random.RandomState(0).randn(*shape).astype(np.float32), tdt, jdt)
    got = ops.sppf_pyramid(xt, window=window, reps=reps)
    want = jref.sppf_pyramid_ref(xj, window=window, reps=reps)
    assert tuple(got.shape) == shape[:-1] + ((reps + 1) * shape[-1],) and got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_deconv_weight_orientation_asymmetric_kernel():
    """An asymmetric kernel pins the flip between lax.conv_transpose (no
    flip) and F.conv_transpose2d (flips): without it the error is O(1)."""
    x, w, b, gamma, beta = _inputs((1, 3, 5, 4), 4, 3, 4, seed=3)
    w[0, 0] += 5.0  # one corner tap dominates
    got = ops.deconv_block(*map(torch.from_numpy, (x, w, b)), norm="none", act="none")
    want = jref.deconv_block_ref(*map(jnp.asarray, (x, w, b, gamma, beta)), norm="none", act="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_dispatch_takes_plain_version_without_counting():
    ops.reset_launches()
    x = torch.randn(1, 8, 8, 4)
    ops.conv_block(x, torch.randn(3, 3, 4, 8), padding=1)
    ops.deconv_block(x, torch.randn(4, 4, 4, 8))
    ops.sppf_pyramid(x)
    assert ops.launches == {"conv_block": 0, "deconv_block": 0, "sppf_pyramid": 0}


def test_ops_reject_what_the_kernels_do_not_take():
    x = torch.randn(1, 8, 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv_block(x.permute(0, 2, 1, 3), torch.randn(3, 3, 4, 8))
    with pytest.raises(ValueError):
        ops.conv_block(x, torch.randn(3, 3, 5, 8))  # Cin mismatch
    with pytest.raises(ValueError):
        ops.conv_block(x, torch.randn(3, 3, 4, 6), norm="group", groups=4)
    with pytest.raises(ValueError):
        ops.deconv_block(x, torch.randn(3, 3, 4, 8))  # not k=4
    with pytest.raises(ValueError):
        ops.conv_block(x, torch.randn(3, 3, 4, 8), act="gelu")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.conv_block_cuda(
            x, torch.randn(3, 3, 4, 8), *(torch.zeros(8),) * 3, stride=1, padding=1,
            norm="none", groups=1, act="none", eps=1e-5, deconv=False,
        )


@pytest.mark.parametrize(
    "rows,cout,k_total",
    [(1, 512, 8192), (4, 512, 8192), (4, 512, 2048), (16384, 64, 48), (16, 2, 64)],
)
def test_gemm_split_covers_k_exactly_once(rows, cout, k_total):
    """The conv GEMM's split of K (``conv_geometry``; deconv_block's is
    ``deconv.kernel.phase_geometry``'s, pinned in test_torch_deconv*.py),
    for a k x k conv whose every tap is live (stride 1, ``same`` padding,
    ``rows`` output pixels as one row of a batch): the splits cover the
    live K tiles with none empty; wide layers take no split; per block,
    ``test_torch_conv_tc.py``."""
    k = 4 if k_total >= 16 * 512 else 1
    cin = k_total // (k * k)
    pad = k // 2 if k > 1 else 0
    for esize in (4, 2):
        geo = kernel.conv_geometry(1, 1, rows, cin, cout, k, 1, pad, esize)
        nkt = kernel.conv_live_k_tiles(1, rows, cin, k, 1, pad, 128 // esize)
        assert geo.splitk >= 1 and (geo.splitk - 1) * geo.per < nkt <= geo.splitk * geo.per  # no empty split, no gap
        if rows * cout >= 64 * 64 * 264:
            assert geo.splitk == 1


@pytest.mark.parametrize("rows,cout,sets", [(16384, 64, 1), (4, 512, 1), (1, 512, 1), (64, 16, 2)])
def test_stats_chunks_cover_rows(rows, cout, sets):
    chunks = kernel.stats_chunks(rows, cout, sets)
    per = -(-rows // chunks)
    assert chunks >= 1 and (chunks - 1) * per < rows <= chunks * per


def test_sppf_channel_tile_fits_shared_memory():
    """The SPPF kernel's tiles: at YOLOv8's served shape the grid reaches
    one block per SM of an H100 (132), at the 640-pixel input's (1, 20,
    20, 256) the two planes of a block's rows and halo fit the default 48
    KB, and a tile never has more lanes than channels."""
    def blocks(B, H, W, C):
        ct, rb = kernel.sppf_geometry(B, H, W, C)
        return B * -(-C // ct) * -(-H // rb)

    assert kernel.sppf_geometry(1, 8, 8, 128) == (4, 1) and blocks(1, 8, 8, 128) >= 132
    ct, rb = kernel.sppf_geometry(1, 20, 20, 256)
    assert kernel.sppf_smem_bytes(20, 20, ct, rb, halo=6) <= 48 * 1024 and blocks(1, 20, 20, 256) >= 132
    assert kernel.sppf_geometry(1, 8, 8, 4)[0] <= 4
    with pytest.raises(ValueError, match="does not fit"):
        kernel.sppf_geometry(1, 8, 4096, 8)


def emulate_sppf(x, window, reps):
    """The SPPF kernel in plain torch: per band of ``sppf_geometry``'s rb
    output rows, the region of the band and its halo (clipped to the map),
    each level a window-wide row max (taps left to right) then a
    window-tall column max (taps top to bottom) over the region alone, in
    the kernel's compare rule (take v when v > m or v is NaN). Channels are
    independent, so the channel tile does not enter."""
    B, H, W, C = x.shape
    _, rb = kernel.sppf_geometry(B, H, W, C, window, reps)
    pad = window // 2
    neg = torch.tensor(-float("inf"))

    def pool(cur, dim):
        n = cur.shape[dim]
        m = torch.full_like(cur, -float("inf"))
        for d in range(-pad, pad + 1):
            idx = torch.arange(n) + d
            ok = ((idx >= 0) & (idx < n)).view([-1 if i == dim else 1 for i in range(cur.dim())])
            v = torch.where(ok, cur.index_select(dim, idx.clamp(0, n - 1)), neg)
            m = torch.where((v > m) | torch.isnan(v), v, m)
        return m

    out = torch.empty(B, H, W, (reps + 1) * C, dtype=x.dtype)
    out[..., :C] = x
    for h0 in range(0, H, rb):
        h1 = min(H, h0 + rb)
        lo, hi = max(0, h0 - reps * pad), min(H, h1 + reps * pad)
        cur = x[:, lo:hi].float()
        for level in range(1, reps + 1):
            cur = pool(pool(cur, 2), 1)
            out[:, h0:h1, :, level * C : (level + 1) * C] = cur[:, h0 - lo : h1 - lo].to(x.dtype)
    return out


@pytest.mark.parametrize("shape,window,reps", SPPF_CASES + [((1, 8, 8, 128), 5, 3), ((1, 20, 20, 256), 5, 3)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_sppf_kernel_order_bit_exact_vs_jax_ref(shape, window, reps, dt):
    """The kernel's separable cascade, bands and halo emulated, against
    ``repro``'s ``sppf_pyramid_ref`` with NaN and -inf planted in the
    input (a -inf row too): equal bit for bit, NaNs where the reference has
    them."""
    _, tdt, jdt, _ = dt
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rs.permutation(flat.size)[: max(2, flat.size // 50)]
    flat[picks[: len(picks) // 2]] = np.nan
    flat[picks[len(picks) // 2 :]] = -np.inf
    x[:, shape[1] // 2] = -np.inf
    xt, xj = _both(x, tdt, jdt)
    got = _f32(emulate_sppf(xt, window, reps))
    want = _f32(jref.sppf_pyramid_ref(xj, window=window, reps=reps))
    assert got.shape == want.shape and np.isnan(want).any() and np.isneginf(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))


def _smoke():
    """``chip_smoke.py`` as a module (its work sits behind ``__main__``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (H, W, k, stride, pad, transposed): the spatial shapes of chip_smoke's
# shape classes (Pix2Pix down0/down1/bottleneck, YOLOv8 stem/1x1/head/3x3,
# the up blocks, SPPF's 5x5 pool) plus non-square ones
TAP_CASES = [
    (256, 256, 4, 2, 1, False), (128, 128, 4, 2, 1, False), (2, 2, 4, 2, 1, False),
    (256, 256, 3, 2, 1, False), (64, 64, 1, 1, 0, False), (32, 32, 3, 1, 1, False),
    (8, 8, 5, 1, 2, False), (2, 3, 4, 2, 1, False), (1, 1, 4, 2, 1, True),
    (64, 64, 4, 2, 1, True), (1, 3, 4, 2, 1, True),
]


@pytest.mark.parametrize("H,W,k,stride,pad,transposed", TAP_CASES)
def test_smoke_bound_counts_only_real_taps(H, W, k, stride, pad, transposed):
    """chip_smoke's bound against a brute-force count: a conv of ones
    over ones gives the real taps per output, and its gradients mark the
    kernel offsets and the inputs those taps touch."""
    import torch.nn.functional as F

    smoke = _smoke()
    cin, cout = 3, 5
    x1 = torch.ones(1, 1, H, W, dtype=torch.float64, requires_grad=True)
    w1 = torch.ones(1, 1, k, k, dtype=torch.float64, requires_grad=True)
    if transposed:
        y = F.conv_transpose2d(x1, w1, stride=stride, padding=pad)
    else:
        y = F.conv2d(x1, w1, stride=stride, padding=pad)
    y.sum().backward()
    taps, offsets, inputs = int(y.sum()), int((w1.grad > 0).sum()), int((x1.grad > 0).sum())
    th, kh, ih = smoke.taps_1d(H, y.shape[2], k, stride, pad, transposed)
    tw, kw, iw = smoke.taps_1d(W, y.shape[3], k, stride, pad, transposed)
    assert (th * tw, kh * kw, ih * iw) == (taps, offsets, inputs)
    if transposed:
        assert tuple(y.shape[2:]) == (2 * H, 2 * W)  # the crop is folded in

    a = dict(x=torch.zeros(1, H, W, cin), w=torch.zeros(k, k, cin, cout), gamma=torch.zeros(cout),
             stride=stride, padding=pad, norm="batch", act="relu")
    bytes_ms, ops_ms = smoke.bound("deconv_block" if transposed else "conv_block", a, bias=False)
    out = y.numel() * cout
    want_bytes = 4 * (inputs * cin + offsets * cin * cout + out + 2 * cout)
    want_ops = 2 * cin * cout * taps + out * (7 + 1)
    assert bytes_ms == pytest.approx(want_bytes / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert ops_ms == pytest.approx(want_ops / smoke.FP32_ACCURATE_FLOPS * 1e3, rel=1e-12)


@pytest.mark.parametrize("shape,window,reps", SPPF_CASES + [((1, 8, 8, 128), 5, 3)])
def test_sppf_bound_counts_a_separable_pool(shape, window, reps):
    """``chip_smoke.bound`` for SPPF: the input read and the (reps + 1)-wide
    concat written once, and per level the maxes of a row pass and a
    column pass over the taps inside the map (one max per tap beyond the
    first), counted here pixel by pixel."""
    smoke = _smoke()
    B, H, W, C = shape
    pad = window // 2
    row = sum(min(W, w + pad + 1) - max(0, w - pad) - 1 for h in range(H) for w in range(W))
    col = sum(min(H, h + pad + 1) - max(0, h - pad) - 1 for h in range(H) for w in range(W))
    bytes_ms, ops_ms = smoke.bound("sppf_pyramid", dict(x=torch.zeros(shape), window=window, reps=reps))
    assert bytes_ms == pytest.approx(4 * B * H * W * C * (reps + 2) / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert ops_ms == pytest.approx(reps * B * C * (row + col) / smoke.FP32_OPS_SIMPLE * 1e3, rel=1e-12)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_card():
    """Each kernel against its plain version on the card (TF32 off), conv
    and deconv blocks in f32 (1e-4) and bf16 (5e-2, the JAX package's pin);
    the conv cases add the 2x2 -> 1x1 bottleneck (4 of 16 taps live, K
    split), Cin 16 (two taps per f32 K tile) and a 7x7 kernel on a 2x2 map
    (49 taps, past the block vote, 4 reaching the input), the deconv cases a Cin % 32
    != 0 case off the 16-byte staging, a wide split-K case, the Cout-3 layer
    at batch 8 and a Cout-4 layer with a norm (the GEMM, not the narrow
    kernel, in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ops.reset_launches()
    conv_cases = CONV_CASES + [
        ((1, 2, 2, 512), 4, 2, 1, 512, "batch", "lrelu"), ((1, 64, 64, 16), 3, 1, 1, 32, "batch", "silu"),
        ((1, 2, 2, 64), 7, 2, 3, 64, "none", "lrelu"),
    ]
    deconv_cases = DECONV_CASES + [
        ((2, 8, 8, 40), 64, "batch", "relu"), ((1, 16, 16, 1024), 256, "batch", "relu"),
        ((8, 128, 128, 128), 3, "none", "tanh"), ((1, 8, 8, 16), 4, "batch", "relu"),
    ]
    for tdt, atol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        for shape, k, stride, pad, cout, norm, act in conv_cases:
            x, w, b, gamma, beta = (torch.from_numpy(a).to(dev) for a in _inputs(shape, shape[-1], cout, k))
            x = x.to(tdt)
            kw = dict(stride=stride, padding=pad, norm=norm, groups=4 if norm == "group" else 1, act=act)
            got = ops.conv_block(x, w, b, gamma, beta, **kw)
            want = tref.conv_block_ref(x, w, b, gamma, beta, **kw)
            assert got.dtype == tdt
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
        for shape, cout, norm, act in deconv_cases:
            x, w, b, gamma, beta = (torch.from_numpy(a).to(dev) for a in _inputs(shape, shape[-1], cout, 4))
            x = x.to(tdt)
            got = ops.deconv_block(x, w, b, gamma, beta, norm=norm, act=act)
            want = tref.deconv_block_ref(x, w, b, gamma, beta, norm=norm, act=act)
            assert got.dtype == tdt
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for shape, window, reps in SPPF_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device=dev).to(dtype)
            got = ops.sppf_pyramid(x, window=window, reps=reps)
            assert torch.equal(got, tref.sppf_pyramid_ref(x, window=window, reps=reps))
    torch.cuda.synchronize()
    assert ops.launches == {
        "conv_block": 2 * len(conv_cases),
        "deconv_block": 2 * len(deconv_cases),
        "sppf_pyramid": 2 * len(SPPF_CASES),
    }
