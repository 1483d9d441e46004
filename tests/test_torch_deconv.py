"""The PyTorch port's ``deconv2d`` against the JAX package's oracle, and the
guard that keeps every kernel out of autograd.

On the CPU ``repro_torch.kernels.deconv.ops`` runs the plain version in
``ref.py``; these pin it to ``repro.kernels.deconv.ref.deconv2d_ref`` on
the JAX package's own ``DECONV_CASES`` (f32 atol 1e-4, bf16 5e-2, the pins
of ``tests/test_kernels.py``). The CUDA kernel runs only on a card
(``cuda`` marker), where it is held against the same plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.deconv import ref as jref  # noqa: E402
from repro_torch.kernels.deconv import kernel, ops  # noqa: E402
from repro_torch.kernels.deconv import ref as tref  # noqa: E402
from repro_torch.kernels.fused import ops as fused_ops  # noqa: E402

# (B, H, W, Cin, Cout): tests/test_kernels.py's DECONV_CASES (tile_h dropped)
DECONV_CASES = [(1, 8, 8, 4, 8), (2, 16, 12, 8, 16), (1, 32, 32, 16, 8), (2, 4, 4, 3, 5)]
DTYPES = [(torch.float32, jnp.float32, 1e-4), (torch.bfloat16, jnp.bfloat16, 5e-2)]


def _inputs(B, H, W, cin, cout, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, cin).astype(np.float32)
    w = (rs.randn(4, 4, cin, cout) * 0.1).astype(np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("B,H,W,cin,cout", DECONV_CASES)
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_deconv2d_plain_matches_jax_ref(B, H, W, cin, cout, bias, dt):
    tdt, jdt, atol = dt
    x, w, b = _inputs(B, H, W, cin, cout)
    bt, bj = (torch.from_numpy(b), jnp.asarray(b)) if bias else (None, None)
    got = ops.deconv2d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), bt)
    want = jref.deconv2d_ref(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), bj)
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (B, 2 * H, 2 * W, cout)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


def test_deconv2d_orientation_asymmetric_kernel_and_other_configs():
    """An asymmetric kernel pins the flip between lax.conv_transpose (no
    flip) and F.conv_transpose2d (flips); the plain version also takes the
    configurations the card refuses, as the JAX reference does."""
    x, w, b = _inputs(1, 3, 5, 4, 3, seed=3)
    w[0, 0] += 5.0  # one corner tap dominates
    got = ops.deconv2d(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.deconv2d_ref(*map(jnp.asarray, (x, w, b)))), atol=1e-5)
    w3 = np.random.RandomState(4).randn(3, 3, 4, 2).astype(np.float32)
    for stride, padding in ((1, 0), (2, 0), (1, 1)):
        got = ops.deconv2d(torch.from_numpy(x), torch.from_numpy(w3), stride=stride, padding=padding)
        want = jref.deconv2d_ref(jnp.asarray(x), jnp.asarray(w3), stride=stride, padding=padding)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_deconv2d_cpu_takes_plain_version_without_counting():
    ops.reset_launches()
    y = ops.deconv2d(torch.randn(1, 4, 4, 8), torch.randn(4, 4, 8, 3), torch.randn(3))
    assert tuple(y.shape) == (1, 8, 8, 3) and ops.launches == {"deconv2d": 0}
    with pytest.raises(ValueError):
        ops.deconv2d(torch.randn(1, 4, 4, 8), torch.randn(4, 4, 6, 3))  # Cin mismatch
    with pytest.raises(ValueError, match="CUDA"):
        kernel.deconv2d_cuda(torch.randn(1, 4, 4, 8), torch.randn(4, 4, 8, 3))


@pytest.mark.parametrize(
    "B,H,W,cin,cout,narrow",
    [
        (1, 1, 1, 512, 512, False), (1, 2, 2, 1024, 512, False), (1, 16, 16, 1024, 256, False),
        (1, 64, 64, 256, 64, False), (1, 128, 128, 128, 3, True), (8, 128, 128, 128, 3, True),
        (8, 1, 1, 512, 512, False), (2, 4, 4, 3, 5, False),
    ],
)
def test_launch_geometry_covers_k_exactly_once(B, H, W, cin, cout, narrow):
    """The main path's shapes: Cout <= 4 takes the narrow kernel, and the
    phase GEMM's K splits cover the live K tiles (those whose taps reach an
    input for some row: a quarter of them at 1x1) without gap or empty
    split."""
    geo = kernel.phase_geometry(B, H, W, cin, cout)
    assert geo.narrow == narrow
    if narrow:
        return
    nkt = kernel.live_k_tiles(H, W, cin, kernel.phase_bk(4))
    assert nkt == -(-4 * cin // kernel.phase_bk(4)) // (4 if H == W == 1 else 1)
    assert geo.splitk >= 1 and (geo.splitk - 1) * geo.per < nkt <= geo.splitk * geo.per


def test_smoke_bound_counts_real_taps_and_the_operand_type():
    """chip_smoke's bound for deconv2d: at a 1x1 input each of the 4
    outputs reads one tap, so 4 of the 16 weight slices; bf16 operands are
    held to the bf16 tensor-core peak, f32 operands to the fp32-accurate
    rate of three TF32 tensor-core products per multiply-add (495/3
    TFLOP/s)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cin, cout = 8, 5
    assert smoke.FP32_ACCURATE_FLOPS == pytest.approx(495e12 / 3, rel=1e-12)
    for dtype, esize, peak in ((torch.float32, 4, smoke.FP32_ACCURATE_FLOPS), (torch.bfloat16, 2, smoke.BF16_FLOPS)):
        a = dict(x=torch.zeros(1, 1, 1, cin, dtype=dtype), w=torch.zeros(4, 4, cin, cout, dtype=dtype), b=torch.zeros(cout))
        bytes_ms, ops_ms = smoke.bound("deconv2d", a, bias=True)
        want_bytes = esize * (cin + 4 * cout + 4 * cin * cout) + 4 * cout
        assert bytes_ms == pytest.approx(want_bytes / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
        assert ops_ms == pytest.approx((2 * cin * cout * 4 + 4 * cout) / peak * 1e3, rel=1e-12)


# ------------------------------------------------------------ grad guard


# name -> (call, weight shape or None)
GUARDED = {
    "conv_block": (lambda x, w: fused_ops.conv_block(x, w, padding=1), (3, 3, 4, 8)),
    "deconv_block": (lambda x, w: fused_ops.deconv_block(x, w), (4, 4, 4, 8)),
    "sppf_pyramid": (lambda x, w: fused_ops.sppf_pyramid(x), None),
    "deconv2d": (lambda x, w: ops.deconv2d(x, w), (4, 4, 4, 8)),
}


@pytest.mark.parametrize("name", list(GUARDED))
def test_kernels_refuse_to_run_under_autograd(name):
    """A kernel has no backward (the TPU kernel has no custom_vjp): on the
    card its output would carry no grad_fn and cut the gradient silently,
    so the op raises on both devices where autograd would need it."""
    call, wshape = GUARDED[name]
    x = torch.randn(1, 8, 8, 4)
    w = None if wshape is None else torch.randn(wshape)
    needing = [(x.clone().requires_grad_(), w)]
    if w is not None:
        needing.append((x, w.clone().requires_grad_()))
    for args in needing:
        with pytest.raises(RuntimeError, match='impl="xla"'):
            call(*args)
        with torch.no_grad():  # the same tensors under no_grad: no gradient needed
            assert call(*args).grad_fn is None


def test_serving_and_eval_unaffected_by_the_grad_guard():
    """Serving runs on parameters that need no gradient, and evaluation
    under ``torch.no_grad()`` (here on parameters that do require it): both
    go through every kernel's op."""
    from repro_torch.models import Pix2Pix, Pix2PixConfig
    from repro_torch.nn.module import tree_map
    from repro_torch.serve import build_server
    from repro_torch.train import make_pix2pix_infer

    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, impl="pallas", device="cpu")
    for s in bundle.streams:
        bundle.server.submit(s.model_index, bundle.frame_for(s.name, 0))
    bundle.server.pump()
    outs = bundle.server.drain()
    assert sorted(len(v) for v in outs.values()) == [1, 1]
    cfg = Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping", deconv_backend="pallas")
    params = Pix2Pix(cfg).init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.requires_grad_(), params)
    y = make_pix2pix_infer(Pix2Pix(cfg))(params, torch.randn(2, 32, 32, 3))
    assert tuple(y.shape) == (2, 32, 32, 3) and y.grad_fn is None


@pytest.mark.cuda
def test_cuda_deconv2d_matches_plain_version_on_card():
    """The kernel against its plain version on the card (TF32 off), at the
    JAX cases, the generator's deep, wide and narrow shapes, a Cin % 32 != 0
    case off the 16-byte staging, the 128-row tile, and the Cout-3 layer at
    batch 8 (the narrow kernel's 4-row blocks). In bf16 the
    kernel rounds its fp32 sum once and the plain version (cuDNN, then the
    bias add) may round elsewhere: one bf16 ulp (2^-7 relative) apart on
    top of the 5e-2 pin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cases = DECONV_CASES + [
        (1, 1, 1, 512, 512), (2, 2, 2, 1024, 512), (1, 64, 64, 128, 3),
        (2, 8, 8, 40, 64), (4, 64, 64, 64, 64), (8, 128, 128, 128, 3),
    ]
    ops.reset_launches()
    n = 0
    for B, H, W, cin, cout in cases:
        for tdt, _, atol in DTYPES:
            for bias in (False, True):
                x, w, b = (torch.from_numpy(a).to(dev) for a in _inputs(B, H, W, cin, cout))
                x, w = x.to(tdt), w.to(tdt)
                bb = b if bias else None
                got = ops.deconv2d(x, w, bb)
                want = tref.deconv2d_ref(x, w, bb)
                rtol = 2**-7 if tdt == torch.bfloat16 else 0.0
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                n += 1
    torch.cuda.synchronize()
    assert ops.launches == {"deconv2d": n}
    with pytest.raises(ValueError, match="k=4"):
        ops.deconv2d(torch.randn(1, 4, 4, 8, device=dev), torch.randn(3, 3, 8, 2, device=dev))
