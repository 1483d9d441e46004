"""The PyTorch port's flash-attention and SSD-scan ops, ``Attention`` and
``Mamba2Block``, against the JAX package.

On the CPU ``repro_torch.kernels.attention.ops.attention`` runs the plain
``attention_ref`` and ``repro_torch.kernels.ssd.ops.ssd`` the plain
``ssd_chunked``; these pin them to ``repro.kernels.attention.ref`` and
``repro.nn.ssm.ssd_chunked`` on the JAX package's own ``ATTN_CASES`` and
``SSD_CASES`` (``tests/test_kernels.py``) plus ragged lengths, in f32. The
CUDA kernels run only on a card (``cuda`` marker), where they are held
against the same plain versions at the JAX package's pins.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.kernels.attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.nn.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.nn.module import from_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once on the
    machine's cores, and with as many threads as cores in each file too,
    this file's small ops ran many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_kernels.py's ATTN_CASES, plus ragged lengths (no multiple of
# the 128 tile: the JAX ops send them to the ref, the port's kernel takes
# them), an Sq < Sk window case, D 16, and D 128 with a window edge inside
# a 64-key tile and Sk no multiple of 64
ATTN_CASES = [
    dict(B=2, Sq=256, Sk=256, Hq=4, Hk=2, D=64, causal=True, window=0, softcap=None),
    dict(B=1, Sq=256, Sk=256, Hq=8, Hk=1, D=32, causal=True, window=64, softcap=50.0),
    dict(B=2, Sq=128, Sk=512, Hq=4, Hk=4, D=64, causal=True, window=0, softcap=None),
    dict(B=1, Sq=256, Sk=256, Hq=2, Hk=2, D=128, causal=False, window=0, softcap=None),
    dict(B=1, Sq=512, Sk=512, Hq=4, Hk=2, D=64, causal=True, window=128, softcap=30.0),
    dict(B=2, Sq=200, Sk=200, Hq=5, Hk=1, D=64, causal=True, window=50, softcap=None),
    dict(B=1, Sq=77, Sk=301, Hq=4, Hk=2, D=32, causal=True, window=100, softcap=None),
    dict(B=2, Sq=130, Sk=130, Hq=4, Hk=2, D=16, causal=True, window=0, softcap=None),
    dict(B=1, Sq=150, Sk=230, Hq=4, Hk=1, D=128, causal=True, window=70, softcap=None),
]
# tests/test_kernels.py's SSD_CASES (b, s, h, p, g, n, chunk), plus a
# ragged length and Hymba's head layout at a short length
SSD_CASES = [
    (2, 256, 4, 64, 1, 32, 64),
    (1, 128, 8, 32, 2, 16, 32),
    (2, 512, 4, 64, 4, 64, 128),
    (1, 200, 4, 32, 2, 16, 64),
    (2, 96, 50, 64, 1, 16, 256),
]


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _attn_inputs(c, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(c["B"], c["Sq"], c["Hq"], c["D"]).astype(np.float32)
    k = rs.randn(c["B"], c["Sk"], c["Hk"], c["D"]).astype(np.float32)
    v = rs.randn(c["B"], c["Sk"], c["Hk"], c["D"]).astype(np.float32)
    return q, k, v


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32)  # softplus
    A = (-np.exp(rs.randn(h) * 0.5)).astype(np.float32)
    B = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    C = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"{c['Sq']}x{c['Sk']}-h{c['Hq']}/{c['Hk']}-d{c['D']}-w{c['window']}")
def test_attention_plain_matches_jax_ref(case):
    """f32, atol 1e-5: the same function summed in another order."""
    c = case
    q, k, v = _attn_inputs(c)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    attn_ops.reset_launches()
    got = attn_ops.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = j_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    assert tuple(got.shape) == want.shape and attn_ops.launches == {"flash_attention": 0}
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,ch", SSD_CASES)
def test_ssd_plain_matches_ssd_chunked_with_state(b, s, h, p, g, n, ch):
    """f32, y and the final state: atol 1e-5 plus rtol 1e-4. The
    three-operand einsums contract in another order in torch than in XLA,
    and an output sums chunk x n (up to 128 x 64) products of O(1) terms,
    so the two round apart by ~1e-5 relative."""
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, g, n)
    ssd_ops.reset_launches()
    y, st = ssd_ops.ssd(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=ch, return_state=True)
    wy, wst = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=ch, return_state=True)
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n) and ssd_ops.launches == {"ssd": 0}
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_f32(st), _f32(wst), atol=1e-5, rtol=1e-4)
    y_only = ssd_ops.ssd(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=ch)
    assert torch.equal(y_only, y)


def test_ssd_chunking_changes_only_rounding():
    """The kernel steps 64 at a time whatever ``chunk`` is: the chunked
    scan is one function for every chunk length (and the naive recurrence)."""
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(1, 192, 4, 32, 2, 16, seed=3))
    outs = [ssd_ref.ssd_chunked(x, dt, A, B, C, chunk=ch, return_state=True) for ch in (16, 64, 192, 256)]
    for y, st in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(st, outs[0][1], atol=1e-5, rtol=1e-5)
    state = torch.zeros(1, 4, 32, 16)
    ys = []
    for t in range(x.shape[1]):
        yt, state = tnn.ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(yt)
    torch.testing.assert_close(torch.stack(ys, 1), outs[0][0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, outs[0][1], atol=1e-4, rtol=1e-4)


def test_segsum_matches_jax():
    x = np.random.RandomState(5).randn(3, 7).astype(np.float32)
    got = ssd_ref.segsum(torch.from_numpy(x))
    want = jnn.ssm.segsum(jnp.asarray(x))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6)


def test_ops_reject_what_the_kernels_do_not_take():
    """The wrappers' checks, which run before any launch: shapes, head and
    state widths the sources instantiate, and CUDA-only entry points."""
    q, k = torch.randn(1, 8, 4, 64), torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attn_kernel.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        attn_kernel.check_shapes(torch.randn(1, 8, 4, 48), torch.randn(1, 8, 2, 48), torch.randn(1, 8, 2, 48), True, 0)
    with pytest.raises(ValueError, match="no key"):
        attn_kernel.check_shapes(torch.randn(1, 9, 4, 64), k, k, True, 0)
    attn_kernel.check_shapes(torch.randn(1, 9, 4, 64), k, k, False, 0)  # non-causal: every row sees every key
    with pytest.raises(ValueError, match="Hq % Hk"):
        attn_kernel.check_shapes(torch.randn(1, 8, 3, 64), k, k, True, 0)
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(1, 16, 4, 32, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_cuda(x, dt, A, B, C)
    with pytest.raises(ValueError, match="n in"):
        ssd_kernel.check_shapes(x, dt, A, B[..., :12], C[..., :12])
    with pytest.raises(ValueError, match="multiple"):
        ssd_kernel.check_shapes(x[..., :24], dt, A, B, C)
    with pytest.raises(ValueError, match="disagree"):
        ssd_kernel.check_shapes(x, dt[..., :3], A, B, C)


@pytest.mark.parametrize("name", ["flash_attention", "ssd"])
def test_lm_kernels_refuse_to_run_under_autograd(name):
    """No backward (the TPU kernels have no custom_vjp): the ops raise on
    both devices where autograd would need one, and run under no_grad."""
    if name == "flash_attention":
        args = list(map(torch.from_numpy, _attn_inputs(ATTN_CASES[5])))
        call = attn_ops.attention
    else:
        args = list(map(torch.from_numpy, _ssd_inputs(1, 16, 4, 32, 2, 16)))
        call = ssd_ops.ssd
    for i in range(len(args)):
        needing = [a.clone().requires_grad_() if j == i else a for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            call(*needing)
        with torch.no_grad():
            assert call(*needing).grad_fn is None


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize(
    "Sq,Sk,causal,window",
    [(1, 1, True, 0), (64, 64, True, 0), (37, 91, True, 0), (96, 96, True, 16), (50, 120, True, 200),
     (40, 40, False, 0), (30, 70, False, 9), (128, 128, True, 1), (4096, 4096, True, 1024)],
)
def test_smoke_bound_counts_exactly_the_pairs_inside_the_mask(Sq, Sk, causal, window):
    """chip_smoke's flash-attention bound counts (query, key) pairs inside
    the mask exactly: against a brute-force count of attention_ref's mask
    (the 4096 x 4096 window-1024 case is Hymba's local layer)."""
    smoke = _smoke()
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    kpos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    assert smoke.attention_pairs(Sq, Sk, causal, window) == int(mask.sum())


def test_smoke_bound_for_the_lm_kernels():
    """The bounds' bytes (each input once, each output once) and operations
    (4 D per pair for attention; the scan's chunked multiply-adds) over the
    operands' peak."""
    smoke = _smoke()
    for dtype, esize, peak in ((torch.float32, 4, smoke.FP32_ACCURATE_FLOPS), (torch.bfloat16, 2, smoke.BF16_FLOPS)):
        q, k = torch.zeros(2, 64, 4, 32, dtype=dtype), torch.zeros(2, 64, 2, 32, dtype=dtype)
        bytes_ms, ops_ms = smoke.lm_bound("flash_attention", dict(q=q, k=k, v=k, causal=True, window=16))
        pairs = smoke.attention_pairs(64, 64, True, 16)
        assert bytes_ms == pytest.approx(esize * (2 * q.numel() + 2 * k.numel()) / smoke.HBM_BYTES_PER_S * 1e3)
        assert ops_ms == pytest.approx(4 * 2 * 4 * 32 * pairs / peak * 1e3)
        b, s, h, p, g, n = 2, 100, 4, 32, 2, 16
        a = dict(x=torch.zeros(b, s, h, p, dtype=dtype), dt=torch.zeros(b, s, h, dtype=dtype), A=torch.zeros(h),
                 B=torch.zeros(b, s, g, n, dtype=dtype), C=torch.zeros(b, s, g, n, dtype=dtype), return_state=True)
        bytes_ms, ops_ms = smoke.lm_bound("ssd", a)
        want = esize * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n) + 4 * h + 4 * b * h * p * n
        assert bytes_ms == pytest.approx(want / smoke.HBM_BYTES_PER_S * 1e3)
        pairs = sum(min(64, s - c) * (min(64, s - c) + 1) // 2 for c in range(0, s, 64))
        macs = b * (g * pairs * n + h * pairs * p + 2 * h * s * p * n)
        assert ops_ms == pytest.approx(2 * macs / peak * 1e3)


# ------------------------------------------------------------- Attention


def _jax_params(module, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.key(seed)))


ATTN_MODULE_CASES = [
    dict(window=0, attn_chunk=0, S=12),
    dict(window=8, attn_chunk=0, S=12),
    dict(window=0, attn_chunk=8, S=16),  # above attn_chunk: the query-chunked route
    dict(window=8, attn_chunk=8, S=16),
    dict(window=8, attn_chunk=32, S=16),  # below it
]


@pytest.mark.parametrize("case", ATTN_MODULE_CASES, ids=lambda c: f"w{c['window']}-chunk{c['attn_chunk']}-S{c['S']}")
def test_attention_module_matches_jax(case):
    """``__call__`` (with and without positions, causal and not),
    ``prefill`` and its caches, f32, atol 1e-5."""
    kw = dict(d_model=32, n_q=4, n_kv=2, head_dim=16, attn_chunk=case["attn_chunk"])
    jm, tm = jnn.Attention(**kw), tnn.Attention(**kw)
    jp = _jax_params(jm)
    tp = from_jax(jp)
    S, w = case["S"], case["window"]
    rs = np.random.RandomState(1)
    x = rs.randn(2, S, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S)).copy()
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for positions in (None, pos):
        tpos = None if positions is None else torch.from_numpy(positions)
        jpos = None if positions is None else jnp.asarray(positions)
        np.testing.assert_allclose(_f32(tm(tp, tx, tpos, window=w)), _f32(jm(jp, jx, jpos, window=w)), atol=1e-5)
        np.testing.assert_allclose(
            _f32(tm(tp, tx, tpos, window=w, index_positions=positions is not None)),
            _f32(jm(jp, jx, jpos, window=w)), atol=1e-5,
        )
        y, cache = tm.prefill(tp, tx, tpos, window=w, cache_dtype=torch.float32)
        wy, wcache = jm.prefill(jp, jx, jpos, window=w, cache_dtype=jnp.float32)
        np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(_f32(cache[name]), _f32(wcache[name]), atol=1e-5)
    np.testing.assert_allclose(
        _f32(tm(tp, tx, torch.from_numpy(pos), causal=False)), _f32(jm(jp, jx, jnp.asarray(pos), causal=False)),
        atol=1e-5,
    )
    kv = rs.randn(2, 5, 32).astype(np.float32)  # cross-attention: no positions, so no rope
    np.testing.assert_allclose(
        _f32(tm(tp, tx, window=w, kv_x=torch.from_numpy(kv))),
        _f32(jm(jp, jx, window=w, kv_x=jnp.asarray(kv))), atol=1e-5,
    )


@pytest.mark.parametrize("window,cache_len", [(0, 16), (8, 16), (8, 8), (4, 1)])
def test_attention_decode_over_ring_cache_matches_jax(window, cache_len):
    """``decode`` step by step, 12 tokens: a full cache (16), a ring cache
    of the window's length that wraps (8), and the degenerate 1-slot
    cache; outputs and caches, f32, atol 1e-5."""
    kw = dict(d_model=32, n_q=4, n_kv=2, head_dim=16)
    jm, tm = jnn.Attention(**kw), tnn.Attention(**kw)
    jp = _jax_params(jm, seed=2)
    tp = from_jax(jp)
    x = np.random.RandomState(3).randn(2, 12, 32).astype(np.float32)
    tc, jc = tm.init_cache(2, cache_len, torch.float32), jm.init_cache(2, cache_len, jnp.float32)
    for t in range(12):
        xt = x[:, t : t + 1]
        ty, tc = tm.decode(tp, torch.from_numpy(xt), tc, t, window=window)
        jy, jc = jm.decode(jp, jnp.asarray(xt), jc, t, window=window)
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]), atol=1e-5)


def test_attention_decode_matches_full_forward():
    """One-token decode over a full cache reproduces the causal window
    forward at every position (f32, atol 1e-5)."""
    tm = tnn.Attention(32, 4, 2, 16)
    tp = from_jax(_jax_params(jnn.Attention(32, 4, 2, 16), seed=4))
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 10, 32).astype(np.float32))
    pos = torch.arange(10)[None].expand(2, 10)
    full = tm(tp, x, pos, window=4)
    cache = tm.init_cache(2, 10, torch.float32)
    for t in range(10):
        y, cache = tm.decode(tp, x[:, t : t + 1], cache, t, window=4)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-5, rtol=0)


# ----------------------------------------------------------- Mamba2Block


MAMBA_CASES = [
    dict(d_model=32, d_state=16, head_dim=16, n_groups=1, chunk=8, S=20),
    dict(d_model=32, d_state=16, head_dim=16, n_groups=2, chunk=128, S=12),
    dict(d_model=64, d_state=32, head_dim=32, n_groups=1, chunk=16, S=32),
]


@pytest.mark.parametrize("case", MAMBA_CASES, ids=lambda c: f"g{c['n_groups']}-chunk{c['chunk']}-S{c['S']}")
def test_mamba2_block_matches_jax(case):
    """``__call__``, ``prefill`` (output, conv tail, ssm state) and a
    ``decode`` sequence continuing from the prefill, f32, atol 1e-5."""
    S = case.pop("S")
    jm, tm = jnn.Mamba2Block(**case), tnn.Mamba2Block(**case)
    case["S"] = S
    jp = _jax_params(jm, seed=6)
    tp = from_jax(jp)
    x = np.random.RandomState(7).randn(2, S + 4, jm.d_model).astype(np.float32)
    tx, jx = torch.from_numpy(x[:, :S]), jnp.asarray(x[:, :S])
    np.testing.assert_allclose(_f32(tm(tp, tx)), _f32(jm(jp, jx)), atol=1e-5)
    y, cache = tm.prefill(tp, tx, cache_dtype=torch.float32)
    wy, wcache = jm.prefill(jp, jx, cache_dtype=jnp.float32)
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-5)
    for name in ("conv", "ssm"):
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(_f32(cache[name]), _f32(wcache[name]), atol=1e-5)
    for t in range(S, S + 4):
        xt = x[:, t : t + 1]
        ty, cache = tm.decode(tp, torch.from_numpy(xt), cache)
        jy, wcache = jm.decode(jp, jnp.asarray(xt), wcache)
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_f32(cache[name]), _f32(wcache[name]), atol=1e-5)


def test_mamba2_decode_from_empty_cache_matches_full_forward():
    """Decode from ``init_cache`` reproduces ``__call__`` (f32, atol 1e-4:
    the recurrence and the chunked scan round differently)."""
    m = tnn.Mamba2Block(32, d_state=16, head_dim=16, chunk=8)
    p = m.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(1))
    full = m(p, x)
    cache = m.init_cache(2, torch.float32)
    for t in range(12):
        y, cache = m.decode(p, x[:, t : t + 1], cache)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-4, rtol=0)


# ------------------------------------------------------------- card only


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version_on_card():
    """The kernel against ``attention_ref`` on the card at every case above
    and gemma2's shape class (D 256, softcap 50), in f32 (atol 3e-4) and
    bf16 (atol 4e-2): the JAX package's pins. The bf16 kernel computes in
    fp32, so it is also held against the f32 reference on the same (upcast)
    inputs within one bf16 ulp of the output (2^-7 relative) plus 1e-5."""
    dev = _card()
    cases = ATTN_CASES + [dict(B=1, Sq=300, Sk=300, Hq=8, Hk=4, D=256, causal=True, window=128, softcap=50.0)]
    attn_ops.reset_launches()
    n = 0
    for c in cases:
        for dtype, atol in ((torch.float32, 3e-4), (torch.bfloat16, 4e-2)):
            q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _attn_inputs(c))
            kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
            got = attn_ops.attention(q, k, v, **kw)
            want = attn_ref.attention_ref(q, k, v, **kw)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
            if dtype == torch.bfloat16:
                want32 = attn_ref.attention_ref(q.float(), k.float(), v.float(), **kw)
                torch.testing.assert_close(got.float(), want32, atol=1e-5, rtol=2.0**-7)
            n += 1
    torch.cuda.synchronize()
    assert attn_ops.launches == {"flash_attention": n}


@pytest.mark.cuda
def test_cuda_ssd_matches_plain_version_on_card():
    """The kernel against ``ssd_chunked`` in f32 on the same inputs, y and
    final state, in f32 (atol 3e-3, rtol 2e-2) and bf16 (atol 0.15, rtol
    2e-2): the JAX package's pins, with Mamba2-2.7B's class (h 80, n 128)
    and a last chunk of one step (65 = 64 + 1)."""
    dev = _card()
    ssd_ops.reset_launches()
    n = 0
    for b, s, h, p, g, nn_, ch in SSD_CASES + [(1, 512, 80, 64, 1, 128, 256), (2, 65, 4, 32, 2, 32, 64)]:
        for dtype, atol in ((torch.float32, 3e-3), (torch.bfloat16, 0.15)):
            x, dt, A, B, C = (torch.from_numpy(a).to(dev) for a in _ssd_inputs(b, s, h, p, g, nn_))
            x, dt, B, C = (t.to(dtype) for t in (x, dt, B, C))
            y, st = ssd_ops.ssd(x, dt, A, B, C, chunk=ch, return_state=True)
            wy, wst = ssd_ref.ssd_chunked(x.float(), dt.float(), A, B.float(), C.float(), chunk=ch, return_state=True)
            torch.testing.assert_close(y.float(), wy, atol=atol, rtol=2e-2)
            torch.testing.assert_close(st, wst, atol=atol, rtol=2e-2)
            n += 1
    torch.cuda.synchronize()
    assert ssd_ops.launches == {"ssd": n}


@pytest.mark.cuda
def test_cuda_attention_routes_by_positions():
    """On the card, self-attention with index positions launches the
    kernel; a caller's explicit positions take the plain route."""
    dev = _card()
    tm = tnn.Attention(64, 4, 2, 16)
    tp = tm.init(torch.Generator(dev).manual_seed(0))
    x = torch.randn(2, 40, 64, device=dev)
    pos = torch.arange(40, device=dev)[None].expand(2, 40)
    attn_ops.reset_launches()
    a = tm(tp, x, pos, window=8, index_positions=True)
    b = tm(tp, x, pos, window=8)
    torch.cuda.synchronize()
    assert attn_ops.launches == {"flash_attention": 1}
    torch.testing.assert_close(a, b, atol=3e-4, rtol=0)
