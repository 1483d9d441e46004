"""The arithmetic of the chunk-parallel SSD scan in
``repro_torch/kernels/ssd/csrc/ssd.cu``, emulated pass by pass in plain
torch on the CPU and held against ``repro.nn.ssm.ssd_chunked`` in JAX.

The kernels cut the sequence into chunks of T = 64 steps (``kernel.CHUNK``)
and run four passes: C.B^T once per (row, chunk, group); per (row, chunk,
head) the inclusive scan cum of dt * A (a warp scan, two steps a lane), the
chunk decay exp(cum_last) and the chunk state S = x^T (w o B), w_j =
exp(cum_last - cum_j) dt_j; the serial state passing h_c = h_{c-1} decay_c
+ S_c; the chunk scan y = M x + exp(cum_i) C h_{c-1}^T with M_ij = CB_ij
exp(cum_i - cum_j) dt_j below the diagonal. Every product is an MMA whose
sum is rounded toward zero. f32 entry: 3xTF32 (lo.hi + hi.lo + hi.hi,
cvt.rna), a fresh chain for each 32-deep K tile added to the running sum in
fp32. bf16 entry: m16n8k16 over 16-deep steps in one chain; x, B and C are
exact bf16 operands, and the fp32 factors (w o B, M, h_{c-1}) enter as two
bf16 terms, hi = rn(v) and lo = rn(v - hi).

f32 is held at atol 1e-5 plus rtol 1e-4, the pin of the plain version's
own test against JAX (``test_torch_attention_ssd.py``: the two frameworks
contract the einsums in other orders); bf16 against the f32 JAX output on
the same inputs at the JAX package's pins (atol 0.15, rtol 2e-2).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.nn.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402

T = ssd_kernel.CHUNK
KCHAIN = 32  # f32: K per fresh accumulator chain


def tf32_rna(v):
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32)."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def bf16_rn(v):
    """float32 -> the nearest bf16 value, ties to even (__floats2bfloat162_rn)."""
    return v.to(torch.bfloat16).float()


def rz32(v):
    """float64 -> float32 rounded toward zero: how an MMA rounds its sum."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mma(a, b, mode, asplit=False, bsplit=False, terms=None, chain=None):
    """``warp_gemm``: a (..., M, K) @ b (..., K, N) in the kernels' MMA
    arithmetic. ``terms`` (f32 only) 3, the kernel, or 1: one TF32 product.
    ``chain`` (f32 only): K per fresh accumulator chain, ``KCHAIN`` unless
    given."""
    K = a.shape[-1]
    if mode == "f32":
        ah, bh = tf32_rna(a), tf32_rna(b)
        al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
        pairs = [(al, bh), (ah, bl), (ah, bh)][3 - (terms or 3):]
        step, chain = 8, chain or KCHAIN
    else:
        ah, bh = bf16_rn(a), bf16_rn(b)
        pairs = ([(bf16_rn(a - ah), bh)] if asplit else []) + ([(ah, bf16_rn(b - bh))] if bsplit else []) + [(ah, bh)]
        step, chain = 16, K
    pairs = [(x.double(), y.double()) for x, y in pairs]
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for kc in range(0, K, chain):
        tacc = torch.zeros_like(acc)
        for k0 in range(kc, min(kc + chain, K), step):
            k = slice(k0, k0 + step)
            for x, y in pairs:
                tacc = rz32(tacc.double() + x[..., k] @ y[..., k, :])
        acc = acc + tacc
    return acc


def chunk_cum(dA):
    """``chunk_cum``: (..., 64) -> the inclusive scan as the warp computes
    it: lane l sums its two steps, a Hillis-Steele scan over the 32 lanes,
    then cum[2l] = sc - d1, cum[2l + 1] = sc, all in fp32."""
    d0, d1 = dA[..., 0::2], dA[..., 1::2]
    sc = d0 + d1
    for w in (1, 2, 4, 8, 16):
        up = torch.cat([torch.zeros_like(sc[..., :w]), sc[..., :-w]], -1)
        sc = torch.cat([sc[..., :w], sc[..., w:] + up[..., w:]], -1)
    return torch.stack([sc - d1, sc], -1).flatten(-2)


def emulate_ssd(x, dt, A, B, C, mode, terms=None):
    """The four passes on float32 tensors holding the kernel's inputs (bf16
    values for ``mode`` "bf16") -> (y in the entry's dtype, final state fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = math.ceil(s / T)
    pad = nc * T - s
    xc = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, nc, T, h, p).permute(0, 1, 3, 2, 4)  # (b, nc, h, T, p)
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, T, h).permute(0, 1, 3, 2)  # (b, nc, h, T)
    Bc = F.pad(B, (0, 0, 0, 0, 0, pad)).reshape(b, nc, T, g, n).permute(0, 1, 3, 2, 4)  # (b, nc, g, T, n)
    Cc = F.pad(C, (0, 0, 0, 0, 0, pad)).reshape(b, nc, T, g, n).permute(0, 1, 3, 2, 4)
    grp = torch.arange(h) // (h // g)
    kw = dict(terms=terms)
    # pass 1: C.B^T per group
    cb = mma(Cc, Bc.transpose(-1, -2), mode, **kw)  # (b, nc, g, T, T)
    # pass 2: cum, decay, chunk states
    cum = chunk_cum(dtc * A[:, None])  # (b, nc, h, T)
    last = cum[..., -1:]
    wB = Bc[:, :, grp] * (torch.exp(last - cum) * dtc)[..., None]  # (b, nc, h, T, n)
    S = mma(xc.transpose(-1, -2), wB, mode, bsplit=True, **kw)  # (b, nc, h, p, n)
    decay = torch.exp(last[..., 0])  # (b, nc, h)
    # pass 3: state passing, a multiply then an add
    hprev, hin = torch.zeros(b, h, p, n), []
    for c in range(nc):
        hin.append(hprev)
        hprev = hprev * decay[:, c, :, None, None] + S[:, c]
    hin = torch.stack(hin, 1)  # (b, nc, h, p, n)
    # pass 4: the chunk scan, masked before exp
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    M = torch.where(causal, cb[:, :, grp] * (torch.exp(torch.where(causal, diff, 0.0)) * dtc[..., None, :]), 0.0)
    intra = mma(M, xc, mode, asplit=True, **kw)  # (b, nc, h, T, p)
    inter = mma(Cc[:, :, grp], hin.transpose(-1, -2), mode, bsplit=True, **kw)
    y = (intra.double() + inter.double() * torch.exp(cum).double()[..., None]).float()  # one rounding: FMA
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * T, h, p)[:, :s]
    return (bf16_rn(y) if mode == "bf16" else y), hprev


def _inputs(b, s, h, p, g, n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32)  # softplus
    A = (-np.exp(rs.randn(h) * 0.5)).astype(np.float32)
    B = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    C = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _jax(x, dt, A, B, C):
    y, st = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=T, return_state=True)
    return np.asarray(y, np.float32), np.asarray(st, np.float32)


# (b, s, h, p, g, n): a ragged s (200 = 3 chunks + 8), g 1 and g 4, n 16,
# 64 and 128, p 32 (half a channel tile) and 64, a 1-step tail (129)
CASES = [
    (2, 200, 4, 32, 1, 16),
    (1, 129, 8, 64, 4, 64),
    (1, 96, 4, 64, 1, 128),
    (2, 64, 4, 16, 4, 16),
]


@pytest.mark.parametrize("b,s,h,p,g,n", CASES)
def test_f32_pipeline_matches_jax(b, s, h, p, g, n):
    x, dt, A, B, C = _inputs(b, s, h, p, g, n)
    y, st = emulate_ssd(*map(torch.from_numpy, (x, dt, A, B, C)), "f32")
    wy, wst = _jax(x, dt, A, B, C)
    np.testing.assert_allclose(y.numpy(), wy, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), wst, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,g,n", CASES)
def test_bf16_pipeline_meets_the_jax_pins(b, s, h, p, g, n):
    """bf16 inputs, y rounded to bf16, the state in fp32: against the f32
    JAX scan of the same (bf16) values at atol 0.15, rtol 2e-2, and in fact
    within one bf16 ulp of y plus 1e-4 (the hi + lo terms carry every fp32
    factor to 2^-16 of its size)."""
    x, dt, A, B, C = _inputs(b, s, h, p, g, n)
    x, dt, B, C = (bf16_rn(torch.from_numpy(a)).numpy() for a in (x, dt, B, C))
    y, st = emulate_ssd(*map(torch.from_numpy, (x, dt, A, B, C)), "bf16")
    wy, wst = _jax(x, dt, A, B, C)
    np.testing.assert_allclose(y.numpy(), wy, atol=0.15, rtol=2e-2)
    np.testing.assert_allclose(st.numpy(), wst, atol=0.15, rtol=2e-2)
    np.testing.assert_allclose(y.numpy(), wy, atol=1e-4, rtol=2.0**-7)
    np.testing.assert_allclose(st.numpy(), wst, atol=1e-4, rtol=1e-4)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_one_tf32_term_misses_the_f32_prefill_check():
    """The f32 prefill's check is 1e-4 relative (Frobenius) on the logits
    and the SSM states (``chip_smoke.PREFILL_F32_TOL``). With one TF32
    product per multiply-add a single scan is already past it (about 3e-4
    to 4e-4 here); the 3xTF32 split stays within 1e-5 of the JAX scan, the
    decade where the plain version with other chunks lands (3e-6 to 5e-6 on
    the state at chunk 256)."""
    x, dt, A, B, C = _inputs(1, 256, 4, 64, 1, 16, seed=4)
    wy, wst = _jax(x, dt, A, B, C)
    args = list(map(torch.from_numpy, (x, dt, A, B, C)))
    y1, st1 = emulate_ssd(*args, "f32", terms=1)
    y3, st3 = emulate_ssd(*args, "f32")
    assert _rel(st1.numpy(), wst) > 1e-4 and _rel(y1.numpy(), wy) > 1e-4
    assert _rel(st3.numpy(), wst) < 1e-5 and _rel(y3.numpy(), wy) < 1e-5


def test_chunk_cum_is_an_inclusive_scan():
    dA = -torch.rand(3, 64)
    torch.testing.assert_close(chunk_cum(dA), torch.cumsum(dA.double(), -1).float(), atol=1e-5, rtol=1e-5)


def test_scratch_shapes_and_bytes():
    """The wrapper's fp32 scratch at Hymba-1.5B's prefill (2, 4096, 50, 64,
    g 1, n 16) and Mamba2-2.7B's n 128 class (1, 2048, 80, 64)."""
    assert ssd_kernel.scratch_shapes(2, 4096, 50, 64, 1, 16) == {
        "cb": (2, 64, 1, 64, 64), "states": (2, 50, 64, 64, 16), "decay": (2, 50, 64)}
    def nbytes(*shape):
        return 4 * sum(math.prod(v) for v in ssd_kernel.scratch_shapes(*shape).values())

    assert nbytes(2, 4096, 50, 64, 1, 16) == 28_337_152
    assert nbytes(1, 2048, 80, 64, 1, 128) == 84_420_608
    assert ssd_kernel.scratch_shapes(1, 65, 2, 16, 1, 32)["states"] == (1, 2, 2, 16, 32)  # a 1-step tail


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113ssd_cb_kernelIfLi16EEEvPKT_S3_Pf4Geom' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113ssd_cb_kernelIfLi16EEEvPKT_S3_Pf4Geom
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115ssd_scan_kernelI13__nv_bfloat16Li128EEEvPKT_S4_PKfS4_S6_S6_PS2_4Geom' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115ssd_scan_kernelI13__nv_bfloat16Li128EEEvPKT_S4_PKfS4_S6_S6_PS2_4Geom
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115ssd_pass_kernelEPfPKfS0_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115ssd_pass_kernelEPfPKfS0_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers
"""


def test_smoke_reads_the_ssd_passes_from_the_ptxas_log():
    """chip_smoke's build report of the SSD passes: registers, spills and
    the dynamic shared memory a launch asks for (none for the passing
    kernel)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rep = smoke.ssd_report(PTXAS_LOG, lambda esize, n, which: 10000 * esize + 10 * n + which)
    assert list(rep) == ["ssd_cb<f32,16>", "ssd_pass", "ssd_scan<bf16,128>"]
    assert rep["ssd_cb<f32,16>"] == {"registers": 90, "spill_stores": 0, "spill_loads": 0, "static_smem": 0,
                                     "dynamic_smem": 40160}
    assert rep["ssd_scan<bf16,128>"]["spill_stores"] == 8 and rep["ssd_scan<bf16,128>"]["dynamic_smem"] == 21282
    assert rep["ssd_pass"]["dynamic_smem"] == 0
    assert smoke.ssd_report("", lambda *a: 0) == {}


def test_row_strided_reads_the_block_slices_in_place():
    """``row_strided``: Mamba2Block's x, B and C are slices of one (b, s,
    conv_dim) tensor, read in place with the row stride conv_dim; a layout
    the kernels cannot read (rows not uniformly apart, a row stride off
    16 bytes, a start off 16 bytes) is copied to a contiguous tensor."""
    b, s, h, p, g, n = 2, 10, 4, 16, 2, 16
    di = h * p
    xbc = torch.randn(b, s, di + 2 * g * n)  # conv_dim 128: 512-byte rows
    xs = xbc[..., :di].reshape(b, s, h, p)
    B = xbc[..., di : di + g * n].reshape(b, s, g, n)
    for t in (xs, B):
        got, ld = ssd_kernel.row_strided(t)
        assert got is t and ld == xbc.shape[-1]
    whole = torch.randn(b, s, h, p)
    assert ssd_kernel.row_strided(whole) == (whole, h * p)
    odd = torch.randn(b, s, di + 1)[..., :di].reshape(b, s, h, p)  # 65-float rows: off 16 bytes
    got, ld = ssd_kernel.row_strided(odd)
    assert got.is_contiguous() and ld == di and torch.equal(got, odd)
    off = torch.randn(b * s * di + 1)[1:].view(b, s, h, p)  # starts 4 bytes in
    got, ld = ssd_kernel.row_strided(off)
    assert got.data_ptr() % 16 == 0 and ld == di and torch.equal(got, off)
    swapped = whole.transpose(0, 1)  # rows not uniformly apart
    got, ld = ssd_kernel.row_strided(swapped)
    assert got.is_contiguous() and torch.equal(got, swapped)
    one = xbc[:, :1, :di].reshape(b, 1, h, p)  # s == 1: the rows are the batch rows
    assert ssd_kernel.row_strided(one) == (one, s * xbc.shape[-1])
