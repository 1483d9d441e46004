"""The arithmetic of the float32 tensor-core flash-attention kernel
(``flash_kernel_tf32`` in ``repro_torch/kernels/attention/csrc/flash_attention.cu``),
emulated in plain torch on the CPU and held against the JAX package's
``attention_ref`` in f32.

The kernel runs the bf16 kernel's tiling (KV tiles of 64 keys up to D 32,
32 above) with both products as m16n8k8 TF32 MMAs under the 3xTF32 split: each
operand becomes hi = rna(v) and lo = rna(v - hi), and every 8-deep step
adds lo.hi, hi.lo and hi.hi, each MMA rounding its sum toward zero
(``rz32``). Q.K^T is one chain over D per tile; P.V runs a fresh chain per
KV tile, added to the running output by one FMA after the alpha rescale. A
score x weighs 2^(x w - m w) with the scale folded into w. P enters P.V
straight from the accumulator registers: A column t of an 8-key step is key
2t, column t + 4 key 2t + 1, and V's B fragment is read in the same key
order.

The card holds the kernel against the plain version at atol 3e-4 (the JAX
pin, ``tests/test_kernels.py``) and the f32 prefill against the plain-ops
prefill at 1e-4 relative on the logits (``chip_smoke.PREFILL_F32_TOL``).
These tests hold the emulation to atol 3e-4 plus 1e-4 relative (Frobenius
norm) at every shape of ``test_torch_attention_ssd.ATTN_CASES`` and at
gemma2's D 256 softcap class, and show that one TF32 term misses the
checks.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention.ref import attention_ref as j_attention_ref  # noqa: E402
from test_torch_attention_ssd import ATTN_CASES, _attn_inputs, _smoke  # noqa: E402
from test_torch_ssd_tc import mma  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once on the
    machine's cores, and with as many threads as cores in each file too,
    this file's small ops ran many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOG2E = np.float32(1.4426950408889634)
NEG = -1e30
ATOL, REL = 3e-4, 1e-4


def kv_tile(D):
    """Keys per KV tile of the f32 kernel (``Tile<float, D>::BK``)."""
    return 64 if D <= 32 else 32


def p_key_order():
    """A column j of an 8-key step of P.V -> the key it carries. Lane (g,
    t) holds accumulator columns 2t, 2t + 1 (c0/c1, c2/c3) and passes them
    as A columns t, t + 4 (a0/a1, a2/a3)."""
    order = [0] * 8
    for t in range(4):
        order[t], order[t + 4] = 2 * t, 2 * t + 1
    return order


def fma32(a, b, c):
    """fmaf on float32 tensors: a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_tf32(q, k, v, causal=True, window=0, softcap=None, scale=None, terms=3):
    """q (B, Sq, Hq, D), k and v (B, Sk, Hk, D) float32 -> float32, rounded
    as the kernel rounds. ``terms=1`` takes one TF32 product per MMA."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = np.float32(scale if scale is not None else 1.0 / math.sqrt(D))
    w = LOG2E if softcap else np.float32(scale * LOG2E)
    cap_in = np.float32(scale / np.float32(softcap)) if softcap else None
    qf = q.permute(0, 2, 1, 3)  # (B, Hq, Sq, D)
    kf = k.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hq, Sq, 1), NEG)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    bk = kv_tile(D)
    order = p_key_order()
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, :, k0 : k0 + bk], vf[:, :, k0 : k0 + bk]
        n = kt.shape[2]
        if n < bk:  # rows past Sk arrive zero-filled
            pad = torch.zeros(B, Hq, bk - n, D)
            kt, vt = torch.cat([kt, pad], 2), torch.cat([vt, pad], 2)
        s = mma(qf, kt.transpose(-1, -2), "f32", terms=terms, chain=D)
        x = softcap * torch.tanh(s * cap_in) if softcap else s
        kpos = torch.arange(k0, k0 + bk)[None, :]
        ok = (kpos < Sk).expand(Sq, bk)
        if causal:
            ok = ok & (kpos <= qpos)
        if window and window > 0:
            ok = ok & ((qpos - kpos) < window)
        x = torch.where(ok, x, torch.tensor(NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        mu = torch.where(m_new == NEG, torch.zeros(()), m_new)
        alpha = torch.exp2((m - mu) * w)
        muc = mu * w
        p = torch.exp2(fma32(x, torch.tensor(w), -muc))
        l = l * alpha + p.sum(-1, keepdim=True)
        # P's A columns and V's B rows in the kernel's key order within each 8-key step
        perm = torch.tensor([k8 + j for k8 in range(0, bk, 8) for j in order])
        pv = mma(p[..., perm], vt[:, :, perm], "f32", terms=terms, chain=bk)
        acc = fma32(acc, alpha.expand_as(acc), pv)
        m = m_new
    out = acc * (1.0 / l.clamp_min(1e-30))
    return out.permute(0, 2, 1, 3)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ATTN_CASES, and gemma2's D 256 softcap class (KV tiles of 32) at a short length
F32_CASES = ATTN_CASES + [dict(B=1, Sq=300, Sk=300, Hq=8, Hk=4, D=256, causal=True, window=128, softcap=50.0)]


def _case_id(c):
    return f"{c['Sq']}x{c['Sk']}-h{c['Hq']}/{c['Hk']}-d{c['D']}-w{c['window']}"


def _run(c, terms):
    q, k, v = _attn_inputs(c)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    got = emulate_tf32(*map(torch.from_numpy, (q, k, v)), terms=terms, **kw).numpy()
    want = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)), **kw), dtype=np.float32)
    return got, want


@pytest.mark.parametrize("case", F32_CASES, ids=_case_id)
def test_tf32_split_meets_the_f32_checks(case):
    """The emulated kernel against the JAX reference in f32: no element
    beyond atol 3e-4, and within 1e-4 relative in the Frobenius norm."""
    got, want = _run(case, terms=3)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ATOL
    assert _rel(got, want) <= REL


def test_one_tf32_term_misses_the_relative_check():
    """hi.hi alone rounds every operand to 11 significant bits: the output
    lands ~3.5e-4 from the reference in the Frobenius norm, beyond the 1e-4
    that the f32 prefill's logits are held to, and ~1e-3 at its worst
    element, beyond the 3e-4 pin, at a Hymba-like shape (D 64, GQA 4/2) and
    at gemma2's D 256 softcap class. So the split is needed, and the checks
    catch its absence."""
    for c in (ATTN_CASES[0], F32_CASES[-1]):
        got1, want = _run(c, terms=1)
        got3, _ = _run(c, terms=3)
        assert _rel(got3, want) <= REL and np.abs(got3 - want).max() <= ATOL
        assert _rel(got1, want) > 2 * REL, (_case_id(c), _rel(got1, want))
        assert np.abs(got1 - want).max() > ATOL


def test_p_key_order_pairs_p_with_v():
    """The kernel's register mapping, lane by lane (lane = 4 g + t, PTX's
    m16n8k8 layouts): the accumulator (c0, c1, c2, c3) = S (g, 2t), (g,
    2t + 1), (g + 8, 2t), (g + 8, 2t + 1) passed as (a0, a2, a1, a3), where
    a0..a3 sit at A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), and V
    read as b0 = V[2t][g], b1 = V[2t + 1][g], at B (t, g), (t + 4, g). The
    A and B so built are P and V in ``p_key_order``, and A B = P V; P in
    that order against V in natural order is not."""
    rs = np.random.RandomState(1)
    P = torch.from_numpy(rs.randn(16, 8)).double()
    V = torch.from_numpy(rs.randn(8, 8)).double()
    A, Bm = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64)
    for g in range(8):
        for t in range(4):
            c0, c1, c2, c3 = P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t], P[g + 8, 2 * t + 1]
            a0, a1, a2, a3 = c0, c2, c1, c3
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a0, a1, a2, a3
            Bm[t, g], Bm[t + 4, g] = V[2 * t, g], V[2 * t + 1, g]
    order = p_key_order()
    assert torch.equal(A, P[:, order]) and torch.equal(Bm, V[order])
    assert torch.allclose(A @ Bm, P @ V)
    assert not torch.allclose(A @ V, P @ V)


# ptxas' -v report of two f32 instantiations, as the build step captures it
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b917flash_kernel_tf32ILi64EEEvPKfS2_S2_PfNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b917flash_kernel_tf32ILi64EEEvPKfS2_S2_PfNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 190 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi64EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi64EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 137 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b917flash_kernel_tf32ILi256EEEvPKfS2_S2_PfNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b917flash_kernel_tf32ILi256EEEvPKfS2_S2_PfNS_6ParamsE
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_smoke_reads_the_f32_instantiations_from_the_ptxas_log():
    """chip_smoke's build report of the f32 entry: the f32 instantiations
    by head width, none of the bf16 kernel's, with the dynamic shared
    memory a launch asks for."""
    smoke = _smoke()
    rep = smoke.flash_tc_report(PTXAS_LOG, lambda D: (64 + 4 * kv_tile(D)) * (D + 4) * 4, "flash_kernel_tf32")
    assert list(rep) == [64, 256]
    assert rep[64] == {"registers": 190, "spill_stores": 0, "spill_loads": 0, "static_smem": 0, "dynamic_smem": 52224}
    assert rep[256] == {"registers": 255, "spill_stores": 8, "spill_loads": 8, "static_smem": 0, "dynamic_smem": 199680}
    assert list(smoke.flash_tc_report(PTXAS_LOG, lambda D: 0)) == [64]
