"""The arithmetic of the bf16 tensor-core flash-attention kernel
(``flash_kernel_tc`` in ``repro_torch/kernels/attention/csrc/flash_attention.cu``),
emulated in plain torch on the CPU.

The kernel reads bf16 q, k, v; forms Q.K^T with fp32 accumulation (the
products of two bf16 values are exact in fp32); runs the online softmax in
fp32 over KV tiles of 64 keys (32 at D 256), weighing a score x by
2^(x w - m w); carries P into the P.V product as two bf16 terms, p_hi =
bf16(p) and p_lo = bf16(p - p_hi); and rounds the output to bf16. The card
holds it against ``attention_ref`` in f32 on the same (upcast) inputs
within ``chip_smoke.FLASH_BF16_ATOL`` + ``FLASH_BF16_RTOL`` |out|. These
tests hold the emulation to that check at every shape of
``test_torch_attention_ssd.ATTN_CASES``, and show that one bf16 term for P
would not meet it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from test_torch_attention_ssd import ATTN_CASES, _attn_inputs, _smoke  # noqa: E402

LOG2E = 1.4426950408889634
NEG = -1e30


def kv_tile(D):
    """Keys per KV tile of the kernel (``Tc<D>::BK``)."""
    return 32 if D == 256 else 64


def emulate_tc(q, k, v, causal=True, window=0, softcap=None, scale=None, split=True):
    """q (B, Sq, Hq, D), k and v (B, Sk, Hk, D) in bf16 -> bf16, rounded
    as the kernel rounds. ``split=False`` carries P as one bf16 term."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    w = LOG2E if softcap else scale * LOG2E
    qf = q.float().permute(0, 2, 1, 3)  # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hq, Sq, 1), NEG)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    bk = kv_tile(D)
    for k0 in range(0, Sk, bk):
        x = qf @ kf[:, :, k0 : k0 + bk].transpose(-1, -2)
        if softcap:
            x = softcap * torch.tanh(x * (scale / softcap))
        kpos = torch.arange(k0, min(k0 + bk, Sk))[None, :]
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window and window > 0:
            ok &= (qpos - kpos) < window
        x = torch.where(ok, x, torch.tensor(NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        mu = torch.where(m_new == NEG, torch.zeros(()), m_new)
        alpha = torch.exp2((m - mu) * w)
        p = torch.exp2(x * w - mu * w)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0 : k0 + bk]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0 : k0 + bk]
        acc = acc * alpha + pv
        m = m_new
    out = (acc / l.clamp_min(1e-30)).bfloat16()
    return out.permute(0, 2, 1, 3)


def _violations(got, want32, atol, rtol):
    return int(((got.float() - want32).abs() > atol + rtol * want32.abs()).sum())


# ATTN_CASES, and gemma2's D 256 softcap class (KV tiles of 32) at a short length
TC_CASES = ATTN_CASES + [dict(B=1, Sq=300, Sk=300, Hq=8, Hk=4, D=256, causal=True, window=128, softcap=50.0)]


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: f"{c['Sq']}x{c['Sk']}-h{c['Hq']}/{c['Hk']}-d{c['D']}-w{c['window']}")
def test_tc_rounding_meets_the_bf16_check(case):
    """The emulated kernel against ``attention_ref`` in f32 on the same
    (upcast) bf16 inputs, at the card's bf16 bar: no element beyond
    ``FLASH_BF16_ATOL`` + ``FLASH_BF16_RTOL`` |out|."""
    smoke = _smoke()
    c = case
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _attn_inputs(c))
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    got = emulate_tc(q, k, v, **kw)
    want32 = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert got.shape == want32.shape and got.dtype == torch.bfloat16
    assert _violations(got, want32, smoke.FLASH_BF16_ATOL, smoke.FLASH_BF16_RTOL) == 0


def test_one_bf16_term_for_p_fails_the_bf16_check():
    """At a Hymba-like shape (window 1024, D 64) P rounded once to bf16
    puts errors of ~2^-9 |p| into outputs near 0, beyond the check; P as
    p_hi + p_lo meets it. So the split is needed, and the check catches
    its absence."""
    smoke = _smoke()
    rs = np.random.RandomState(7)
    B, S, H, D = 1, 2048, 5, 64
    q, k, v = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32)).bfloat16() for _ in range(3))
    kw = dict(causal=True, window=1024)
    want32 = attention_ref(q.float(), k.float(), v.float(), **kw)
    atol, rtol = smoke.FLASH_BF16_ATOL, smoke.FLASH_BF16_RTOL
    one = _violations(emulate_tc(q, k, v, split=False, **kw), want32, atol, rtol)
    two = _violations(emulate_tc(q, k, v, split=True, **kw), want32, atol, rtol)
    assert two == 0
    assert one > 1000, one


# three entries of nvcc -Xptxas -v on csrc/flash_attention.cu, as the build
# step captures them (the bf16 D 256 and D 64 instantiations, the f32 D 256)
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi256EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi256EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE
    16 bytes stack frame, 48 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi64EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b915flash_kernel_tcILi64EEEvPK13__nv_bfloat16S3_S3_PS1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 137 registers, used 1 barriers, 512 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b912flash_kernelIfLi256EEEvPKT_S3_S3_PS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f65d222a_18_flash_attention_cu_3a0ef7b912flash_kernelIfLi256EEEvPKT_S3_S3_PS1_NS_6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_smoke_reads_the_bf16_instantiations_from_the_ptxas_log():
    """chip_smoke's build report: registers, spills and static shared
    memory per entry function, and the bf16 flash instantiations by head
    width with the dynamic shared memory a launch asks for."""
    smoke = _smoke()
    rep = smoke.ptxas_report(PTXAS_LOG)
    assert len(rep) == 3
    f32 = next(r for fn, r in rep.items() if "flash_kernelIf" in fn)
    assert f32 == {"registers": 128, "spill_stores": 4, "spill_loads": 4, "static_smem": 0}
    tc = smoke.flash_tc_report(PTXAS_LOG, lambda D: 1000 + D)
    assert list(tc) == [64, 256]
    assert tc[64] == {"registers": 137, "spill_stores": 0, "spill_loads": 0, "static_smem": 512, "dynamic_smem": 1064}
    assert tc[256] == {"registers": 255, "spill_stores": 48, "spill_loads": 16, "static_smem": 0, "dynamic_smem": 1256}
    assert smoke.flash_tc_report("", lambda D: 0) == {}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bf16_inputs_are_copied_only_off_a_16_byte_boundary(dtype):
    """Both kernels copy 16-byte chunks (the f32 one since its tensor-core
    redesign): a view whose data starts off a 16-byte boundary is copied
    (same values), any other tensor passes through as it is."""
    from repro_torch.kernels.attention.kernel import aligned16

    base = torch.arange(2 * 8 * 64, dtype=torch.float32).to(dtype)
    es = base.element_size()
    whole = base.view(2, 8, 1, 64)
    assert aligned16(whole) is whole
    off = base[1:].narrow(0, 0, 8 * 64).view(1, 8, 1, 64)  # one element past the start
    assert off.is_contiguous() and off.data_ptr() % 16 == es
    moved = aligned16(off)
    assert moved is not off and moved.data_ptr() % 16 == 0 and torch.equal(moved, off)
    kept = 16 // es  # 16 bytes in: kept
    assert aligned16(base[kept:].view(1, -1)).data_ptr() == base.data_ptr() + 16
