"""The arithmetic and the launch geometry of the deconv kernels in
``repro_torch/kernels/deconv/csrc/phase_gemm.cuh`` (``deconv2d`` and the
fused ``deconv_block`` both launch them), emulated in plain torch on the CPU.

The phase GEMM reads a float32 operand v as two TF32 terms, hi =
cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi), and accumulates, for each
8-deep step of K (tap-major: tap 2i+j, then channel), lo.hi + hi.lo + hi.hi
through MMAs that round their sums toward zero, in a fresh chain for each
32-deep K tile that is then added to the fp32 sum; K splits are summed in a
fixed order. The narrow
kernel (Cout <= 4) is fp32 FMA over the channels in order, its warps
splitting the channels at small batches. The card holds the kernels against
the plain version (``deconv2d_ref``) within the port's f32 pin, 1e-4. These
tests hold the emulation to that pin at the generator's up-sampling shapes
and ``deconv_block``'s wide classes, show that one TF32 term would not meet
it, and check that the launch geometry covers every output and every K tile
exactly once.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels.deconv import kernel as dk  # noqa: E402
from repro_torch.kernels.deconv.ref import deconv2d_ref  # noqa: E402
from repro_torch.kernels.fused import ref as fref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once on the
    machine's cores, and with as many threads as cores in each file too,
    this file's small ops ran many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PIN = 1e-4  # the port's f32 pin, kernel against plain version (chip_smoke.Bench.run)
BK, BN = dk.phase_bk(4), dk.PHASE_BN  # the f32 GEMM's K tile and N tile


def tf32_rna(v):
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32),
    as a bit operation: add half a TF32 ulp to the magnitude, clear the 13
    low mantissa bits."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def phase_operands(x, w, pa, pb):
    """Phase (pa, pb)'s GEMM operands: A (B*H*W, 4*Cin) with the crop
    folded in (tap t = 2i + j reads x[u + pa - 1 + i, v + pb - 1 + j], zero
    outside), B (4*Cin, Cout) = w[pa + 2i, pb + 2j] stacked in tap order."""
    _, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    A = torch.cat([xp[:, pa + i : pa + i + H, pb + j : pb + j + W].reshape(-1, C) for i in (0, 1) for j in (0, 1)], 1)
    Bm = torch.cat([w[pa + 2 * i, pb + 2 * j] for i in (0, 1) for j in (0, 1)], 0)
    return A, Bm


def rz32(v):
    """float64 -> float32 rounded toward zero: how an MMA rounds its sum."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def emulate_gemm(x, w, terms=3, chain="tile", geo=None):
    """The phase GEMM's float32 arithmetic: ``terms`` 3 (the kernel) or 1
    (one TF32 product per multiply-add). Each MMA adds its 8 exact products
    to its accumulator and rounds the sum toward zero; ``chain`` "tile" (the
    kernel) runs each 32-deep K tile in a fresh chain added to the running
    sum in fp32, "all" one chain over the whole of K. K splits (``geo``, by
    default ``phase_geometry``'s) are accumulated from zero and summed in
    order."""
    B, H, W, C = x.shape
    cout = w.shape[-1]
    geo = geo or dk.phase_geometry(B, H, W, C, cout)
    y = torch.empty(B, 2 * H, 2 * W, cout)
    for pa in (0, 1):
        for pb in (0, 1):
            A, Bm = phase_operands(x, w, pa, pb)
            ah, bh = tf32_rna(A), tf32_rna(Bm)
            al, bl = tf32_rna(A - ah), tf32_rna(Bm - bh)
            pairs = [(al, bh), (ah, bl), (ah, bh)][3 - terms :]
            pairs = [(a.double(), b.double()) for a, b in pairs]
            live = [kt for kt in range(math.ceil(4 * C / BK)) if _tap_live(kt, C, H, W, pa, pb)]
            total = torch.zeros(A.shape[0], cout)
            for s in range(geo.splitk):
                acc = torch.zeros(A.shape[0], cout)
                for kt in live[s * geo.per : (s + 1) * geo.per]:
                    tacc = torch.zeros_like(acc) if chain == "tile" else acc
                    for k0 in range(kt * BK, min(kt * BK + BK, 4 * C), 8):
                        k = slice(k0, k0 + 8)
                        for a, b in pairs:
                            tacc = rz32(tacc.double() + a[:, k] @ b[k])
                    acc = acc + tacc if chain == "tile" else tacc
                total = total + acc
            y[:, pa::2, pb::2] = total.reshape(B, H, W, cout)
    return y


def _tap_live(kt, C, H, W, pa, pb):
    """Whether K tile ``kt`` holds a tap that reaches an input for some row."""
    for t in range(kt * BK // C, (min(kt * BK + BK, 4 * C) - 1) // C + 1):
        i, j = t >> 1, t & 1
        if max(0, 1 - pa - i) <= min(H - 1, H - pa - i) and max(0, 1 - pb - j) <= min(W - 1, W - pb - j):
            return True
    return False


def narrow_groups(tile_rows):
    """The narrow kernel's channel groups: a warp takes 2 input rows, and
    the block's warps split the channels the rest of the way."""
    return dk.NARROW_WARPS // (tile_rows // 2)


def emulate_narrow(x, w):
    """The narrow kernel's float32 arithmetic: per output, fp32 FMA over the
    channels in order and the taps (i, j) in order, in ``narrow_groups``
    channel groups (c mod groups) added in group order."""
    B, H, W, C = x.shape
    cout = w.shape[-1]
    groups = narrow_groups(dk.phase_geometry(B, H, W, C, cout).tile_rows)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).double()
    wd = w.double()
    y = torch.zeros(B, 2 * H, 2 * W, cout)
    for pa in (0, 1):
        for pb in (0, 1):
            sums = []
            for g in range(groups):
                acc = torch.zeros(B, H, W, cout)
                for c in range(g, C, groups):
                    for i in (0, 1):
                        for j in (0, 1):
                            xv = xp[:, pa + i : pa + i + H, pb + j : pb + j + W, c : c + 1]
                            acc = (xv * wd[pa + 2 * i, pb + 2 * j, c] + acc.double()).float()  # one rounding: FMA
                sums.append(acc)
            total = sums[0]
            for s in sums[1:]:
                total = total + s
            y[:, pa::2, pb::2] = total
    return y


def _inputs(B, H, W, cin, cout, seed=0):
    """chip_smoke's distributions: x ~ N(0, 1), w ~ N(0, 2 / (16 Cin)), bias ~ N(0, 0.01)."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(B, H, W, cin).astype(np.float32))
    w = torch.from_numpy((rs.randn(4, 4, cin, cout) * math.sqrt(2.0 / (16 * cin))).astype(np.float32))
    b = torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32))
    return x, w, b


# the Pix2Pix generator's eight up-sampling calls at img 256, base 64, batch 1
GENERATOR_UPS = [
    (1, 1, 1, 512, 512), (1, 2, 2, 1024, 512), (1, 4, 4, 1024, 512), (1, 8, 8, 1024, 512),
    (1, 16, 16, 1024, 256), (1, 32, 32, 512, 128), (1, 64, 64, 256, 64), (1, 128, 128, 128, 3),
]


@pytest.mark.parametrize("B,H,W,cin,cout", GENERATOR_UPS, ids=lambda v: str(v))
def test_kernel_arithmetic_meets_the_f32_pin(B, H, W, cin, cout):
    """At each generator shape the emulated kernel (3xTF32 GEMM, or the
    narrow kernel's FMA) is within the 1e-4 pin of ``deconv2d_ref`` and
    within twice the plain version's own distance from a float64 result."""
    x, w, b = _inputs(B, H, W, cin, cout)
    got = (emulate_narrow(x, w) if cout <= dk.NARROW_COUT else emulate_gemm(x, w)) + b
    plain = deconv2d_ref(x, w, b)
    exact = deconv2d_ref(x.double(), w.double(), b.double())
    err = (got - plain).abs().max().item()
    assert err <= PIN, err
    assert (got.double() - exact).abs().max().item() <= 2 * (plain.double() - exact).abs().max().item()


@pytest.mark.parametrize("shape,cout", [((1, 1, 1, 512), 512), ((1, 16, 16, 1024), 256), ((1, 64, 64, 256), 64)])
def test_deconv_block_classes_meet_the_f32_pin(shape, cout):
    """``deconv_block``'s wide classes (batch norm + relu after the GEMM):
    the emulated GEMM through the block's plain epilogue is within 1e-4 of
    ``deconv_block_ref``."""
    x, w, b = _inputs(*shape, cout, seed=1)
    gamma, beta = 1 + 0.1 * b, 0.1 * b.flip(0)
    got = fref._epilogue(emulate_gemm(x, w), x.dtype, b, gamma, beta, "batch", 1, "relu", 1e-5)
    want = fref.deconv_block_ref(x, w, b, gamma, beta, norm="batch", act="relu")
    assert (got - want).abs().max().item() <= PIN


def test_one_tf32_term_breaks_the_pin_at_k_4096():
    """At 16x16x1024 -> 256 (K = 4096) one TF32 product per multiply-add
    misses the pin about tenfold; the three-term split meets it. So the
    split is needed, and the card's check would catch its absence."""
    x, w, _ = _inputs(1, 16, 16, 1024, 256)
    plain = deconv2d_ref(x, w)
    one = (emulate_gemm(x, w, terms=1) - plain).abs().max().item()
    three = (emulate_gemm(x, w, terms=3) - plain).abs().max().item()
    assert three <= PIN < one, (three, one)


def test_one_accumulator_chain_over_k_drifts():
    """The MMAs round toward zero: run over all of K = 4096 in one chain (no
    K split), the 3xTF32 sum drifts several times beyond plain fp32's error
    (on the card 1.1e-4 at batch 8, past the pin); a fresh chain per K tile
    stays within twice plain fp32's distance from the float64 result."""
    x, w, _ = _inputs(1, 16, 16, 1024, 256)
    whole = dk.PhaseGeometry(narrow=False, tile_rows=64, vec=True, splitk=1, per=128)
    plain = deconv2d_ref(x, w)
    exact = deconv2d_ref(x.double(), w.double())
    plain_err = (plain.double() - exact).abs().max().item()
    tile = (emulate_gemm(x, w, chain="tile", geo=whole).double() - exact).abs().max().item()
    one = (emulate_gemm(x, w, chain="all", geo=whole).double() - exact).abs().max().item()
    assert tile <= 2 * plain_err and one > 5 * tile, (plain_err, tile, one)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The bit emulation of cvt.rna.tf32: 10 mantissa bits kept, ties away
    from zero, and hi + lo recovers v to about 2^-22 |v|."""
    ulp = 2.0**-10
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-20, 1 + 1.5 * ulp, 3.0, 0.0])
    assert tf32_rna(v).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0]
    r = torch.randn(10000)
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    assert ((hi + lo - r).abs() <= 2.0**-21 * r.abs()).all()
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()


# ------------------------------------------------------------ geometry

GEO_CASES = [
    (1, 1, 1, 512, 512), (1, 2, 2, 1024, 512), (1, 8, 8, 1024, 512), (1, 16, 16, 1024, 256),
    (1, 32, 32, 512, 128), (1, 64, 64, 256, 64), (8, 1, 1, 512, 512), (8, 4, 4, 1024, 512),
    (8, 16, 16, 1024, 256), (8, 32, 32, 512, 128), (8, 64, 64, 256, 64), (1, 8, 8, 4, 8),
    (2, 16, 12, 8, 16), (2, 4, 4, 3, 5), (2, 8, 8, 40, 64), (2, 5, 7, 32, 6), (1, 1, 3, 16, 8),
]


def _rows_live(m, H, W, pa, pb):
    """(rows, 4) bool: whether tap t reaches an input for GEMM row m."""
    r = m % (H * W)
    u, v = r // W, r % W
    out = np.zeros((len(m), 4), bool)
    for t in range(4):
        ih, iw = u + pa - 1 + (t >> 1), v + pb - 1 + (t & 1)
        out[:, t] = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
    return out


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,cin,cout", GEO_CASES, ids=lambda v: str(v))
def test_phase_gemm_geometry_covers_every_output_and_k_once(B, H, W, cin, cout, esize):
    """The grid (row tiles x column tiles x 4 phases x splits), each block
    voting on its live taps and taking its split's share of its live K
    tiles, covers every (phase, row, K tile) that reaches an input exactly
    once and no other, and every output column once; inside a tile the
    warps' fragments cover each (row, column) once, and the staging copies
    each A and B chunk once."""
    geo = dk.phase_geometry(B, H, W, cin, cout, esize)
    assert not geo.narrow and geo.tile_rows in (64, 128) and (geo.tile_rows == 64 or geo.vec)
    M, K, bm, bk = B * H * W, 4 * cin, geo.tile_rows, dk.phase_bk(esize)
    nkt = math.ceil(K / bk)
    tile_taps = [list(range(kt * bk // cin, (min(kt * bk + bk, K) - 1) // cin + 1)) for kt in range(nkt)]
    for pa in (0, 1):
        for pb in (0, 1):
            rows_live = _rows_live(np.arange(M), H, W, pa, pb)
            need = np.stack([rows_live[:, taps].any(1) for taps in tile_taps], 1)  # (M, nkt)
            count = np.zeros((M, nkt), int)
            for m0 in range(0, M, bm):
                vote = rows_live[m0 : m0 + bm].any(0)
                live = [kt for kt in range(nkt) if vote[tile_taps[kt]].any()]
                assert len(live) <= geo.splitk * geo.per
                for s in range(geo.splitk):
                    count[m0 : m0 + bm, live[s * geo.per : (s + 1) * geo.per]] += 1
            assert count.max() <= 1 and (count[need] == 1).all()
    cols = np.zeros(cout, int)
    for n0 in range(0, cout, BN):
        cols[n0 : n0 + BN] += 1
    assert (cols == 1).all()
    # the kernel's index maps inside a tile: warp tiles wr x 32 (wr 64 for
    # the f32 128-row tile, else 32), (bm / wr) x 2 warps
    wr = 64 if esize == 4 and bm == 128 else 32
    threads = 64 * bm // wr
    frag = np.zeros((bm, BN), int)
    for warp in range(threads // 32):
        wm, wn = warp >> 1, warp & 1
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for mi in range(wr // 16):
                for h in range(2):
                    for ni in range(4):
                        for e in range(2):
                            frag[wm * wr + mi * 16 + g + 8 * h, wn * 32 + ni * 8 + 2 * t + e] += 1
    assert (frag == 1).all() and threads >= bm  # a thread per row for the tap vote
    epc = 16 // esize
    cpr, cpb = bk // epc, BN // epc
    a = np.zeros((bm, cpr), int)
    for tid in range(threads):
        for i in range(bm * cpr // threads):
            a[tid // cpr + i * (threads // cpr), tid % cpr] += 1
    b = np.zeros(bk * cpb, int)
    for tid in range(threads):
        b[tid : bk * cpb : threads] += 1
    assert (a == 1).all() and (b == 1).all()


@pytest.mark.parametrize(
    "B,H,W,cout",
    [(1, 128, 128, 3), (8, 128, 128, 3), (1, 8, 8, 3), (2, 4, 4, 1), (1, 9, 70, 2), (3, 7, 5, 4), (2, 130, 66, 3)],
    ids=lambda v: str(v),
)
def test_narrow_kernel_writes_every_output_pixel_of_every_phase_once(B, H, W, cout):
    """The narrow grid (64-column x tile_rows-row blocks of 4 warps; a warp
    takes a row pair and a channel group, a thread 2 x 2 input positions,
    and group 0 writes) writes each output pixel of each phase once, and
    every thread's reads (input rows u-1..u+2, columns v-1..v+2) fall inside
    the block's staged tile."""
    geo = dk.phase_geometry(B, H, W, 128, cout)
    assert geo.narrow and geo.tile_rows in (2, 4, 8)
    tr = geo.tile_rows
    pairs, groups = tr // 2, narrow_groups(tr)
    assert pairs * groups == dk.NARROW_WARPS
    count = np.zeros((B, 2 * H, 2 * W), int)
    lane = np.arange(32)
    for b in range(B):
        for row0 in range(0, H, tr):
            for col0 in range(0, W, dk.NARROW_COLS):
                for warp in range(dk.NARROW_WARPS):
                    rp, ks = warp % pairs, warp // pairs
                    assert 2 * rp + 3 < tr + 2 and 2 * lane.max() + 3 < dk.NARROW_COLS + 2
                    if ks:
                        continue
                    for q in (0, 1):
                        u = row0 + 2 * rp + q
                        if u >= H:
                            continue
                        for p in (0, 1):
                            v = col0 + 2 * lane + p
                            v = v[v < W]
                            for a in (0, 1):
                                for bb in (0, 1):
                                    np.add.at(count[b], (2 * u + a, 2 * v + bb), 1)
    assert (count == 1).all()


# ------------------------------------------------------------ build and report


def test_library_name_follows_the_included_headers(tmp_path):
    """``_build`` names a library by the source and every local header it
    reaches (recursively, each once, a cycle included), so an edit to a
    header builds anew; system headers and unrelated files do not count."""
    from repro_torch.kernels import _build

    (tmp_path / "sub").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "sub/a.cuh"\nint f() { return 0; }\n')
    (tmp_path / "sub" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text('#pragma once\n  #  include "a.cuh"\nconstexpr int B = 1;\n')
    (tmp_path / "other.cuh").write_text("constexpr int C = 1;\n")
    assert _build.local_sources(src) == [src, tmp_path / "sub" / "a.cuh", tmp_path / "sub" / "b.cuh"]
    first = _build.library_path(src, tmp_path / "build")
    (tmp_path / "other.cuh").write_text("constexpr int C = 2;\n")
    assert _build.library_path(src, tmp_path / "build") == first
    (tmp_path / "sub" / "b.cuh").write_text('#pragma once\n  #  include "a.cuh"\nconstexpr int B = 2;\n')
    second = _build.library_path(src, tmp_path / "build")
    assert second != first and second.name.startswith("libk_") and second.parent == tmp_path / "build"
    # the two kernel libraries that include phase_gemm.cuh
    root = dk._SRC.parent.parent.parent
    header = dk._SRC.parent / "phase_gemm.cuh"
    for cu in (dk._SRC, root / "fused" / "csrc" / "fused_blocks.cu"):
        assert header.resolve() in _build.local_sources(cu)


# three entries of nvcc -Xptxas -v on csrc/deconv2d.cu, as the build step
# captures them (the f32 128-row GEMM, the bf16 scalar-staging GEMM, the f32
# narrow kernel for Cout 3)
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110phase_gemm17phase_gemm_kernelIfLi128ELb1EEEvPKT_S4_PKfPS2_PfNS0_9PhaseGeomE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110phase_gemm17phase_gemm_kernelIfLi128ELb1EEEvPKT_S4_PKfPS2_PfNS0_9PhaseGeomE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110phase_gemm17phase_gemm_kernelI13__nv_bfloat16Li64ELb0EEEvPKT_S5_PKfPS3_PfNS0_9PhaseGeomE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110phase_gemm17phase_gemm_kernelI13__nv_bfloat16Li64ELb0EEEvPKT_S5_PKfPS3_PfNS0_9PhaseGeomE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 70 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110phase_gemm13narrow_kernelIfLi3EEEvPKT_S4_PKfPS2_NS0_9PhaseGeomEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110phase_gemm13narrow_kernelIfLi3EEEvPKT_S4_PKfPS2_NS0_9PhaseGeomEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_smoke_reads_the_phase_instantiations_from_the_ptxas_log():
    """chip_smoke's build report of the phase GEMM and narrow
    instantiations: registers, spills, and the dynamic shared memory a
    launch asks for."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rep = smoke.phase_report(PTXAS_LOG, lambda esize, narrow, rows: 1000 * esize + 100 * narrow + rows)
    assert list(rep) == ["narrow<f32,3>", "phase_gemm<bf16,64,scalar>", "phase_gemm<f32,128,vec>"]
    assert rep["phase_gemm<f32,128,vec>"] == {"registers": 128, "spill_stores": 0, "spill_loads": 0,
                                              "static_smem": 0, "dynamic_smem": 4128}
    assert rep["phase_gemm<bf16,64,scalar>"]["spill_stores"] == 4
    assert rep["narrow<f32,3>"]["dynamic_smem"] == 108
    assert smoke.phase_report("", lambda *a: 0) == {}
