"""The port's abstract trees and dry-run bookkeeping against the JAX package,
on the CPU with nothing allocated: ``abstract_state`` of the optimizers,
``init_caches(abstract=True)`` of every architecture at full width, the
dry-run specs (``model_flops_estimate``, ``_train_batch``) against
``repro.launch.specs`` imported with the one function its JAX package
lacks stubbed (nothing in the JAX package changes), the ``Roofline``
formulas against ``repro.launch.roofline``'s, and ``cache_shardings`` on
mock 256- and 512-rank meshes. JAX builds only ``ShapeDtypeStruct``s here:
nothing compiles.
"""
import math
import sys

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import cache_shardings, default_rules  # noqa: E402
from repro_torch.dist.sharding import _CACHE_AXES  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402
from repro_torch.train import SGD, AdamW  # noqa: E402
from repro_torch.train import optimizer as toptimizer  # noqa: E402

MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _PortMesh:
    """A DeviceMesh's shape and dim names, without ranks."""

    def __init__(self, sizes):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())


def _sig(tree):
    """A tree's structure with each leaf as (shape, torch dtype): JAX
    ``ShapeDtypeStruct``s and torch tensors alike (lists and tuples as lists)."""
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_sig(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return tuple(tree.shape), tree.dtype
    return tuple(tree.shape), DTYPES[jnp.dtype(tree.dtype)]


def _models(arch):
    return jconfigs.build_model(jconfigs.get_arch(arch).config), tconfigs.build_model(tconfigs.get_arch(arch).config)


# ----------------------------------------------------------------- (a) optimizer


@pytest.mark.parametrize("opt", ["adamw", "adamw_master", "sgd"])
@pytest.mark.parametrize("arch", ["gemma2_2b", "whisper_small"])
def test_abstract_state_equals_jax(arch, opt):
    """``abstract_state`` of the full-width parameter tree: JAX's tree,
    shape and dtype for dtype (f32 moments and master copy, an int32 step)."""
    jm, tm = _models(arch)
    make = {"adamw": lambda mod: mod.AdamW(), "adamw_master": lambda mod: mod.AdamW(master_weights=True),
            "sgd": lambda mod: mod.SGD()}[opt]
    want = make(joptimizer).abstract_state(jm.abstract(jnp.bfloat16))
    got = make(toptimizer).abstract_state(tm.abstract(torch.bfloat16))
    assert _sig(got) == _sig(want)
    assert ("master" in got) == (opt == "adamw_master")


def test_abstract_state_has_init_dtypes():
    """The abstract tree is ``init``'s, shapes and dtypes, for a real tree."""
    tm = tconfigs.build_model(tconfigs.get_arch("mamba2_2_7b").smoke)
    params = tm.init(torch.Generator().manual_seed(0))
    for opt in (AdamW(master_weights=True), SGD()):
        want = opt.init(params)
        got = opt.abstract_state(tm.abstract())
        assert [(tuple(t.shape), t.dtype) for t in tree_leaves(got)] == \
            [(tuple(t.shape), t.dtype) for t in tree_leaves(want)]


# -------------------------------------------------------------------- (b) caches


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_caches_equal_jax(arch):
    """For every architecture at full width, ``init_caches(abstract=True)``
    is JAX's ``init_caches(abstract=True)`` leaf for leaf (scanned caches
    stacked on the layer dim) and the port's ``init_caches(device="meta")``."""
    jm, tm = _models(arch)
    B, S = 4, 8192
    want = jm.init_caches(B, S, dtype=jnp.bfloat16, abstract=True)
    got = tm.init_caches(B, S, dtype=torch.bfloat16, abstract=True)
    assert _sig(got) == _sig(want)
    assert _sig(tm.init_caches(B, S, dtype=torch.bfloat16, device="meta")) == _sig(got)


def test_block_abstract_caches_are_init_caches():
    """Every ``abstract_cache`` is its module's ``init_cache`` as meta tensors."""
    from repro_torch.models.lm import LMBlock

    for arch in ("gemma2_2b", "deepseek_v2_lite_16b"):
        blk = LMBlock(tconfigs.get_arch(arch).config, use_moe=False)
        assert _sig(blk.abstract_cache(2, 64)) == _sig(blk.init_cache(2, 64, device="meta"))
    mixer = tconfigs.get_arch("mamba2_2_7b").config.block()
    assert _sig(mixer.abstract_cache(2)) == _sig(mixer.init_cache(2, device="meta"))


# ------------------------------------------------------------- (c) JAX specs


@pytest.fixture
def jax_specs(monkeypatch):
    """``repro.launch.specs`` imported with ``cache_shardings`` (which its
    ``dist.sharding`` lacks) stubbed on that module; dropped afterwards."""
    monkeypatch.setattr(jsharding, "cache_shardings", lambda *a, **k: None, raising=False)
    sys.modules.pop("repro.launch.specs", None)
    import repro.launch.specs as mod

    yield mod
    sys.modules.pop("repro.launch.specs", None)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_flops_estimate_equals_jax(arch, jax_specs):
    for shape in tconfigs.SHAPES:
        got = tspecs.model_flops_estimate(tconfigs.get_arch(arch), shape)
        assert got == jax_specs.model_flops_estimate(jconfigs.get_arch(arch), shape), shape


@pytest.mark.parametrize("arch", ["gemma2_2b", "qwen2_vl_7b", "whisper_small"])
def test_train_batch_equals_jax(arch, jax_specs):
    """``_train_batch``: JAX's keys, shapes and dtypes (M-RoPE's positions
    and patch embeddings, Whisper's frames), each leaf sharded as a batch."""
    assert tspecs.N_IMG_PATCHES == jax_specs.N_IMG_PATCHES
    want, _ = jax_specs._train_batch(jconfigs.get_arch(arch), 256, 4096, None, None)
    got, sh = tspecs._train_batch(tconfigs.get_arch(arch), 256, 4096, "bsh", "rep")
    assert _sig(got) == _sig(want)
    assert sh == {k: "bsh" for k in got}


# ---------------------------------------------------------------- (d) roofline


class _Compiled:
    """What the JAX ``analyze`` reads of a compiled program, from numbers."""

    def __init__(self, flops, bytes_accessed, hlo, mem):
        self._ca, self._hlo, self._mem = {"flops": flops, "bytes accessed": bytes_accessed}, hlo, mem

    def cost_analysis(self):
        return [self._ca]

    def as_text(self):
        return self._hlo

    def memory_analysis(self):
        return self._mem


def test_roofline_equals_jax_formulas():
    """On the same numbers, ``analyze`` and ``Roofline`` give JAX's fields,
    properties and ``row()`` keys; each time term is the JAX one with the
    TPU peak swapped for the H100's."""
    from types import SimpleNamespace

    from repro.core import engine as jengine
    from repro.launch import roofline as jroofline

    assert troofline.DTYPE_BYTES == jroofline.DTYPE_BYTES
    assert troofline.COLLECTIVE_OPS == jroofline.COLLECTIVE_OPS
    for dtype, name in troofline.DTYPE_NAMES.items():
        assert troofline.tensor_bytes(torch.empty(3, dtype=dtype, device="meta")) == 3 * torch.empty(
            0, dtype=dtype).element_size() == 3 * jroofline.DTYPE_BYTES[name]
    hlo = ("ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
           "  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), to_apply=%sum\n"
           "  %ag = bf16[64,32]{1,0} all-gather(bf16[4,32]{1,0} %q), dimensions={0}\n"
           "}\n")
    mem = SimpleNamespace(argument_size_in_bytes=100, output_size_in_bytes=20, temp_size_in_bytes=7,
                          generated_code_size_in_bytes=0)
    flops, bytes_acc, analytic, analytic_bytes, n = 3.0e12, 5.0e9, 4.0e15, 2.0e9, 256
    want = jroofline.analyze("a", "s", "16x16", n, _Compiled(flops, bytes_acc, hlo, mem), 1.0e15, analytic,
                             analytic_bytes)
    coll = jroofline.parse_collective_bytes(hlo)
    counts = troofline.RankCounts(flops, bytes_acc, {k: coll[k] for k in jroofline.COLLECTIVE_OPS}, coll["counts"],
                                  {"arguments": 100, "outputs": 20, "temps": 7, "code": 0, "total": 127})
    got = troofline.analyze("a", "s", "16x16", n, counts, 1.0e15, analytic, analytic_bytes)
    for field in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device", "collective_counts",
                  "model_flops", "hlo_flops_global", "memory_per_device", "loop_correction", "hlo_flops_raw",
                  "bytes_upper_bound"):
        assert getattr(got, field) == getattr(want, field), field
    tpu = {"compute": jengine.TPU_V5E_BF16_FLOPS, "memory": jengine.TPU_V5E_HBM_BW, "collective": jengine.TPU_V5E_ICI_BW}
    h100 = {"compute": troofline.H100_BF16_FLOPS, "memory": troofline.H100_HBM_BW,
            "collective": troofline.H100_LINK_BW}
    for term in tpu:
        t_got, t_want = getattr(got, f"t_{term}"), getattr(want, f"t_{term}")
        assert t_got * h100[term] == pytest.approx(t_want * tpu[term], rel=1e-12)
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.t_total == max(got.t_compute, got.t_memory, got.t_collective)
    assert got.bottleneck == max(("compute", "memory", "collective"), key=lambda k: getattr(got, f"t_{k}"))
    assert got.roofline_fraction == pytest.approx(1.0e15 / n / troofline.H100_BF16_FLOPS / got.t_total, rel=1e-12)
    assert want.roofline_fraction == pytest.approx(1.0e15 / n / tpu["compute"] / want.t_total, rel=1e-12)
    row, jrow = got.row(), want.row()
    assert list(row) == list(jrow)
    assert row["t_memory_upper_s"] * troofline.H100_HBM_BW == pytest.approx(jrow["t_memory_upper_s"] * tpu["memory"])


# ------------------------------------------------------------ (e) cache shardings


def _cache_cases():
    for arch in tconfigs.ARCH_IDS:
        for mesh in sorted(MESHES):
            yield arch, mesh


def _fitted(names, dim, sizes):
    """The spec entry of ``names`` on a dim: its longest prefix dividing it."""
    while names and dim % math.prod(sizes[n] for n in names):
        names = names[:-1]
    return None if not names else names if len(names) > 1 else names[0]


def _leaves_with_keys(tree, key=None):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_with_keys(v, k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_with_keys(v, key)]
    return [(key, tree)]


@pytest.mark.parametrize("arch,mesh", list(_cache_cases()))
def test_cache_shardings_properties(arch, mesh):
    """On the mock production meshes, for a B=128 (32k) and a B=1 (512k,
    sequence-parallel) decode cache of every architecture at full width:
    every placement divides its dim; B=128 shards the batch over the data
    dims and B=1 the sequence dim in its place (over the data dims that
    divide it: Whisper's 1,500 frames take "pod" alone); KV and SSM heads go over
    "model" where 16 divides them; stacked leaves keep their layer dim
    whole."""
    sizes = MESHES[mesh]
    pm = _PortMesh(sizes)
    rules = default_rules(False, tuple(sizes))
    data = rules["batch"]
    data_entry = data if len(data) > 1 else data[0]
    tm = tconfigs.build_model(tconfigs.get_arch(arch).config)
    for B, S in ((128, 32768), (1, 524288)):
        caches = tm.init_caches(B, S, abstract=True)
        shardings = cache_shardings(pm, caches, rules, seq_sharded=B == 1)
        for (key, x), (_, sh) in zip(_leaves_with_keys(caches), _leaves_with_keys(shardings)):
            spec = tuple(sh.spec)
            assert len(spec) == x.ndim and sh.mesh is pm
            for entry, dim in zip(spec, x.shape):
                names = () if entry is None else (entry,) if isinstance(entry, str) else entry
                assert dim % math.prod(sizes[n] for n in names) == 0, (key, spec, x.shape)
            lead = x.ndim - len(_CACHE_AXES[key])
            assert lead in (0, 1) and spec[:lead] == (None,) * lead, (key, spec)
            batch, rest = spec[lead], spec[lead + 1:]
            if B == 1:
                assert batch is None
                if key in ("k", "v", "c_kv", "k_r", "cross_k", "cross_v"):
                    assert rest[0] == _fitted(data, x.shape[lead + 1], sizes), (key, spec)
            else:
                assert batch == data_entry and (key in ("conv", "ssm") or rest[0] is None), (key, spec)
            if key in ("k", "v", "cross_k", "cross_v", "ssm"):
                heads = x.shape[lead + (2 if key != "ssm" else 1)]
                assert spec[lead + (2 if key != "ssm" else 1)] == ("model" if heads % 16 == 0 else None), (key, spec)

