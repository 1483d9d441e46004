"""The PyTorch port's distributed stack in one process, against the JAX
package on the CPU: the sharding rules (``default_rules``,
``spec_for_axes``, ``_fit_spec``, ``spec_for_axes_shaped``) over every
architecture's full-width ``axes()``/``abstract()`` trees on mock
256- and 512-rank meshes, the ``axes()`` trees themselves, ``cast_tree``,
and the compressed gradients' arithmetic (``mesh=None``); then, on a
world-1 gloo group, the ``train_shardings`` plumbing, ``device_put``,
``shard_batch``, the meshes and ``maybe_initialize_distributed``. Only
``specs()`` are read for the full-width trees: nothing is allocated and
no JAX init compiles. Multi-rank runs are in ``test_torch_dist_ranks.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import compress as jcompress  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    NamedSharding,
    PartitionSpec as P,
    default_rules,
    device_put,
    make_compressed_dp_grad_fn,
    spec_for_axes,
    spec_for_axes_shaped,
    train_shardings,
    zeros_like_error,
)
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.launch import distributed as tdistributed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LMConfig, TransformerLM  # noqa: E402
from repro_torch.nn.module import cast_tree, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import AdamW  # noqa: E402

MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}
# every model family of both packages: the LM zoo and the paper's two models
ARCHS = tconfigs.ARCH_IDS + ("pix2pix_mri", "yolov8_stroke")


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


class _JaxMesh:
    def __init__(self, sizes):
        self.shape, self.axis_names = dict(sizes), tuple(sizes)


def _models(arch):
    return jconfigs.build_model(jconfigs.get_arch(arch).config), tconfigs.build_model(tconfigs.get_arch(arch).config)


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture
def group(tmp_path):
    """A world-1 gloo process group for the test, destroyed after it."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), world_size=1, rank=0)
    yield
    dist.destroy_process_group()


# ------------------------------------------------------------- vs the JAX package


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_equals_jax(arch):
    """``Module.axes()`` (``Stacked`` prepending "layers") is the JAX
    model's tree at full width, and lines up leaf for leaf with
    ``abstract()``'s shapes."""
    jm, tm = _models(arch)
    got, want = tm.axes(), jm.axes()
    assert got == want
    shapes = [tuple(t.shape) for t in tree_leaves(tm.abstract())]
    axes = tree_leaves(tsharding.tree_shardings(_PortMesh(MESHES["pod"]), got, {}))
    assert len(axes) == len(shapes) == len(_jax_leaves(want))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_functions_equal_jax(arch, mesh):
    """On the mock production meshes, ``default_rules`` (model sharding on
    and off) and, for every parameter, ``spec_for_axes`` and the
    divisibility-fitted ``spec_for_axes_shaped`` (through ``_fit_spec``)
    give the JAX package's specs entry for entry."""
    sizes = MESHES[mesh]
    pm, jm_ = _PortMesh(sizes), _JaxMesh(sizes)
    jm, tm = _models(arch)
    axes = _jax_leaves(jm.axes())
    shapes = [tuple(s.shape) for s in jax.tree.leaves(jm.abstract())]
    assert [tuple(t.shape) for t in tree_leaves(tm.abstract())] == shapes
    for shard_model in (True, False):
        rules = default_rules(shard_model, tuple(sizes))
        assert rules == jsharding.default_rules(shard_model, tuple(sizes))
        for ax, shape in zip(axes, shapes):
            assert tuple(spec_for_axes(ax, rules)) == tuple(jsharding.spec_for_axes(ax, rules)), ax
            got = spec_for_axes_shaped(ax, shape, pm, rules)
            want = jsharding.spec_for_axes_shaped(ax, shape, jm_, rules)
            assert isinstance(got, P) and tuple(got) == tuple(want), (ax, shape)


@pytest.mark.parametrize("spec,shape", [
    ((None, "data", None, "model", None), (4, 32, 64, 1, 16)),
    ((("model", "data"), None), (256000, 2304)),
    ((("model", "data"),), (48,)),
    (("data", ("pod", "model")), (6, 64)),
])
def test_fit_spec_equals_jax(spec, shape):
    sizes = MESHES["multipod"]
    assert tsharding._fit_spec(spec, shape, _PortMesh(sizes)) == jsharding._fit_spec(spec, shape, _JaxMesh(sizes))


def test_cast_tree_equals_jax():
    """Floating leaves are cast, integer leaves kept, in a nested tree."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "n": [np.arange(5, dtype=np.int32), {"b": rng.standard_normal(7).astype(np.float32)}]}
    want = jmodule.cast_tree(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    got = cast_tree(tree_map(torch.from_numpy, tree), torch.bfloat16)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def _compress_inputs():
    rng = np.random.default_rng(0)
    return ({"w": np.ones((8, 4), np.float32)},
            {"x": rng.standard_normal((16, 8)).astype(np.float32),
             "y": rng.standard_normal((16, 4)).astype(np.float32)})


def test_compressed_gradients_equal_jax_arithmetic():
    """``mesh=None``: two error-feedback steps of the port against the JAX
    grad fn on the same numpy inputs, within one quantization step per
    element; and the exchange loses nothing: ``deq + n_chunks * resid``
    is the total (gradient + carried residual) to 1e-6."""
    params, batch = _compress_inputs()
    tgf = make_compressed_dp_grad_fn(lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), None, P(("pod", "data")))
    jgf = jcompress.make_compressed_dp_grad_fn(lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), None,
                                               JP(("pod", "data")))
    tp, tb = tree_map(torch.from_numpy, params), tree_map(torch.from_numpy, batch)
    true = torch.autograd.grad(torch.mean((tb["x"] @ tp["w"].requires_grad_() - tb["y"]) ** 2), tp["w"])[0]
    tp["w"] = tp["w"].detach()
    terr, jerr = zeros_like_error(tp, 2), jcompress.zeros_like_error(params, 2)
    for _ in range(2):
        total = true + terr["w"].sum(0)
        (tg, terr), (jg, jerr) = tgf(tp, tb, terr), jgf(params, batch, jerr)
        step = float(total.abs().max()) / 127
        assert float((tg["w"] - torch.from_numpy(np.array(jg["w"]))).abs().max()) <= step
        assert float((tg["w"] - true).abs().max()) <= step  # scale/2 off the total, which is <= scale/2 off
        torch.testing.assert_close(tg["w"] + 2 * terr["w"][0], total, rtol=0, atol=1e-6)
        assert torch.equal(terr["w"][0], terr["w"][1])
        np.testing.assert_allclose(terr["w"].numpy(), np.asarray(jerr["w"]), rtol=0, atol=step)


# ----------------------------------------------------------- one-rank group


def _tiny_lm():
    cfg = LMConfig(name="t", n_layers=1, d_model=32, n_q=2, n_kv=1, head_dim=16, d_ff=64, vocab=128,
                   act_dtype=torch.float32)
    return TransformerLM(cfg)


def test_train_shardings_plumbing(group):
    """The port of the JAX package's ``test_train_shardings_plumbing``: every
    parameter gets a ``NamedSharding``, the moments mirror the parameter
    shardings exactly, the step counter replicates, master weights follow
    the parameters, and the whole tree places as DTensors on the mesh."""
    lm = _tiny_lm()
    params = lm.init(torch.Generator().manual_seed(0))
    opt_state = AdamW(lr=1e-3).init(params)
    mesh = tmesh.make_host_mesh(1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    sh = train_shardings(mesh, lm.axes(), lm.abstract(), opt_state, batch_size=4)
    assert all(isinstance(s, NamedSharding) for s in tree_leaves(sh.params))
    assert sh.opt_state["m"] == sh.params and sh.opt_state["v"] == sh.params
    assert sh.opt_state["step"].spec == P()
    assert sh.batch == NamedSharding(mesh, P("data"))
    emb = sh.params["embed"]["table"]  # its vocab dim names both mesh dims, each of one rank
    assert emb.spec == P(("model", "data"), None) and emb.placements == (Replicate(), Replicate())
    opt_mw = AdamW(lr=1e-3, master_weights=True).init(params)
    sh2 = train_shardings(mesh, lm.axes(), lm.abstract(), opt_mw, batch_size=4)
    assert sh2.opt_state["master"] == sh2.params
    placed, placed_state = device_put(params, sh.params), device_put(opt_state, sh.opt_state)
    for a, b, s in zip(tree_leaves(placed), tree_leaves(params), tree_leaves(sh.params)):
        assert isinstance(a, DTensor) and a.placements == s.placements and torch.equal(a.full_tensor(), b)
    assert placed_state["step"].placements == (Replicate(), Replicate())


def test_named_sharding_placements_order_blocks_by_mesh_dim():
    """A dim split over two mesh dims is ``Shard(d)`` on both, whatever the
    spec's order; a mesh dim of one rank is left out of the placements (and
    of the DTensor's mesh) where the mesh has a dim of more than one; an
    unknown mesh name raises."""
    mesh = _PortMesh({"data": 2, "model": 4})
    assert NamedSharding(mesh, P(("model", "data"), None)).placements == (Shard(0), Shard(0))
    assert NamedSharding(mesh, P(None, "model")).placements == (Replicate(), Shard(1))
    assert NamedSharding(_PortMesh({"data": 2, "model": 1}), P("model", "data")).placements == (Shard(1),)
    assert NamedSharding(_PortMesh({"data": 1, "model": 2}), P(None, "data")).placements == (Replicate(),)
    with pytest.raises(ValueError, match="pod"):
        NamedSharding(mesh, P("pod")).placements


def test_shard_batch_on_one_rank(group):
    """On one rank the DTensor's block is the whole host batch; without a
    sharding the leaves come back as CPU tensors."""
    mesh = tmesh.make_host_mesh(1, device="cpu")
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(4, 6), "labels": np.ones((4, 6), np.int32)}
    got = shard_batch(batch, NamedSharding(mesh, P("data")))
    for k, v in got.items():
        assert isinstance(v, DTensor) and v.placements == (Replicate(), Replicate())
        assert torch.equal(v.to_local(), torch.from_numpy(batch[k])) and tuple(v.shape) == (4, 6)
    plain = shard_batch(batch)
    assert all(type(v) is torch.Tensor and torch.equal(v, torch.from_numpy(batch[k])) for k, v in plain.items())


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_raises_without_its_ranks(multi_pod, need):
    with pytest.raises(RuntimeError, match=f"need {need} ranks"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_host_mesh_makes_and_keeps_a_world_one_group():
    """Without a group, ``make_host_mesh`` makes a world-1 gloo group on the
    CPU; a model axis that does not divide the ranks raises."""
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_host_mesh(1, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo" and mesh.device_type == "cpu"
        with pytest.raises(RuntimeError, match="does not divide 1 ranks"):
            tmesh.make_host_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_maybe_initialize_distributed_without_a_coordinator(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NPROC", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdistributed.maybe_initialize_distributed() is False
    assert tdistributed.maybe_initialize_distributed(None, 2, 0, device="cpu") is False
    assert not dist.is_initialized()
    assert tdistributed.backend_for("cpu") == "gloo" and tdistributed.backend_for("cuda") == "nccl"


def test_launcher_trains_on_a_one_rank_mesh_like_the_plain_step():
    """``launch.train.main`` on the CPU: DTensor parameters on a one-rank
    mesh, the same losses as ``make_lm_train_step`` on plain tensors over
    the same batches, and the group it made is gone after it."""
    from repro_torch.data import token_batches
    from repro_torch.train import make_lm_train_step
    from repro_torch.train.optimizer import warmup_cosine

    out = launch_train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--log-every", "1"])
    assert not dist.is_initialized()
    assert all(isinstance(t, DTensor) for t in tree_leaves(out.params))
    spec = tconfigs.get_arch("gemma2_2b")
    cfg = dataclasses.replace(spec.smoke, act_dtype=torch.float32)
    model = tconfigs.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=warmup_cosine(1e-3, 50, 2), weight_decay=0.01)
    state, step = opt.init(params), make_lm_train_step(model, opt, donate=True)
    losses = []
    for _, b in zip(range(2), token_batches(2, 16, cfg.vocab, seed=0)):
        params, state, m = step(params, state, tree_map(torch.from_numpy, b))
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in out.history] == losses
    for a, b in zip(tree_leaves(out.params), tree_leaves(params)):
        assert torch.equal(a.to_local(), b)


def _one_rank_step(arch, policy=None, S=16):
    """(mesh-step loss, aux, parameters; plain-step loss, aux, parameters)
    of one AdamW step of ``arch``'s smoke config on a batch of 2 x S."""
    from repro_torch.dist import on_mesh
    from repro_torch.train import make_lm_train_step

    spec = tconfigs.get_arch(arch)
    cfg = dataclasses.replace(spec.smoke, act_dtype=torch.float32)
    if policy:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    model = tconfigs.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    host = {k: rng.integers(0, cfg.vocab, (2, S)).astype(np.int32) for k in ("tokens", "labels")}
    if spec.family == "whisper":
        host["frames"] = rng.standard_normal((2, cfg.n_frames, cfg.d_model)).astype(np.float32)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    ref_p = tree_map(torch.clone, params)
    ref_p, _, ref_m = make_lm_train_step(model, opt, donate=True)(ref_p, opt.init(ref_p),
                                                                   tree_map(torch.from_numpy, host))
    mesh = tmesh.make_host_mesh(1, device="cpu")
    try:
        state = opt.init(params)
        sh = train_shardings(mesh, model.axes(), model.abstract(), state, 2)
        p, s = device_put(params, sh.params), device_put(state, sh.opt_state)
        p, s, m = on_mesh(make_lm_train_step(model, opt, donate=True))(p, s, shard_batch(host, sh.batch))
    finally:
        dist.destroy_process_group()
    return (m, [t.to_local() for t in tree_leaves(p)]), (ref_m, tree_leaves(ref_p))


@pytest.mark.parametrize("arch,policy", [("deepseek_moe_16b", "dots"), ("deepseek_v2_lite_16b", "full"),
                                         ("mamba2_2_7b", None), ("whisper_small", None), ("hymba_1_5b", None)])
def test_every_lm_family_steps_on_a_one_rank_mesh(arch, policy):
    """One step of each LM family (MoE's sort-based dispatch, MLA, the SSD
    scan over two chunks, Whisper's encoder-decoder, Hymba; remat on, with
    the "dots" policy where given) over DTensors on a one-rank mesh: the
    loss and every parameter bit-equal to the plain-tensor step."""
    (m, p), (ref_m, ref_p) = _one_rank_step(arch, policy)
    assert float(m["loss"]) == float(ref_m["loss"]) and float(m["aux"]) == float(ref_m["aux"])
    for a, b in zip(p, ref_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
@pytest.mark.parametrize("S", ["chunk", 5])
def test_one_chunk_ssd_steps_on_a_mesh(arch, S):
    """The SSM families with the sequence one SSD chunk long or shorter
    (the scan then runs one chunk of min(chunk, S) steps, as every launch of
    the full configs at S <= 256 does): the SSD einsums hand ``dt``'s
    gradient back in (b, h, s) layout, and the block passes it on row-major,
    so the step over DTensors is bit-equal to the plain step."""
    chunk = tconfigs.get_arch(arch).smoke.chunk
    S = chunk if S == "chunk" else S
    assert S <= chunk
    (m, p), (ref_m, ref_p) = _one_rank_step(arch, S=S)
    assert float(m["loss"]) == float(ref_m["loss"]) and float(m["aux"]) == float(ref_m["aux"])
    for a, b in zip(p, ref_p):
        assert torch.equal(a, b)
