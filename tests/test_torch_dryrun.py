"""The port's dry run on the CPU: cells built by ``launch.specs.build_cell``
for the smoke config of every LM family, each kind of cell, on a fake
process group of 2 x 2 ranks (``launch.dryrun.dry_run``), run on ``meta``
DTensors and counted by ``launch.roofline.count_run``; the faults the
full-size sweep found; the counts of hand-countable steps; and the
launcher at full size on one cell.

Each fake group lives inside one test: ``dry_run`` refuses to start where a
process group exists and destroys its own on exit (pytest-xdist reuses a
worker for other files' tests, which make their own groups).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import NamedSharding, PartitionSpec as P, abstract_put, mesh_ops  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402

FAMILIES = {
    "lm": "gemma2_2b",
    "moe": "deepseek_moe_16b",
    "mla": "deepseek_v2_lite_16b",
    "mrope": "qwen2_vl_7b",
    "mamba2": "mamba2_2_7b",
    "hymba": "hymba_1_5b",
    "whisper": "whisper_small",
}
# small cells of each kind; "long" is the batch-1 decode (sequence-sharded caches)
SHAPES = dryrun.SMOKE_SHAPES


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_mesh():
    """``fake_mesh(shape, names)``: a DeviceMesh over a fake group of
    prod(shape) ranks, made inside the test and destroyed after it."""
    assert not dist.is_initialized()
    groups = []

    def make(shape, names):
        ctx = dryrun.dry_run(int(torch.tensor(shape).prod()))
        ctx.__enter__()
        groups.append(ctx)
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    for ctx in groups:
        ctx.__exit__(None, None, None)
    assert not dist.is_initialized()


@pytest.fixture
def small_shapes(monkeypatch):
    monkeypatch.setattr(specs, "SHAPES", SHAPES)


def _smoke(arch):
    spec = configs.get_arch(arch)
    return dataclasses.replace(spec, config=spec.smoke)


def _run_cell(spec, shape, mesh):
    cell = specs.build_cell(spec, shape, mesh, n_micro=2)
    out, counts = roofline.count_run(cell.fn, cell.args)
    return cell, out, counts


# -------------------------------------------------------------- (f) the cells


def check_cell(mesh, family, kind):
    """Build, run and check one cell of ``family``'s smoke config on
    ``mesh`` (``launch.dryrun.check_cell``)."""
    dryrun.check_cell(mesh, FAMILIES[family], kind, SHAPES)


@pytest.mark.parametrize("kind", ["prefill", "decode", "long", "train"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cells_run_on_a_2x2_mesh(family, kind, fake_mesh, small_shapes):
    """Each family's smoke config, each kind of cell, on a fake 2 x 2 mesh
    whose dims all shard (the 2 x 2 x 2 mesh: test_torch_dryrun_3d.py)."""
    check_cell(fake_mesh((2, 2), ("data", "model")), family, kind)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("family", ["lm", "mamba2"])
def test_one_rank_mesh_counts_no_collective(family, kind, fake_mesh, small_shapes):
    """On a one-rank mesh every placement replicates: the step issues no
    collective, and counts what the 2 x 2 mesh's ranks count together."""
    spec = _smoke(FAMILIES[family])
    _, _, counts = _run_cell(spec, kind, fake_mesh((1, 1), ("data", "model")))
    assert counts.collective_counts == {k: 0 for k in roofline.COLLECTIVE_OPS}
    assert counts.flops > 0


def test_act_spec_shards_the_activations_between_blocks(fake_mesh):
    """``dist.constrain``: the batch dim over the ``act_spec`` dims the mesh
    carries and the other dims replicated; the identity on plain tensors,
    without ``act_spec`` and on a one-rank mesh."""
    from repro_torch.dist import constrain

    mesh = fake_mesh((2, 2), ("data", "model"))
    x = abstract_put(torch.empty(8, 4, 6, device="meta"), NamedSharding(mesh, P(None, None, "model")))
    y = constrain(x, ("data",))
    assert y.placements == (Shard(0), Replicate()) and y.shape == x.shape
    assert constrain(x, None) is x and constrain(x, ("pod",)) is x
    plain = torch.zeros(2, 3)
    assert constrain(plain, ("data",)) is plain


# ------------------------------------------- faults the full-size sweep found


def test_ssd_heads_split_unevenly_train_on_a_mesh(fake_mesh, monkeypatch):
    """hymba-1.5b's SSD has 50 heads of 64 (3,200 wide), and its out-projection
    shards that width 16 ways (200: not whole heads): the backward's view
    of the gradient back to heads raised in DTensor. The same split at
    smoke size (3 heads of 30 over 2 ranks) trains on a 2 x 2 mesh; on plain
    tensors the flatten's gradient is the reshape's, bit for bit."""
    from repro_torch.nn.ssm import _FlatHeads

    monkeypatch.setattr(specs, "SHAPES", {"train": {"kind": "train", "seq_len": 16, "global_batch": 8}})
    spec = configs.get_arch("hymba_1_5b")
    cfg = dataclasses.replace(spec.smoke, d_model=45, ssm_head_dim=30)
    assert cfg.mamba().n_heads == 3
    mesh = fake_mesh((2, 2), ("data", "model"))
    cell = specs.build_cell(dataclasses.replace(spec, config=cfg), "train", mesh, n_micro=1)
    _, counts = roofline.count_run(cell.fn, cell.args)
    assert counts.collective_counts["all-gather"] > 0
    y = torch.randn(2, 5, 3, 30, generator=torch.Generator().manual_seed(0))
    w = torch.randn(90, generator=torch.Generator().manual_seed(1))
    grads = []
    for flat in (lambda t: _FlatHeads.apply(t), lambda t: t.reshape(2, 5, 90)):
        t = y.clone().requires_grad_()
        (flat(t) * w).square().sum().backward()
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_vocab_split_over_two_mesh_dims_gathers_the_gold_logit(fake_mesh):
    """phi4-mini's 200,064 tokens split over "model" and "pod" (2 x 16 x 16):
    DTensor's gather of the gold logit gave the labels one masked partial
    per mesh dim with one shared mask, and refused the second. The vocab is
    split over one mesh dim before the gather now; a plain tensor passes
    as it is."""
    from repro_torch.train.losses import _one_vocab_split, _token_nll

    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    logits = abstract_put(torch.empty(8, 64, 512, device="meta"), NamedSharding(mesh, P(None, None, ("model", "pod"))))
    labels = abstract_put(torch.empty(8, 64, dtype=torch.int32, device="meta"), NamedSharding(mesh, P()))
    logits.requires_grad_()
    with mesh_ops():
        nll = _token_nll(logits, labels)
        nll.sum().backward()
    assert nll.shape == (8, 64) and logits.grad.shape == logits.shape
    assert _one_vocab_split(logits).placements == (Shard(2), Replicate(), Replicate())  # the first of equals
    plain = torch.zeros(2, 3)
    assert _one_vocab_split(plain) is plain


# ----------------------------------------------------- (g) hand-counted cases


def test_data_parallel_step_all_reduces_the_gradient_bytes(fake_mesh):
    """Two data-parallel ranks, the weights replicated and the batch split:
    the step's only collectives are all-reduces, of the gradient's bytes
    (f32, counted by hand) and of the loss."""
    from repro_torch.dist import on_mesh
    from repro_torch.train import SGD

    mesh = fake_mesh((2,), ("data",))
    d_in, d_out, B = 48, 24, 16
    params = abstract_put({"w": torch.empty(d_in, d_out, device="meta")}, NamedSharding(mesh, P()))
    opt = SGD(lr=0.1)
    state = abstract_put(opt.abstract_state({"w": torch.empty(d_in, d_out, device="meta")}),
                         NamedSharding(mesh, P()))
    batch = abstract_put({"x": torch.empty(B, d_in, device="meta")}, NamedSharding(mesh, P("data")))

    def step(params, state, batch):
        p = {"w": params["w"].detach().requires_grad_()}
        loss = (batch["x"] @ p["w"]).square().mean()
        (g,) = torch.autograd.grad(loss, [p["w"]])  # a partial sum over the ranks' rows
        g = g.redistribute(mesh, (Replicate(),))  # the data-parallel all-reduce
        params, state, _ = opt.update({"w": g}, state, params)
        return params, state, {"loss": loss.detach()}

    (params2, _, metrics), counts = roofline.count_run(on_mesh(step), (params, state, batch))
    assert params2["w"].placements == (Replicate(),) and metrics["loss"].shape == ()
    assert counts.collective_counts["all-reduce"] == 2
    assert counts.collective_bytes["all-reduce"] == d_in * d_out * 4 + 4
    assert sum(counts.collective_counts.values()) == 2
    # the local matmuls: forward (B/2 rows) and the weight gradient
    assert counts.flops == 2 * (2 * (B // 2) * d_in * d_out)


def test_matmul_flops_are_per_rank(fake_mesh):
    """A matmul whose rows are split over four ranks counts a quarter of the
    global flops on each: the counter sees the local op, where a counter
    that saw the DTensor op (``FlopCounterMode`` around it) counts the
    whole mesh's."""
    from torch.utils.flop_counter import FlopCounterMode

    mesh = fake_mesh((4,), ("data",))
    M, K, N = 64, 32, 16
    x = abstract_put(torch.empty(M, K, device="meta"), NamedSharding(mesh, P("data")))
    w = abstract_put(torch.empty(K, N, device="meta"), NamedSharding(mesh, P()))

    def matmul(x, w):
        with mesh_ops():
            return x @ w

    out, counts = roofline.count_run(matmul, (x, w))
    assert out.shape == (M, N) and out.to_local().shape == (M // 4, N)
    assert counts.flops == 2 * M * K * N / 4
    assert sum(counts.collective_counts.values()) == 0
    with FlopCounterMode(display=False) as whole:
        matmul(x, w)
    assert whole.get_total_flops() == 2 * M * K * N
    assert counts.memory["arguments"] == (M // 4 * K + K * N) * 4 and counts.memory["outputs"] == M // 4 * N * 4


def test_counts_do_not_include_the_sharding_propagation(fake_mesh, small_shapes):
    """A cell counts what its rank runs, whether DTensor's placements are
    cached or not: with the cache cleared, DTensor derives some ops'
    strategies by running their decompositions on ``meta`` tensors of
    global shape (mamba2's softplus among them), which a rank never runs."""
    prop = DTensor._op_dispatcher.sharding_propagator
    spec = _smoke("mamba2_2_7b")
    mesh = fake_mesh((2, 2), ("data", "model"))
    counts = []
    for _ in range(2):
        prop.propagate_op_sharding.cache_clear()
        counts.append(_run_cell(spec, "train", mesh)[2])
    counts.append(_run_cell(spec, "train", mesh)[2])  # every placement cached
    assert counts[0] == counts[1] == counts[2]


# ------------------------------------------------------------ (h) the launcher


def test_launcher_writes_a_full_size_decode_row(tmp_path, monkeypatch, capsys):
    """``dryrun.main`` on gemma2-2b's decode_32k at full size on the 16 x 16
    mesh: an ``ok`` row with JAX's keys, written under the artifact
    directory; nothing allocated (meta tensors over a fake group of 256)."""
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    assert not dist.is_initialized()
    dryrun.main(["--arch", "gemma2_2b", "--shape", "decode_32k"])
    assert not dist.is_initialized()
    row = json.loads((tmp_path / "gemma2_2b__decode_32k__16x16.json").read_text())
    assert row["status"] == "ok" and row["chips"] == 256 and row["kind"] == "decode"
    assert row["memory_per_device"]["arguments"] > 0 and row["bottleneck"] in ("compute", "memory", "collective")
    assert "done: 1 ok, 0 skip, 0 fail / 1 cells" in capsys.readouterr().out


def test_launcher_skips_and_fails_as_jax(monkeypatch, tmp_path):
    """A shape the arch skips is a ``skip`` row; a cell that raises is a
    ``fail`` row and the launcher exits 1."""
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    row = dryrun.run_cell("gemma_2b", "long_500k", False, verbose=False)
    assert row["status"] == "skip" and row["mesh"] == "16x16"

    def broken(*a, **k):
        raise RuntimeError("no strategy")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma2_2b", "--shape", "decode_32k", "--multipod"])
    assert e.value.code == 1 and not dist.is_initialized()
    row = json.loads((tmp_path / "gemma2_2b__decode_32k__2x16x16.json").read_text())
    assert row["status"] == "fail" and "no strategy" in row["error"]


# ------------------------------------------------------- (i) the hillclimb script


def _hillclimb():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "experiments" / "torch_hillclimb.py"
    spec = importlib.util.spec_from_file_location("torch_hillclimb", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hillclimb_equals_run_cell(monkeypatch, capsys):
    """``experiments/torch_hillclimb.py`` takes ``run_cell``'s path: on
    mamba2-2.7b's smoke config over a fake 2 x 2 mesh (in place of the 16 x
    16 one), its row with no variant has ``run_cell``'s terms, counts and
    memory; a variant (``n_micro=2``) and a config override reach the
    cell; each call prints the JAX script's line; no CUDA context."""
    from torch.distributed.device_mesh import init_device_mesh

    hc = _hillclimb()
    spec = _smoke("mamba2_2_7b")
    mesh = lambda **kw: init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))  # noqa: E731
    real_dry_run = dryrun.dry_run
    for mod in (hc, dryrun):
        monkeypatch.setattr(mod, "get_arch", lambda name: spec)
        monkeypatch.setattr(mod, "make_production_mesh", mesh)
        monkeypatch.setattr(mod, "dry_run", lambda world: real_dry_run(4))
    monkeypatch.setitem(configs.SHAPES, "train_4k", SHAPES["train"])
    row = hc.run("mamba2_2_7b", "train_4k")
    want = dryrun.run_cell("mamba2_2_7b", "train_4k", False, verbose=False)
    assert want["status"] == "ok"
    assert row == {k: want[k] for k in row}
    micro = hc.run("mamba2_2_7b", "train_4k", set_cfg={"remat": False}, n_micro=2)
    assert micro["collective_counts"] != row["collective_counts"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[mamba2_2_7b|train_4k|{}] comp=") and "bneck=collective" in out[0]
    assert out[-1].startswith("[mamba2_2_7b|train_4k|{'n_micro': 2}] comp=") and "mem/dev=" in out[-1]
    assert not dist.is_initialized() and not torch.cuda.is_initialized()
    assert hc.parse_kw(["n_micro=2", "fsdp=False", "lr=0.5", "remat_policy=dots"]) == {
        "n_micro": 2, "fsdp": False, "lr": 0.5, "remat_policy": "dots"}
