"""The layer loops' carry (``dist.carry``): every family's loop takes the
residual to one placement after the embedding and after every layer, as the
JAX package's ``lax.scan`` carry has one sharding for every iteration.

(a) five dry-run cells at full size on the fake 16 x 16 group
(``launch.dryrun.run_cell``, torch's own sharding strategies): Mamba-2's
batch-128 and batch-1 decodes issue one all-reduce per layer for the
out-projection's partial sum and one for the gated norm's statistics
(128 / 0 / 0 all-reduce / all-gather / reduce-scatter), and no cell moves
more collective bytes than the unrolled loop did (``PARENT_MB``: the loops
that passed each layer's placement on as it was);
(b) at smoke widths on a fake 2 x 2 group, every family's ``decode_step``
(batch 8, and batch 1 over sequence-split caches), ``prefill`` and
``__call__`` without ``act_spec``: the residual enters every layer with the
same placements (recorded by wrapping the blocks' methods);
(c) ``carry`` itself: the identity on plain tensors, no dispatch on a
DTensor at its placements, and otherwise one redistribution whose gradient
is whole on the dims that were partial; ``to_residual``, which takes a
decode block's branch outputs to the carry's placements before their adds.
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    abstract_put,
    batch_sharding,
    carry,
    carry_placements,
    default_rules,
    mesh_ops,
    to_residual,
    tree_shardings_shaped,
)
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.models import hymba, lm, mamba2, whisper  # noqa: E402

# collective MB a rank of each cell on 16 x 16 with the unrolled loops
# (torch 2.13; all-reduce / all-gather / reduce-scatter counts beside them)
PARENT_MB = {
    ("mamba2_2_7b", "decode_32k"): 6.0834,  # 191 / 0 / 190
    ("mamba2_2_7b", "long_500k"): 1.9983,  # 317 / 0 / 0
    ("gemma2_2b", "long_500k"): 438.8741,  # 206 / 26 / 0
    ("gemma2_27b", "decode_32k"): 5.9738,  # 184 / 0 / 412
    ("deepseek_moe_16b", "decode_32k"): 88.2020,  # 164 / 108 / 193
}
# the three cells whose carry moves fewer bytes than the unrolled loop
# (the other two: Mamba-2's, held to their counts)
FEWER = {("gemma2_2b", "long_500k"), ("gemma2_27b", "decode_32k"), ("deepseek_moe_16b", "decode_32k")}
MAMBA2_MB = {"decode_32k": 2.63, "long_500k": 0.33}

FAMILIES = ("gemma2_2b", "deepseek_moe_16b", "deepseek_v2_lite_16b", "mamba2_2_7b", "hymba_1_5b", "whisper_small")
# each family's layer (or layers, for Whisper's encoder and decoder) and the
# methods its loops call, the residual their second argument
BLOCKS = {
    "lm": [(lm.LMBlock, ("__call__", "prefill", "decode"))],
    "mamba2": [(mamba2.Mamba2LayerWrapped, ("__call__", "prefill", "decode"))],
    "hymba": [(hymba.HymbaBlock, ("__call__", "prefill", "decode"))],
    "whisper": [(whisper.EncBlock, ("__call__",)), (whisper.DecBlock, ("__call__", "prefill", "decode"))],
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- (a) full size, 16 x 16


@pytest.mark.parametrize("arch,shape", sorted(PARENT_MB))
def test_full_size_cell_collectives(arch, shape):
    """The cell's collectives a rank on the fake 16 x 16 group: Mamba-2's
    decodes exactly 128 / 0 / 0 (from 191 / 0 / 190 and 317 / 0 / 0) within
    their byte bounds; the other three fewer bytes than the unrolled
    loop's."""
    row = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
    assert row["status"] == "ok", row.get("trace")
    counts = row["collective_counts"]
    mb = sum(counts["bytes_by_kind"].values()) / 1e6
    got = (counts["all-reduce"], counts["all-gather"], counts["reduce-scatter"])
    assert mb <= PARENT_MB[arch, shape], (got, mb)
    if arch == "mamba2_2_7b":
        assert got == (128, 0, 0) and mb <= MAMBA2_MB[shape], (got, mb)
    if (arch, shape) in FEWER:
        assert mb < PARENT_MB[arch, shape], (got, mb)


# ----------------------------------------------- (b) one placement a loop


@pytest.fixture
def fake_2x2():
    assert not dist.is_initialized()
    with dryrun.dry_run(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


@contextlib.contextmanager
def layer_inputs(family):
    """The residual's placements at every call of ``family``'s layers:
    ``{(class, method): [placements, ...]}``."""
    seen = {}
    saved = []

    def wrap(cls, name):
        real = cls.__dict__[name]

        def recorded(self, p, x, *args, **kwargs):
            seen.setdefault((cls.__name__, name), []).append(
                tuple(x.placements) if isinstance(x, DTensor) else None)
            return real(self, p, x, *args, **kwargs)

        saved.append((cls, name, real))
        setattr(cls, name, recorded)

    for cls, names in BLOCKS[family]:
        for name in names:
            wrap(cls, name)
    try:
        yield seen
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


def _call_cell(spec, mesh):
    """``model(params, tokens)`` (Whisper: ``(params, frames, tokens)``)
    without ``act_spec``: the parameters placed by the train rules (FSDP
    over "data", the tensor-parallel axes over "model"), the batch over
    "data", on ``meta`` DTensors."""
    cfg = spec.config
    model = configs.build_model(dataclasses.replace(cfg, act_dtype=torch.float32))
    sh = dryrun.SMOKE_SHAPES["train"]
    B, S = sh["global_batch"], sh["seq_len"]
    rules = default_rules(True, mesh.mesh_dim_names)
    abstract = model.abstract(torch.float32)
    params = abstract_put(abstract, tree_shardings_shaped(mesh, model.axes(), abstract, rules))
    bsh = batch_sharding(mesh, B, rules)
    args = [abstract_put(torch.empty((B, S), dtype=torch.int32, device="meta"), bsh)]
    if spec.family == "whisper":
        args.insert(0, abstract_put(torch.empty((B, cfg.n_frames, cfg.d_model), device="meta"), bsh))

    def fn(*a):
        with torch.no_grad(), mesh_ops():
            return model(params, *a)

    return fn, args


def _n_layers(cfg, cls):
    if cls == "EncBlock":
        return cfg.n_enc_layers
    if cls == "DecBlock":
        return cfg.n_dec_layers
    return cfg.n_layers


@pytest.mark.parametrize("kind", ["decode", "long", "prefill", "call"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_residual_enters_every_layer_with_one_placement(arch, kind, fake_2x2):
    """Each loop of the step: as many layer calls as layers, every one
    with a DTensor residual, all at the same placements."""
    spec = configs.get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    if kind == "call":
        fn, args = _call_cell(spec, fake_2x2)
    else:
        cell = specs.build_cell(spec, kind, fake_2x2, n_micro=1, shapes=dryrun.SMOKE_SHAPES)
        fn, args = cell.fn, cell.args
    with layer_inputs(spec.family) as seen:
        fn(*args)
    assert seen
    for (cls, method), placements in seen.items():
        assert len(placements) == _n_layers(spec.config, cls), (cls, method, placements)
        assert None not in placements and len(set(placements)) == 1, (cls, method, placements)


# --------------------------------------------------------- (c) the carry


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_carry_is_the_identity_on_plain_tensors():
    x, h = torch.randn(2, 3, 8), torch.randn(2, 3, 8)
    assert carry_placements(x) is None
    with _Ops() as ops:
        assert carry(x, None) is x
        assert carry(x, (Replicate(), Shard(2))) is x
        assert to_residual(h, x) is h
    assert ops.ops == []


def _dtensor(mesh, placements, shape=(2, 3, 8), grad=False):
    return DTensor.from_local(torch.empty(shape, device="meta", requires_grad=grad), mesh, placements,
                              run_check=False)


def test_carry_at_its_placements_dispatches_nothing(fake_2x2):
    """The batch's split kept on "data", "model" whole; a split of the
    hidden dim or a partial sum taken whole."""
    x = _dtensor(fake_2x2, (Shard(0), Replicate()))
    pl = carry_placements(x)
    assert pl == (Shard(0), Replicate())
    assert carry_placements(_dtensor(fake_2x2, (Shard(2), Partial()))) == (Replicate(), Replicate())
    assert carry_placements(_dtensor(fake_2x2, (Partial(), Shard(0)))) == (Replicate(), Replicate())
    with _Ops() as ops:
        assert carry(x, pl) is x
    assert ops.ops == []


@pytest.mark.parametrize("target", ["replicated", "split_hidden"])
def test_carry_reduces_a_partial_once_and_its_gradient_is_whole(target, fake_2x2):
    """A partial sum over "model" (a layer's out-projection) taken to the
    carry's placements is all-reduced once (reduce-scattered to a split
    of the hidden dim); the gradient that comes back is whole on "model"
    (all-gathered from the split's) and keeps the batch split on "data"."""
    x = _dtensor(fake_2x2, (Shard(0), Partial()), shape=(1, 3, 8), grad=True)
    x.retain_grad()
    pl = carry_placements(x) if target == "replicated" else (Shard(0), Shard(2))
    assert pl[0] == Shard(0)
    with roofline.RankCounter() as counter:
        y = carry(x, pl)
    assert tuple(y.placements) == pl
    kind = "all-reduce" if target == "replicated" else "reduce-scatter"
    assert counter.collective_counts[kind] == 1 and sum(counter.collective_counts.values()) == 1
    g = DTensor.from_local(torch.empty(y.to_local().shape, device="meta"), fake_2x2, pl, run_check=False)
    with roofline.RankCounter() as counter:
        y.backward(g)
    assert tuple(x.grad.placements) == (Shard(0), Replicate())
    assert sum(counter.collective_counts.values()) == (0 if target == "replicated" else 1)


def test_to_residual_takes_a_partial_branch_to_the_residual(fake_2x2):
    """A decode block's branch output, partial over "model", joins the
    carried residual at its placements with one all-reduce; beside a
    partial residual it is left as it is."""
    x, h = _dtensor(fake_2x2, (Shard(0), Replicate())), _dtensor(fake_2x2, (Shard(0), Partial()))
    with roofline.RankCounter() as counter:
        y = to_residual(h, x)
    assert tuple(y.placements) == tuple(x.placements)
    assert counter.collective_counts["all-reduce"] == 1 and sum(counter.collective_counts.values()) == 1
    assert to_residual(h, h) is h
