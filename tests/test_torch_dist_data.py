"""Every sharded LM step of the dry run's seven families on gloo ranks with
data, against the same call in one process (``launch.dryrun.DATA_CASES``,
``data_outputs``).

Four spawned ranks (one intra-op thread each, ``PYTHONHASHSEED`` fixed) on
a (2, 2) ("data", "model") mesh run each family's smoke config in f32 with
f32 caches, from the parameters of one seed and inputs drawn with numpy:

- prefill: B 4, S 16 (Whisper takes frames), the parameters placed by
  ``default_rules(False, ...)`` as the dry run's serving cells place them;
- decode: B 8 over "data", the heads over "model", caches of length 8
  filled with random values, 10 steps, so that ``Attention``'s ring buffer
  wraps and MLA's write clamps to the last slot;
- long: the same steps at B 1 with the caches split over "data" on the
  sequence (``cache_shardings(seq_sharded=True)``, the dry run's
  ``long`` / ``long_500k`` layout), where the decode writes its slot on
  the rank that holds it (and gemma2-2b's on eight ranks of a (2, 2, 2)
  mesh, the sequence split over "pod" and "data");
- train: one step's loss and gradients for Whisper and for qwen2-vl with
  its M-RoPE ids and patch embeddings (no ``act_spec``), the parameters
  placed by ``train_shardings`` (the other families' gradients:
  ``test_torch_dist_ranks.py::test_gradients_on_a_2x2_mesh_equal_one_process``).

The decode steps take their position as a replicated 0-d int32 tensor,
donate their caches and must return the ones they were given
(``data_outputs`` raises otherwise). The slot write alone, with a tensor
index at every slot of the ring, is held on four ranks against the
int-index write it replaced, on this torch version and under torch 2.11's
emulation (``test_slot_write_with_a_tensor_index_on_four_ranks``). Each output (the logits of every
step, every cache leaf, the loss, every gradient) is gathered whole on every rank and must lie within
``DATA_TOL`` (1e-5) of the reference leaf's largest magnitude. The ranks
run every family of a kind in one spawn and save what each gave (or the
traceback it raised); the cases read it through a module-scoped fixture.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.dryrun import DATA_CASES, DATA_TOL, data_error, data_outputs, data_rank  # noqa: E402
from test_torch_dist_ranks import _join, _spawn  # noqa: E402
from test_torch_dryrun import FAMILIES  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data_rank(rank, world, store, kind, out):
    from torch.distributed.device_mesh import init_device_mesh

    _join(rank, world, store)
    try:
        torch.save(data_rank(kind, init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))),
                   out.format(rank))
    finally:
        dist.destroy_process_group()


def _long_3d_rank(rank, world, store, arch, out):
    from torch.distributed.device_mesh import init_device_mesh

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        torch.save(data_outputs(arch, "long", mesh), out.format(rank))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(kind)``: each rank's results for every family of ``kind``,
    from one spawn of four ranks per kind."""
    runs = {}

    def get(kind):
        if kind not in runs:
            d = tmp_path_factory.mktemp(f"data_{kind}")
            out = str(d / "rank{}.pt")
            _spawn(_data_rank, 4, str(d / "store"), kind, out)
            runs[kind] = [torch.load(out.format(r)) for r in range(4)]
        return runs[kind]

    return get


def test_cases_cover_the_dry_runs_families():
    """Prefill, batch-8 decode and batch-1 decode of each family the dry
    run's tests hold, and the two train steps no other check runs on a
    split mesh."""
    serving = [(a, k) for a in FAMILIES.values() for k in ("prefill", "decode", "long")]
    assert sorted(DATA_CASES) == sorted(serving + [("whisper_small", "train"), ("qwen2_vl_7b", "train")])


@pytest.mark.parametrize("arch,kind", DATA_CASES, ids=[f"{a}-{k}" for a, k in DATA_CASES])
def test_sharded_step_equals_one_process(arch, kind, ranks):
    """The family's ``kind`` step on the (2, 2) mesh of gloo ranks, gathered
    on each rank, against one process: every output within ``DATA_TOL`` of
    the reference leaf's largest magnitude."""
    want = data_outputs(arch, kind)
    for r, got in enumerate(ranks(kind)):
        res = got[arch]
        assert not isinstance(res, str), f"rank {r} raised:\n{res}"
        err = data_error(res, want)
        assert err <= DATA_TOL, f"rank {r}: {err:.3e} of the largest reference value (bound {DATA_TOL})"


def _slot_write_rank(rank, world, store, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from test_torch_dist_views import emulated_2_11, slot_write_case

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for version, ctx in (("2.13", contextlib.nullcontext), ("2.11", emulated_2_11)):
            with ctx():
                for shape in ((1, 8, 4, 6), (1, 8, 6)):
                    res[version, shape] = slot_write_case(mesh, shape, lambda x, m, pl: distribute_tensor(x, m, pl))
        torch.save(res, out.format(rank))
    finally:
        dist.destroy_process_group()


def test_slot_write_with_a_tensor_index_on_four_ranks(tmp_path):
    """The decode's slot write into a batch-1 cache split on the sequence
    over "data" (and on the KV heads over "model", where it has them) on
    four gloo ranks, at every slot of the ring with a 0-d int32 index,
    plain and as a replicated DTensor, on this torch version and under
    ``test_torch_dist_views.emulated_2_11``: on every rank the cache given
    comes back with its placements, no collective is counted
    (``RankCounter``), its block equals the int-index write's bit for bit,
    and the whole cache gathered equals the parent code's item assignment."""
    out = str(tmp_path / "rank{}.pt")
    _spawn(_slot_write_rank, 4, str(tmp_path / "store"), out)
    for r in range(4):
        for key, rows in torch.load(out.format(r)).items():
            assert len(rows) == 2 * 8, key
            bad = [row for row in rows if not (row["same"] and row["equal"] and row["full"]) or row["collectives"]]
            assert not bad, f"rank {r}, torch {key[0]}, cache {key[1]}: {bad}"


def test_long_decode_on_a_2x2x2_mesh_equals_one_process(tmp_path):
    """gemma2-2b's batch-1 decode on eight gloo ranks of a (2, 2, 2)
    ("pod", "data", "model") mesh, the 2 x 16 x 16 layout: the caches split
    on the sequence over "pod" and "data" (two slots a rank), so each
    donated slot write lands on the one rank of four whose block, offset
    over both mesh dims, holds it; every output within ``DATA_TOL`` of one
    process's."""
    out = str(tmp_path / "rank{}.pt")
    _spawn(_long_3d_rank, 8, str(tmp_path / "store"), "gemma2_2b", out)
    want = data_outputs("gemma2_2b", "long")
    for r in range(8):
        err = data_error(torch.load(out.format(r)), want)
        assert err <= DATA_TOL, f"rank {r}: {err:.3e} of the largest reference value (bound {DATA_TOL})"
