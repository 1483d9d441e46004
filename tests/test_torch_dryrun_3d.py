"""The port's dry-run cells on a fake 2 x 2 x 2 group ("pod", "data",
"model", the multi-pod mesh's dims), each family's smoke config, through
``test_torch_dryrun.check_cell``.

DTensor plans each redistribution on a mesh by a graph search over its
placements, and on a 3-D mesh at smoke widths, where every mesh dim
divides every dim, that search dominates: each family's prefill and
batch-1 decode take seconds here, but the batch-8 decode of gemma2-2b,
qwen2-vl and hymba (caches split over batch and heads) and the train
cells of gemma2-2b, whisper and both DeepSeeks each ran past 5 to 12
minutes on the host. Those are left to the 2 x 2 mesh
(test_torch_dryrun.py) and to the full-size sweep (`launch.dryrun
--both-meshes`); the 3-D mesh runs the rest, and a train cell of mamba2.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import FAMILIES, check_cell, fake_mesh, small_shapes  # noqa: E402,F401

# (family, kind) on the 3-D mesh, beyond every family's prefill and long decode
EXTRA = [("mla", "decode"), ("mamba2", "train")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family,kind", [(f, k) for f in sorted(FAMILIES) for k in ("prefill", "long")] + EXTRA)
def test_cells_run_on_a_2x2x2_mesh(family, kind, fake_mesh, small_shapes):  # noqa: F811
    check_cell(fake_mesh((2, 2, 2), ("pod", "data", "model")), family, kind)
