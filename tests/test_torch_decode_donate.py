"""The LM decode step writes into the caches it is given
(``decode_step``, ``make_lm_decode_step``): the counterpart of the JAX
decode cell's ``donate_argnums=(2,)`` with ``dynamic_update_slice``.

For each of the ten architectures at its smoke config (f32 activations and
caches), from caches filled with random values (numpy seed), over
``local_window + 2`` steps on caches of ``local_window`` slots, so that
every ring buffer wraps (gemma2's and Hymba's windowed layers, the global
layers too) and MLA's write clamps to its last slot: every leaf the step
returns is the caller's tensor; a caller that keeps its caches (it passes a
clone) gets the same logits and caches, bit for bit; and the step matches
the JAX package's ``decode_step`` (jitted) at ``test_torch_lm_zoo.py``'s
tolerances (logits 1e-4, cache leaves 1e-5). The slot write itself is held
against the parent code's out-of-place write, bit for bit, in
``test_torch_dist_views.py``. Then the dry run's gemma2-2b ``decode_32k``
cell on the fake 256-rank 16 x 16 group: the step writes into its donated
caches, so outputs and temps are no longer a whole cache each.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn.module import from_jax, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import make_lm_decode_step  # noqa: E402

ARCHS = tconfigs.ARCH_IDS
# the smoke configs' sliding window (gemma2, Hymba); the others have none
WINDOW = 8
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_archs_are_the_ten():
    assert len(ARCHS) == 10 and {tconfigs.get_arch(a).family for a in ARCHS} == {"lm", "hymba", "mamba2",
                                                                                   "whisper"}
    assert {getattr(tconfigs.get_arch(a).smoke, "local_window", 0) for a in ARCHS} <= {0, None, WINDOW}


def _models(arch):
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32)
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, act_dtype=jnp.float32)
    tm, jm = tconfigs.build_model(tcfg), jconfigs.build_model(jcfg)
    host = tree_map(lambda t: t.numpy(), tm.init(torch.Generator().manual_seed(0)))
    return tm, jm, from_jax(host), host


def _leaves_equal(got, want):
    gl, wl = tree_leaves(got), tree_leaves(want)
    return len(gl) == len(wl) and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(gl, wl))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_in_place_and_matches_jax(arch):
    tm, jm, tp, jp = _models(arch)
    rng = np.random.default_rng(3)
    start = tree_map(lambda c: rng.standard_normal(tuple(c.shape)).astype(np.float32),
                     tm.init_caches(B, WINDOW, dtype=torch.float32))
    toks = rng.integers(0, tm.cfg.vocab, (WINDOW + 2, B, 1)).astype(np.int32)
    step = make_lm_decode_step(tm)
    jdecode = jax.jit(jm.decode_step)
    # overwritten by every step (a copy: jnp.asarray may alias start's buffers)
    given = tree_map(lambda a: torch.from_numpy(a.copy()), start)
    given_leaves = tree_leaves(given)
    jc = tree_map(jnp.asarray, start)
    for t in range(WINDOW + 2):
        token = torch.from_numpy(toks[t])
        want, kept = step(tp, token, tree_map(torch.clone, given), t)  # a caller that keeps its caches
        got, out = step(tp, token, given, t)
        out_leaves = tree_leaves(out)
        assert len(out_leaves) == len(given_leaves)
        assert all(a is b for a, b in zip(out_leaves, given_leaves)), f"step {t}: a leaf is not the caller's"
        assert torch.equal(got, want), f"step {t}: the logits differ from those of a clone of the caches"
        assert _leaves_equal(out, kept), f"step {t}: the caches differ from those written into a clone"
        jl, jc = jdecode(jp, jnp.asarray(toks[t]), jc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-4)
        for a, b in zip(out_leaves, jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), atol=1e-5)


def test_dry_run_decode_cell_writes_into_its_donated_caches():
    """gemma2-2b's ``decode_32k`` cell (batch 128, 32768-slot caches) on the
    fake 256-rank 16 x 16 group, as ``launch.dryrun`` counts it: with the
    caches written in place, the outputs are the logits (under 1 GiB a
    rank, from 26.0 when the step returned new caches) and the temps at
    most about one layer's cache (under 2 GiB, from 26.0); the total at
    most 35 GiB (from 82.87), and the step runs no collective, as before."""
    from repro_torch.launch.dryrun import run_cell

    row = run_cell("gemma2_2b", "decode_32k", multi_pod=False, verbose=False)
    assert row["status"] == "ok", row.get("trace")
    mem = {k: v / 2**30 for k, v in row["memory_per_device"].items()}
    assert mem["outputs"] < 1 and mem["temps"] < 2 and mem["total"] <= 35, mem
    counts = {k: v for k, v in row["collective_counts"].items() if k != "bytes_by_kind"}
    assert counts == dict.fromkeys(counts, 0)
