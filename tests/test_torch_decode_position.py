"""The LM decode step as the JAX package compiles it: its position a 0-d
int32 tensor on the token's device, and its attention reading each cache
where it lies.

For each of the ten architectures at its smoke config (f32 activations and
caches), from caches filled with random values (numpy seed), over
``WINDOW + 2`` steps on caches of ``WINDOW`` slots, so that every ring
buffer wraps and MLA's write clamps to its last slot
(``test_torch_decode_donate.py``'s fixtures):

- the step with ``t`` a 0-d int32 tensor (``make_lm_decode_step``, which
  runs the model's step eagerly on the CPU and captures nothing) is bit-equal
  to the step with ``t`` an int, logits and caches;
- it matches the JAX ``decode_step`` jitted with ``t`` a ``jnp.int32``
  array, as the JAX decode cell passes it, at ``test_torch_lm_zoo.py``'s
  tolerances (logits 1e-4, cache leaves 1e-5);
- under a ``TorchDispatchMode``, no aten op of the step outputs a new
  tensor (not a view of its inputs nor an in-place write into them) with the elements of a cache
  leaf or of one layer's slice of a stacked leaf, its dims in any order
  (what a copy of it, permuted or cast, makes): the attention reads
  the caches as views (``nn.attention._scores``, ``_weighted``) where an
  einsum over a (B, S, H, D) cache copied it whole. The SSM recurrent state
  (the leaves named ``ssm``) is left out: its update makes a state-sized
  product by nature, in the JAX package too. Nor does the step read a
  tensor on the host or make one from host data (``.item()``,
  ``torch.tensor``): either would break the step's CUDA-graph capture on
  the card.
"""
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as flat  # noqa: E402

from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import make_lm_decode_step  # noqa: E402
from test_torch_decode_donate import ARCHS, B, WINDOW, _leaves_equal, _models, _one_thread  # noqa: E402,F401


def _dims(shape):
    """A shape's dims in any order (a copy may permute them), 1s aside."""
    return tuple(sorted(n for n in shape if n != 1))


def _cache_shapes(tree, key=None, stacked=True):
    """The shapes a copy of a cache leaf would have (``_dims``): each
    leaf's, and one layer's slice of a stacked one (``TransformerLM``'s
    ``dense`` caches are one per layer); the SSM states aside."""
    if isinstance(tree, dict):
        return set().union(*(_cache_shapes(v, k, stacked) for k, v in tree.items()))
    if isinstance(tree, list):
        return set().union(set(), *(_cache_shapes(v, key, False) for v in tree))
    if key == "ssm":
        return set()
    return {_dims(tree.shape), _dims(tree.shape[1:])} if stacked else {_dims(tree.shape)}


# a host read of a tensor (.item(), int(t)) and host data made into a tensor
# (torch.tensor, new_tensor): neither can run inside a captured CUDA graph.
# F.one_hot (the MoE's load-balance count) reads its indices' range on the
# host on the CPU only (on CUDA the device checks them), so its reads pass
HOST_OPS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default)


def _storages(tree):
    return {a.untyped_storage().data_ptr() for a in flat(tree) if isinstance(a, torch.Tensor)}


class _NewTensors(TorchDispatchMode):
    """Records the ops whose outputs are new tensors (not views of their
    inputs, nor in-place writes into them, as into the caches) with the
    elements of a cache leaf, in any order of its dims (``_cache_shapes``)."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.hits, self.host = shapes, [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_OPS and not any("one_hot(" in (f.line or "") for f in traceback.extract_stack()):
            self.host.append(str(func))
        out = func(*args, **(kwargs or {}))
        inputs = _storages((args, kwargs))
        for o in flat(out):
            if (isinstance(o, torch.Tensor) and _dims(o.shape) in self.shapes
                    and o.untyped_storage().data_ptr() not in inputs):
                self.hits.append(f"{func} -> {tuple(o.shape)}")
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_equals_int_matches_jax_and_reads_caches_in_place(arch):
    tm, jm, tp, jp = _models(arch)
    rng = np.random.default_rng(4)
    start = tree_map(lambda c: rng.standard_normal(tuple(c.shape)).astype(np.float32),
                     tm.init_caches(B, WINDOW, dtype=torch.float32))
    toks = rng.integers(0, tm.cfg.vocab, (WINDOW + 2, B, 1)).astype(np.int32)
    step = make_lm_decode_step(tm)
    jdecode = jax.jit(jm.decode_step)
    by_int, by_tensor = (tree_map(lambda a: torch.from_numpy(a.copy()), start) for _ in range(2))
    shapes = _cache_shapes(by_tensor)
    jc = tree_map(jnp.asarray, start)
    for t in range(WINDOW + 2):
        token = torch.from_numpy(toks[t])
        want, _ = tm.decode_step(tp, token, by_int, t)
        position = torch.tensor(t, dtype=torch.int32)
        with _NewTensors(shapes) as seen:
            got, out = step(tp, token, by_tensor, position)
        assert not seen.hits, f"step {t}: new tensors the size of a cache leaf: {seen.hits}"
        assert not seen.host, f"step {t}: host reads or host data in the step: {seen.host}"
        assert torch.equal(got, want) and _leaves_equal(out, by_int), f"step {t}: the tensor t differs from the int"
        jl, jc = jdecode(jp, jnp.asarray(toks[t]), jc, jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-4)
        for a, b in zip(tree_leaves(out), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), atol=1e-5)
    assert step.graphs == {}  # the CPU captures nothing
