"""Gradients through the port's LM modules against ``jax.grad`` of the JAX
package's.

The LM kernels (flash attention, the SSD scan) have no backward, as the TPU
kernels they replace have no ``custom_vjp``. So ``nn.Attention`` and
``nn.Mamba2Block`` take the plain ops (``_sdpa``, ``ssd_chunked``) where
autograd needs a gradient through them, on both devices, as the JAX
package's modules always do; under ``no_grad`` (every LM entry point:
prefill, decode, generation) they keep the kernel route. These hold the
gradients of a scalar loss (the logits or outputs against fixed random
weights) to ``jax.grad`` of the same loss, leaf by leaf, in f32: relative
Frobenius difference <= 1e-4 (both sides compute one function in fp32, in
other summation orders). Parameters cross with ``from_jax``, inputs come
from numpy seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.nn.module import from_jax, tree_leaves, tree_map  # noqa: E402

REL = 1e-4


def _hymba_pair(n_layers=2):
    """Hymba's smoke config cut to 2 layers: layer 0 global, layer 1 with an
    8-token window; SSD chunks of 8, so 20 tokens end in a ragged chunk."""
    kw = dict(n_layers=n_layers, global_layers=(0,))
    jcfg = dataclasses.replace(jconfigs.get_arch("hymba_1_5b").smoke, act_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tconfigs.get_arch("hymba_1_5b").smoke, act_dtype=torch.float32, **kw)
    return jconfigs.build_model(jcfg), tconfigs.build_model(tcfg)


def _case(name):
    """(JAX module, port module, JAX params, the two forwards on one numpy
    input, the output's shape)."""
    rs = np.random.RandomState(1)
    if name == "hymba":
        jm, tm = _hymba_pair()
        toks = rs.randint(0, 512, (2, 20)).astype(np.int32)
        return (jm, tm, lambda p: jm(p, jnp.asarray(toks))[0], lambda p: tm(p, torch.from_numpy(toks))[0],
                (2, 20, 512))
    if name == "mamba2":
        kw = dict(d_model=32, d_state=16, head_dim=16, n_groups=2, chunk=8)
        jm, tm = jnn.Mamba2Block(**kw), tnn.Mamba2Block(**kw)
        x = rs.randn(2, 20, 32).astype(np.float32)
        return jm, tm, lambda p: jm(p, jnp.asarray(x)), lambda p: tm(p, torch.from_numpy(x)), (2, 20, 32)
    kw = dict(d_model=32, n_q=4, n_kv=2, head_dim=16)
    jm, tm = jnn.Attention(**kw), tnn.Attention(**kw)
    x = rs.randn(2, 12, 32).astype(np.float32)
    return (jm, tm, lambda p: jm(p, jnp.asarray(x), window=4), lambda p: tm(p, torch.from_numpy(x), window=4),
            (2, 12, 32))


@pytest.mark.parametrize("name", ["hymba", "mamba2", "attention"])
def test_gradients_match_jax_grad(name):
    """A forward with grad on runs on the CPU (it raised before the modules
    routed themselves), launches no kernel, and every leaf's gradient is
    within 1e-4 relative of ``jax.grad``'s."""
    jm, tm, jfwd, tfwd, shape = _case(name)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    R = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jfwd(p).astype(jnp.float32) * R))(jax.tree.map(jnp.asarray, jp))
    tp = tree_map(lambda t: t.requires_grad_(), from_jax(jp))
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    (tfwd(tp) * torch.from_numpy(R)).sum().backward()
    assert attn_ops.launches == {"flash_attention": 0} and ssd_ops.launches == {"ssd": 0}
    leaves, jleaves = tree_leaves(tp), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        g, w = t.grad.numpy(), np.asarray(j)
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= REL * max(np.linalg.norm(w), 1e-30)


def test_no_grad_keeps_the_kernel_route_and_grad_mode_alone_changes_it():
    """The route depends only on whether autograd needs a gradient: with
    parameters that require grad, the same forward under ``no_grad`` gives
    the same values as with grad on (the CPU runs the plain ops on both
    routes), and with parameters that do not, grad mode changes nothing."""
    _, tm = _hymba_pair()
    p = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 20)).astype(np.int32))
    with torch.no_grad():
        ref, _ = tm(p, toks)
    got, _ = tm(tree_map(lambda t: t.clone().requires_grad_(), p), toks)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), ref, atol=0, rtol=0)
    plain, _ = tm(p, toks)
    assert not plain.requires_grad
    torch.testing.assert_close(plain, ref, atol=0, rtol=0)


def test_grad_route_is_counted_only_on_the_card():
    """``grad_route`` says whether the plain ops replace a kernel: only
    where autograd needs a gradient. It counts a call in
    ``kernels.grad_routes`` only on a CUDA tensor, so a CPU forward with
    grad on counts nothing."""
    kernels.grad_routes.clear()
    a = torch.zeros(2, requires_grad=True)
    assert kernels.grad_route("ssd", a, torch.zeros(2))
    assert not kernels.grad_route("ssd", torch.zeros(2))
    with torch.no_grad():
        assert not kernels.grad_route("ssd", a)
    _, tm = _hymba_pair()
    p = tree_map(lambda t: t.requires_grad_(), tm.init(torch.Generator().manual_seed(0)))
    assert tm(p, torch.zeros(1, 8, dtype=torch.int32))[0].requires_grad
    assert not kernels.grad_routes


@pytest.mark.cuda
def test_cuda_grad_takes_the_plain_route_and_no_grad_the_kernels():
    """On the card a Hymba forward with grad on launches no LM kernel,
    counts each plain-route call in ``kernels.grad_routes`` and gives the
    CPU's gradients; under ``no_grad`` the same forward launches
    ``flash_attention`` and ``ssd`` once per layer and counts no plain
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tm = _hymba_pair()
    p = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 20)).astype(np.int32))
    R = torch.from_numpy(np.random.RandomState(2).randn(2, 20, 512).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        pd = tree_map(lambda t: t.detach().to(dev).requires_grad_(), p)
        attn_ops.reset_launches()
        ssd_ops.reset_launches()
        kernels.grad_routes.clear()
        (tm(pd, toks.to(dev))[0] * R.to(dev)).sum().backward()
        assert attn_ops.launches == {"flash_attention": 0} and ssd_ops.launches == {"ssd": 0}
        assert kernels.grad_routes == ({"flash_attention": 2, "ssd": 2} if dev == "cuda" else {})
        grads[dev] = [t.grad.cpu() for t in tree_leaves(pd)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert (g - w).norm() <= REL * max(w.norm(), 1e-30)
    pd = tree_map(lambda t: t.to("cuda"), p)
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    kernels.grad_routes.clear()
    with torch.no_grad():
        tm(pd, toks.to("cuda"))
    torch.cuda.synchronize()
    assert attn_ops.launches == {"flash_attention": 2} and ssd_ops.launches == {"ssd": 2}
    assert not kernels.grad_routes
