# Hand-written CUDA kernels for the serving hot path. Each package keeps the
# JAX package's three-file layout: kernel.py (the kernel's build, binding and
# launch), ops.py (CPU tensors -> the plain version, CUDA tensors -> the
# kernel), ref.py (the plain PyTorch version).
import collections

import torch


_TRAIN_HINT = 'train with impl="xla" / deconv_backend="xla" (as the reference does)'
# the LM modules (nn.Attention, nn.Mamba2Block) route themselves: they call
# the LM kernels only where autograd needs no gradient, and the plain ops
# (_sdpa, ssd_chunked) otherwise, on both devices
LM_HINT = "differentiate through nn.Attention / nn.Mamba2Block, which take the plain ops then"


def needs_grad(*tensors) -> bool:
    """Whether autograd would need a gradient through a call on ``tensors``:
    grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


# LM module calls on CUDA tensors that took the plain ops because autograd
# needed a gradient, by kernel ("flash_attention", "ssd"): a serving caller
# that forgot torch.no_grad() shows here
grad_routes = collections.Counter()


def grad_route(name: str, *tensors) -> bool:
    """Whether an LM module takes the plain ops in place of kernel ``name``
    (autograd needs a gradient through ``tensors``), counted in
    ``grad_routes`` when the call is on the card."""
    if not needs_grad(*tensors):
        return False
    if tensors[0].device.type == "cuda":
        grad_routes[name] += 1
    return True


def refuse_grad(name: str, *tensors, hint: str = _TRAIN_HINT) -> None:
    """Raise when autograd would need a gradient through kernel ``name``.

    The kernels have no backward, as the TPU kernels they replace have no
    ``custom_vjp``: on the card their outputs would carry no ``grad_fn``
    and cut the gradient silently. So both devices refuse, and training
    runs the plain ops, as the JAX package does."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name} has no backward: {hint}, or call it under torch.no_grad()")


def launch_counters() -> dict[str, dict[str, int]]:
    """Every kernel package's ``launches`` counter, by package: the counts
    each ``ops`` wrapper adds one to where it launches its kernel."""
    from .attention import ops as attention
    from .deconv import ops as deconv
    from .fused import ops as fused
    from .ssd import ops as ssd

    return {"fused": fused.launches, "deconv": deconv.launches, "attention": attention.launches,
            "ssd": ssd.launches}


# kernel launches made by CUDA-graph replays (``core.pipeline``'s captured
# segment runners), by kernel: each replay adds the launches its graph
# captured. The wrappers' own counters see only launches made outside a
# graph, so a run's launches of kernel k are launch_counters()'s k plus
# graph_launches[k]
graph_launches = collections.Counter()


def reset_graph_launches():
    graph_launches.clear()


# the JAX package's kernel entry points, under its names (imported last:
# each ops module reads refuse_grad and LM_HINT from this package)
from .deconv.ops import deconv2d  # noqa: E402
from .attention.ops import attention as flash_attention_op  # noqa: E402
from .ssd.ops import ssd as ssd_op  # noqa: E402
