# Hand-written CUDA kernels for the serving hot path. Each package keeps the
# JAX package's three-file layout: kernel.py (the kernel's build, binding and
# launch), ops.py (CPU tensors -> the plain version, CUDA tensors -> the
# kernel), ref.py (the plain PyTorch version).
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``.

    The kernels have no backward, as the TPU kernels they replace have no
    ``custom_vjp``: on the card their outputs would carry no ``grad_fn``
    and cut the gradient silently. So both devices refuse, and training
    runs the plain ops, as the JAX package does."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} has no backward: train with impl=\"xla\" / deconv_backend=\"xla\" "
            "(as the reference does), or call it under torch.no_grad()"
        )
