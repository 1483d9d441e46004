# Hand-written CUDA kernels for the serving hot path. Each package keeps the
# JAX package's three-file layout: kernel.py (the kernel's build, binding and
# launch), ops.py (CPU tensors -> the plain version, CUDA tensors -> the
# kernel), ref.py (the plain PyTorch version).
import torch


_TRAIN_HINT = 'train with impl="xla" / deconv_backend="xla" (as the reference does)'
# the LM kernels (flash attention, the SSD scan) have no plain route on the
# card yet: LM training, with the plain ops, is a later slice
LM_HINT = "LM training is not ported yet (it will run the plain ops)"


def refuse_grad(name: str, *tensors, hint: str = _TRAIN_HINT) -> None:
    """Raise when autograd would need a gradient through kernel ``name``.

    The kernels have no backward, as the TPU kernels they replace have no
    ``custom_vjp``: on the card their outputs would carry no ``grad_fn``
    and cut the gradient silently. So both devices refuse, and training
    runs the plain ops, as the JAX package does."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(f"{name} has no backward: {hint}, or call it under torch.no_grad()")
