"""PyTorch/CUDA port of the MRI reconstruction + detection pipeline:
serving, and the training -> surgery -> evaluation path.

Mirrors ``repro``'s layout (``nn``, ``models``, ``core``, ``serve``,
``kernels``, ``train``, ``data``) and keeps its layouts (NHWC activations,
HWIO weights) at every public function. It imports ``torch`` and never
``jax`` or ``repro``.
"""
