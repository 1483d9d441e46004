"""Production and host meshes (the counterpart of ``repro.launch.mesh``):
``DeviceMesh``es with named dims over the ranks of the process group, one
device per rank.

Single pod: (16, 16) = 256 ranks, dims ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, dims ("pod", "data", "model") — the
"pod" dim crosses the inter-pod links; gradient compression in
``repro_torch.dist.compress`` targets exactly that dim.

Functions (not module-level constants), so importing this module never
touches the process group or a device.
"""
from __future__ import annotations

import math

import torch

from .distributed import backend_for


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_group(device):
    """The default process group, created for this one process (world 1,
    an in-memory store) when none exists."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(), world_size=1, rank=0)


def _make_mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    _ensure_group(device)
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; have {_world()}")
    return _make_mesh(shape, axes, device)


def make_host_mesh(model_parallel: int = 1, device="cuda"):
    """("data", "model") mesh over the ranks there are (tests / examples):
    ``world // model_parallel`` by ``model_parallel``."""
    _ensure_group(device)
    world = _world()
    if model_parallel < 1 or world % model_parallel:
        raise RuntimeError(f"a model axis of {model_parallel} does not divide {world} ranks")
    return _make_mesh((world // model_parallel, model_parallel), ("data", "model"), device)
