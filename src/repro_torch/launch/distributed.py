"""Multi-process initialization + env-driven config (the counterpart of
``repro.launch.distributed``).

Each process runs the same program. We honor both explicit flags and the
standard env vars (COORDINATOR_ADDRESS, NPROC, PROCESS_ID) so the same
entrypoint works under SLURM/GKE/manual launch: the coordinator's
``host:port`` becomes ``init_process_group``'s TCP rendezvous, with NCCL on
the card and gloo on the CPU, and each rank is bound to card ``rank %
device_count``.
"""
from __future__ import annotations

import os

import torch


def backend_for(device) -> str:
    """The process-group backend for a device: NCCL on the card, gloo on
    the CPU. A failing NCCL init raises; nothing switches to gloo."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


# hashed by every rank once it joins: the same value on every rank only
# where the ranks share PYTHONHASHSEED
_HASH_PROBE = "repro_torch.launch.distributed"


def _check_one_hash_seed():
    """Raise unless every rank of the process group hashes strings as this
    one does. DTensor breaks ties between equally cheap placements in an
    order that follows Python's string hashing; ranks that hash
    differently can choose different placements and issue different
    collectives, which hangs or corrupts the step. A process cannot set
    its own hash seed: the launch must export one for every rank."""
    import torch.distributed as dist

    hashes = [None] * dist.get_world_size()
    dist.all_gather_object(hashes, hash(_HASH_PROBE))
    if len(set(hashes)) > 1:
        raise RuntimeError(
            f"the {len(hashes)} ranks hash strings differently ({len(set(hashes))} distinct hashes of one "
            "string): export one PYTHONHASHSEED (e.g. PYTHONHASHSEED=0) for every rank before it starts"
        )


def maybe_initialize_distributed(coordinator=None, num_processes=None, process_id=None, device=None):
    """Join the process group of ``num_processes`` ranks at ``coordinator``
    (``host:port``) as rank ``process_id``; False without a coordinator.
    ``device`` is where the ranks compute (default: the card). Raises, and
    leaves no process group, where the ranks do not share PYTHONHASHSEED
    (``_check_one_hash_seed``)."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    import torch.distributed as dist

    from ..serve.demo import resolve_device

    dev = resolve_device(device)
    world = int(num_processes or os.environ["NPROC"])
    rank = int(process_id if process_id is not None else os.environ["PROCESS_ID"])
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev), init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    try:
        _check_one_hash_seed()
    except RuntimeError:
        dist.destroy_process_group()
        raise
    return True
