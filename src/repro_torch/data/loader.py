"""Prefetching, device-placing data loader."""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import torch

from ..nn.module import tree_map


def to_device(batch: Any, device: str | torch.device) -> Any:
    """Place a host batch (a tree of numpy arrays or tensors) on ``device``.

    Leaves bound for a CUDA card go through pinned host memory with
    non-blocking copies, so the copy overlaps the host's next work; the
    pinned buffers are the caching host allocator's, which keeps each one
    until its copy is done. ``shard_batch`` places a batch over a mesh."""
    device = torch.device(device)

    def put(x):
        t = torch.as_tensor(x)
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return tree_map(put, batch)


def shard_batch(batch: dict, sharding=None) -> dict:
    """Place a host batch on devices (with a ``dist.NamedSharding`` when
    given): ``jax.device_put`` of a per-process batch. Each rank's block of
    the sharded dims is its own rows of its own host batch (the batch the
    rank drew; ``distribute_tensor`` with no source rank), wrapped as a
    DTensor of the global shape; no data moves between ranks. Without a
    sharding, the leaves as CPU tensors."""
    if sharding is None:
        return tree_map(torch.as_tensor, batch)
    from torch.distributed.tensor import distribute_tensor

    from ..dist.sharding import local_device

    dev = local_device(sharding.mesh)
    return tree_map(lambda x: distribute_tensor(torch.as_tensor(x).to(dev), sharding.device_mesh,
                                                sharding.placements, src_data_rank=None), batch)


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches ahead (overlap host
    data generation with device compute)."""

    def __init__(self, it: Iterator, depth: int = 2, transform: Callable | None = None):
        self.it = it
        self.transform = transform or (lambda x: x)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Exception | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(self.transform(item))
        except Exception as e:
            self.err = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.err:
                raise self.err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


class FailingIterator:
    """Test utility: raises after ``fail_at`` batches (node-failure drill)."""

    def __init__(self, it: Iterator, fail_at: int):
        self.it, self.fail_at, self.count = it, fail_at, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.count == self.fail_at:
            raise RuntimeError(f"injected data failure at batch {self.count}")
        self.count += 1
        return next(self.it)
