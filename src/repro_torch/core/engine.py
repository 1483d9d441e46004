"""Compute-engine abstraction.

The paper schedules across the Jetson's GPU and DLA. The cost model and
the HaX-CoNN scheduler consume only this abstraction. On one CUDA card the
two engines of a plan run as two CUDA streams (``serve.executor``); the
engine's constraint set stays a planning constraint. ``DevicePool`` slices
the host's devices into the engine groups of the serving fleets.
``h100_submesh_engines`` splits a mesh of H100 cards into a flexible and a
constrained engine for planning (the JAX package's TPU submesh pair).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..nn.module import tree_map

# ---- hardware constants -------------------------------------------------------
# NVIDIA H100 SXM published peaks (data sheet; dense, no sparsity), per card
H100_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
# one card's inter-node link: a 400 Gb/s NDR InfiniBand port
H100_LINK_BW = 50e9

# Jetson AGX Orin engine efficiencies, calibrated so that the cost model
# lands on the paper's measured standalone throughputs (Table IV context:
# Pix2Pix G is ~12.1 GFLOP/frame at 256x256; GPU ~172 FPS, balanced DLA
# ~148 FPS). These are *effective* (achieved) rates, not peaks.
JETSON_ORIN_GPU_FLOPS = 2.1e12
JETSON_ORIN_GPU_BW = 204.8e9
JETSON_ORIN_DLA_FLOPS = 1.85e12
JETSON_ORIN_DLA_BW = 102.4e9
JETSON_XFER_BW = 32e9  # engine<->engine via shared DRAM


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    n_chips: int
    peak_flops: float  # total achievable FLOP/s for the engine
    hbm_bw: float  # total bytes/s
    link_bw: float  # bytes/s to the peer engine
    constraints: tuple[Any, ...] = ()
    efficiency: float = 1.0  # multiplier on peak_flops (achievable utilization)
    # Optional concrete device this spec executes on. Excluded from
    # eq/hash: binding is a *placement* decision, so a bound slice plans
    # identically to the abstract specs it was derived from.
    device: Any = dataclasses.field(default=None, compare=False)

    @property
    def flops(self):
        return self.peak_flops * self.efficiency

    def bound(self, device) -> "EngineSpec":
        """This spec bound to a concrete device placement target."""
        return dataclasses.replace(self, device=device)

    def supports(self, layer) -> list:
        """Return the list of violated constraints for a layer (empty = legal).

        Composite metas (hierarchical graphs) are checked through their
        primitive decomposition too: a ``c2f`` block containing one
        illegal primitive is illegal as a whole at coarse granularity —
        the planner must expand it to route around the primitive.

        The result is memoized per (layer object, engine): the multi-cut
        planner calls this on every layer of every candidate span, and
        walking a composite's decomposition each time dominated planning
        profiles. Keying on the object identity is sound because graph
        rewrites (surgery, expansion) ``clone()`` metas rather than
        mutating them in place; the cached entry pins the layer so a
        recycled ``id`` can never alias a dead one. Callers must treat
        the returned list as read-only."""
        cache = self.__dict__.get("_supports_cache")
        if cache is None:
            cache = {}
            # frozen dataclass: the cache is identity-keyed scratch state,
            # not part of the spec's value (hash/eq are unaffected)
            object.__setattr__(self, "_supports_cache", cache)
        hit = cache.get(id(layer))
        if hit is not None and hit[0] is layer:
            return hit[1]
        out = []
        for c in self.constraints:
            v = c.check(layer)
            if v is not None:
                out.append(v)
        for sub in getattr(layer, "sublayers", None) or ():
            out.extend(self.supports(sub))
        cache[id(layer)] = (layer, out)
        return out


def jetson_orin_engines(constraints_dla=(), constraints_gpu=()):
    gpu = EngineSpec(
        "GPU", 1, JETSON_ORIN_GPU_FLOPS, JETSON_ORIN_GPU_BW, JETSON_XFER_BW, tuple(constraints_gpu)
    )
    dla = EngineSpec(
        "DLA", 1, JETSON_ORIN_DLA_FLOPS, JETSON_ORIN_DLA_BW, JETSON_XFER_BW, tuple(constraints_dla)
    )
    return gpu, dla


def h100_submesh_engines(
    n_big: int = 192,
    n_small: int = 64,
    constraints_small=(),
    efficiency: float = 0.6,
):
    """Split a 256-card mesh (the dry run's 16 x 16 production mesh) into a
    flexible 'GPU-analogue' engine and a constrained 'DLA-analogue' engine
    for concurrent multi-model serving: planning only (each engine's rates
    are its cards' published peaks, its link to the peer one NDR port per
    card of the smaller engine)."""
    big = EngineSpec(
        "H100-BIG",
        n_big,
        n_big * H100_BF16_FLOPS,
        n_big * H100_HBM_BW,
        H100_LINK_BW * min(n_big, n_small),
        (),
        efficiency,
    )
    small = EngineSpec(
        "H100-SMALL",
        n_small,
        n_small * H100_BF16_FLOPS,
        n_small * H100_HBM_BW,
        H100_LINK_BW * min(n_big, n_small),
        tuple(constraints_small),
        efficiency,
    )
    return big, small


class DevicePool:
    """Devices sliced into per-replica engine groups.

    The fleet (``repro_torch.serve.fleet``) replicates the planned pipeline
    R times; each replica gets a slice of the pool and an engine tuple
    bound to that slice. With several devices the slices are disjoint
    (``D // R`` devices each, round-robin reuse once R exceeds D); on a
    one-device pool (one CUDA card, or the CPU) every replica binds the
    virtual 2-engine GPU/DLA pair to that device, so the whole fleet still
    runs. Placement is exposed as per-engine ``place_fns`` (closures moving
    each state leaf with ``.to(device, non_blocking=True)``) in the shape
    ``StreamExecutor`` consumes; on a one-device pool they are the identity
    so the hot path pays nothing.

    ``devices`` defaults to every CUDA card (``torch.device("cuda", i)`` for
    ``i < torch.cuda.device_count()``); pass a list to pool others (the CPU
    tests pass ``[torch.device("cpu")]``).
    """

    def __init__(self, engines, devices=None):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("DevicePool needs at least one device (no CUDA card: pass devices=)")
        self.devices = list(devices)
        self.engines = tuple(engines)
        if not self.engines:
            raise ValueError("DevicePool needs at least one engine spec")

    @classmethod
    def discover(cls, engines=None, constraints_dla=(), constraints_gpu=(), devices=None):
        """Pool over the CUDA cards (or ``devices``); defaults to the
        Jetson-analogue (DLA, GPU) virtual pair in planning order when no
        specs are given."""
        if engines is None:
            gpu, dla = jetson_orin_engines(constraints_dla, constraints_gpu)
            engines = (dla, gpu)
        return cls(engines, devices=devices)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def replica_devices(self, replica: int, n_replicas: int) -> list:
        """The device slice backing one replica (wraps when R > D)."""
        if replica < 0 or replica >= n_replicas:
            raise ValueError(f"replica {replica} out of range for {n_replicas}")
        per = max(1, len(self.devices) // max(1, n_replicas))
        return [self.devices[(replica * per + j) % len(self.devices)] for j in range(per)]

    def worker_pool(self, worker: int, n_workers: int) -> "DevicePool":
        """A sub-pool over one worker *process*'s device slice.

        The multi-process fleet (``repro_torch.serve.multiproc``) spawns R
        workers; each builds its replica group over its share of the pool.
        Slicing reuses the replica round-robin (wraps when R exceeds D), so
        on a one-card host every worker sees the one card and placement
        stays the identity."""
        return DevicePool(self.engines, devices=self.replica_devices(worker, n_workers))

    def engine_slice(self, replica: int, n_replicas: int) -> tuple[EngineSpec, ...]:
        """The pool's engine specs bound to this replica's devices."""
        devs = self.replica_devices(replica, n_replicas)
        return tuple(e.bound(devs[i % len(devs)]) for i, e in enumerate(self.engines))

    def place_fns(self, replica: int, n_replicas: int) -> list:
        """Per-engine state-placement closures for ``StreamExecutor``."""
        if len(self.devices) == 1:
            # one device: a move would be a no-op round trip
            return [lambda state: state for _ in self.engines]
        fns = []
        for e in self.engine_slice(replica, n_replicas):
            dev = e.device
            fns.append(lambda state, dev=dev: tree_map(lambda x: x.to(dev, non_blocking=True), state))
        return fns
