"""Replicated serving fleet: R (plan, executor) groups behind a router.

The paper's headline scaling result is that two GPU-aware pipeline
instances double aggregate throughput over one — replicas, not just
better partitions, are the path past single-pipeline FPS. ``FleetServer``
runs R ``MultiStreamServer`` replicas over the *same* staged models and
the *same* ``PlanIR`` (one ``core.plan`` solved once over the per-replica
engine slice — the slices are value-identical, only their device binding
differs, so one solution serves every replica). The shared models hold
one CUDA-graph runner per planned span (``StagedModel.jitted_segment_fn``)
for every replica; each replica's executor makes its own two CUDA streams
and so captures its own graphs in its own pools, and a runner leaves the
model's cache only when the last replica running its span retires it. A
``DevicePool`` (``core.engine``) supplies each replica's engine slice and
the ``.to(device, non_blocking=True)`` placement closures its executor
applies per segment; on a one-device pool (one card, or the CPU) every
replica binds the virtual GPU/DLA pair to that device and placement
collapses to identity.

``FleetRouter`` assigns work to replicas by load: least outstanding
frames, deadline-pressure tie-break (a replica already carrying
tight-deadline streams yields to one carrying slack), then a seeded
replica permutation so ties resolve deterministically. Assignment is
*sticky per stream* — a stream's frames always land on the replica that
took its first arrival, so stream state, frame ordering, and micro-batch
merging stay replica-local. Routing is therefore a placement decision,
never a numerics change: per stream, a fleet run is bit-exact with the
same arrivals pushed through a single executor.

Each replica keeps its own ``Replanner`` (re-plans trigger from
replica-local drift), but all replanners may share one thread-safe
``OnlineCost`` so calibration is fleet-wide — ``serve.facade`` wires
exactly that.
"""
from __future__ import annotations

import random
import time
from typing import Any

from ..core.engine import DevicePool
from .executor import _param_device
from .metrics import fleet_report, router_imbalance, segment_summary
from .server import MultiStreamServer


class FleetRouter:
    """Deterministic load-aware stream->replica assignment.

    ``assign`` is sticky: the first arrival of a stream picks a replica by
    (outstanding frames, accumulated deadline pressure, seeded rank) and
    every later arrival of that stream follows it. ``route_arrival``
    additionally counts per-replica routed frames for the imbalance
    metric. Given the same seed and the same arrival sequence + load
    observations, assignments replay identically.
    """

    def __init__(self, n_replicas: int, seed: int = 0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas
        self.seed = seed
        # fixed seeded permutation: the deterministic last-resort tie-break
        order = list(range(n_replicas))
        random.Random(seed).shuffle(order)
        self._rank = {r: i for i, r in enumerate(order)}
        self.assignments: dict[str, int] = {}
        self.routed_frames = [0] * n_replicas
        # sum of 1/deadline_s over streams stuck to each replica — the
        # deadline-aware tie-break (tighter deadlines weigh heavier)
        self._deadline_pressure = [0.0] * n_replicas
        self._alive = set(range(n_replicas))

    def replica_of(self, stream: str) -> int | None:
        return self.assignments.get(stream)

    @property
    def alive(self) -> list[int]:
        return sorted(self._alive)

    def evict(self, replica: int) -> list[str]:
        """Remove a replica from routing (worker death / heartbeat miss):
        it never receives another pick, its deadline pressure is zeroed,
        and its sticky streams are unpinned so each one's next arrival
        re-routes to a survivor. Returns the migrated stream names."""
        if replica not in self._alive:
            return []
        self._alive.discard(replica)
        migrated = sorted(s for s, r in self.assignments.items() if r == replica)
        for s in migrated:
            del self.assignments[s]
        self._deadline_pressure[replica] = 0.0
        return migrated

    def pick(self, loads) -> int:
        """Least-loaded alive replica for non-sticky work (warmup,
        model-index submissions): same ordering, no assignment recorded."""
        if not self._alive:
            raise RuntimeError("no alive replicas to route to")
        return min(
            self._alive,
            key=lambda r: (loads[r], self._deadline_pressure[r], self._rank[r]),
        )

    def assign(self, stream: str, loads, deadline_s: float | None = None) -> int:
        """Sticky replica for one stream given current per-replica loads
        (outstanding frames). ``deadline_s`` feeds the pressure tie-break."""
        r = self.assignments.get(stream)
        if r is None or r not in self._alive:
            r = self.pick(loads)
            self.assignments[stream] = r
            if deadline_s and deadline_s > 0:
                self._deadline_pressure[r] += 1.0 / deadline_s
        return r

    def route_arrival(self, stream: str, loads, deadline_s: float | None = None) -> int:
        r = self.assign(stream, loads, deadline_s)
        self.routed_frames[r] += 1
        return r

    def reset_counts(self):
        """Fresh measurement window: zero the routed-frame counters but
        keep sticky assignments (streams stay where their state lives)."""
        self.routed_frames = [0] * self.n_replicas

    def summary(self) -> dict:
        return {
            "replicas": self.n_replicas,
            "seed": self.seed,
            "alive": self.alive,
            "evicted": sorted(set(range(self.n_replicas)) - self._alive),
            "streams_assigned": len(self.assignments),
            "routed_frames": list(self.routed_frames),
            "imbalance": router_imbalance(self.routed_frames),
            "assignments": dict(self.assignments),
        }


class LocalReplica:
    """In-process replica handle: the surface the router fronts replicas
    through, whatever their transport.

    ``FleetServer`` wraps each thread-local ``MultiStreamServer`` in one
    of these; ``serve.multiproc.RemoteReplica`` implements the *same*
    surface over a worker-process RPC pipe. Routing, service, drain, and
    report-merging code is written against this interface only, so the
    fleet is transport-agnostic — ``workers=0`` (in-process) stays the
    fast path and the bit-exactness oracle for the process fleet.

    Surface: ``alive`` flag; ``load`` (outstanding frames + backlog, the
    router's pick metric) and ``pending`` properties; ``offer`` /
    ``submit`` / ``tick`` / ``pump`` / ``drain`` / ``finish`` /
    ``reset_metrics`` service calls; ``deadline_of`` for the router's
    pressure tie-break; ``metrics`` / ``report`` for the fleet merge;
    ``close`` for teardown (a no-op in-process)."""

    def __init__(self, server: MultiStreamServer):
        self.server = server
        self.alive = True

    @property
    def load(self) -> int:
        return self.server.executor.pending + len(self.server._backlog)

    @property
    def pending(self) -> int:
        return self.server.executor.pending

    def offer(self, target: int | str, frame: Any) -> str:
        return self.server.offer(target, frame)

    def submit(self, model_index: int, frame: Any):
        self.server.submit(model_index, frame)

    def tick(self):
        if self.server.executor.pending:
            self.server.tick()

    def pump(self):
        self.server.pump()

    def drain(self) -> dict:
        return self.server.drain()

    def finish(self):
        self.server.finish()

    def reset_metrics(self):
        self.server.reset_metrics()

    def deadline_of(self, stream: str) -> float | None:
        for s in self.server.executor.streams:
            if s.name == stream:
                return s.slo.deadline_s if s.slo is not None else None
        return None

    def metrics(self):
        return self.server.metrics

    def report(self) -> dict:
        return self.server.report()

    def close(self):
        pass


class _FleetExecutorView:
    """Duck-typed stand-in for ``server.executor`` as open-loop drivers
    read it: ``pending`` totals outstanding frames across replicas; other
    (read-only) attributes proxy to replica 0's executor. Mutations must
    target ``fleet.servers[r].executor`` explicitly."""

    def __init__(self, servers):
        self._servers = servers

    @property
    def pending(self) -> int:
        return sum(s.executor.pending for s in self._servers)

    def __getattr__(self, attr):
        return getattr(self._servers[0].executor, attr)


class FleetServer:
    """R replicated serving pipelines behind a sticky load-aware router.

    Mirrors the ``MultiStreamServer`` surface (``offer``/``submit``/
    ``tick``/``pump``/``drain``/``finish``/``reset_metrics``/``report``)
    so the open-loop traffic driver and the benches run unchanged; every
    constructor knob is applied to each replica. ``pool`` defaults to a
    one-device pool over the models' device (the replicas share the models,
    so they share their device) with ``engines`` or the (DLA, GPU) pair.
    """

    def __init__(
        self,
        models,
        plan,
        streams,
        *,
        replicas: int = 2,
        pool: DevicePool | None = None,
        engines=None,
        router_seed: int = 0,
        max_queue: int = 4,
        microbatch: int = 1,
        merge_batches: bool | list[bool] = False,
        batching=None,
        dispatch: str = "overlapped",
        jit_segments: bool = True,
        replanners=None,
        admission=None,
        resolution_flexible: bool | list[bool] = False,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if pool is None:
            devices = [_param_device(models[0])]
            pool = DevicePool(engines, devices) if engines is not None else DevicePool.discover(devices=devices)
        if replanners is not None and len(replanners) != replicas:
            raise ValueError(f"need {replicas} replanners, got {len(replanners)}")
        self.pool = pool
        self.plan = plan
        self.models = models
        self.n_replicas = replicas
        self.servers = [
            MultiStreamServer(
                models,
                plan,
                streams,
                max_queue=max_queue,
                microbatch=microbatch,
                merge_batches=merge_batches,
                batching=batching,
                place_fns=pool.place_fns(r, replicas),
                dispatch=dispatch,
                jit_segments=jit_segments,
                replanner=replanners[r] if replanners is not None else None,
                admission=admission,
                resolution_flexible=resolution_flexible,
            )
            for r in range(replicas)
        ]
        self.handles = [LocalReplica(s) for s in self.servers]
        self.router = FleetRouter(replicas, seed=router_seed)
        self.executor = _FleetExecutorView(self.servers)
        self._t0: float | None = None

    # -- routing ------------------------------------------------------------

    def _loads(self) -> list[int]:
        return [h.load for h in self.handles]

    def _deadline_of(self, stream: str) -> float | None:
        return self.handles[0].deadline_of(stream)

    # -- open-loop intake ---------------------------------------------------

    def offer(self, target: int | str, frame: Any) -> str:
        """Route one arriving frame to a replica, then run that replica's
        admission ladder. Named streams are sticky; model-index targets go
        to the least-loaded replica."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if isinstance(target, str):
            r = self.router.route_arrival(target, self._loads(), self._deadline_of(target))
        else:
            r = self.router.pick(self._loads())
            self.router.routed_frames[r] += 1
        return self.handles[r].offer(target, frame)

    def tick(self):
        """Service every replica with outstanding work (one executor tick
        each + metrics fold)."""
        for h in self.handles:
            h.tick()

    def finish(self):
        for h in self.handles:
            h.finish()

    def reset_metrics(self):
        """Fresh measurement window on every replica + zeroed router frame
        counters; sticky assignments and warmed executors are kept."""
        for h in self.handles:
            h.reset_metrics()
        self.router.reset_counts()
        self._t0 = None

    # -- closed-loop intake -------------------------------------------------

    def submit(self, model_index: int, frame: Any):
        if self._t0 is None:
            self._t0 = time.perf_counter()
        r = self.router.pick(self._loads())
        self.router.routed_frames[r] += 1
        self.handles[r].submit(model_index, frame)

    def pump(self):
        for h in self.handles:
            h.pump()

    def drain(self) -> dict:
        outs: dict = {}
        for h in self.handles:
            for name, vals in h.drain().items():
                outs.setdefault(name, []).extend(vals)
        return outs

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        """Fleet-merged serving report over the shared wall clock, with
        router state and the per-replica reports nested under it."""
        wall = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        rep = fleet_report(
            [s.metrics for s in self.servers], wall, routed_counts=self.router.routed_frames
        )
        rep["dispatch"] = self.servers[0].executor.dispatch
        rep["plan_revision"] = max(s.executor.plan_revision for s in self.servers)
        rep["router"] = self.router.summary()
        if any(s.replanner is not None for s in self.servers):
            rep["replan"] = [
                s.replanner.summary() if s.replanner is not None else None for s in self.servers
            ]
            rep["segments"] = segment_summary(
                [o for s in self.servers for o in s.executor.segment_obs]
            )
        rep["per_replica"] = [s.report() for s in self.servers]
        return rep
