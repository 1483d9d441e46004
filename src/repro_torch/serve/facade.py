"""``build_server`` — the one-call serving facade.

``build_server`` builds the whole serving stack for the repo's reference
workload (Pix2Pix reconstruction + YOLOv8 detection on the calibrated
Jetson engine pair, planned through ``repro_torch.core.plan``) on one
device, and returns a ``ServerBundle`` holding each layer:

    bundle = build_server(n_pix=4, n_yolo=1, deadline_ms=50.0,
                          traffic=TrafficConfig(process="poisson", rate_hz=30),
                          admission=True)
    report = bundle.run_open_loop(horizon_s=2.0)

It runs on the CUDA card unless ``device`` names another; each engine of
the plan is one CUDA stream there, and each planned segment a captured
CUDA graph (``jit_segments``). ``replicas`` replicates the planned pipeline
in this process (``FleetServer``), ``workers`` in worker processes
(``ProcFleetServer``), each behind the sticky load-aware ``FleetRouter``.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable

import torch

from ..core.api import plan as core_plan
from ..core.cost_model import CostProvider, OnlineCost, make_cost_provider
from ..core.engine import DevicePool
from ..core.plan_ir import PlanIR
from .admission import AdmissionConfig
from .batching import BatchConfig
from .demo import _build_pix_yolo_models, merge_flags_for, resolve_device
from .fleet import FleetServer
from .multiproc import ProcFleetServer
from .replanner import ReplanConfig, Replanner
from .server import MultiStreamServer
from .streams import StreamSpec
from .traffic import SLOPolicy, TrafficConfig, run_open_loop


@dataclasses.dataclass
class ServerBundle:
    """Every layer of one constructed serving stack, plus drivers.

    ``traffic`` maps stream name -> ``TrafficConfig`` (empty when built
    without open-loop traffic); ``replanner``/``admission`` are None when
    those layers are off."""

    models: list
    plan: PlanIR
    streams: list[StreamSpec]
    engines: tuple  # planning order: (dla, gpu)
    provider: CostProvider
    server: MultiStreamServer | FleetServer | ProcFleetServer
    replanner: Replanner | None
    admission: AdmissionConfig | None
    traffic: dict[str, TrafficConfig]
    img: int = 64
    replicas: int = 1
    workers: int = 0
    device: torch.device = torch.device("cpu")

    def frame_for(self, stream_name: str, t: int = 0):
        """A deterministic input frame for the named stream, drawn from a
        ``torch.Generator`` seeded ``1000 * stream_index + t`` on the
        bundle's device — the default open-loop source. The values differ
        from the JAX package's frames (``jax.random`` draws other numbers
        from the same seed)."""
        si = next(i for i, s in enumerate(self.streams) if s.name == stream_name)
        g = torch.Generator(self.device)
        g.manual_seed(1000 * si + t)
        return torch.randn((1, self.img, self.img, 3), generator=g, device=self.device)

    def run_open_loop(
        self,
        horizon_s: float,
        frame_fn: Callable[[str], Any] | None = None,
        drain: bool = True,
        max_wall_s: float | None = None,
    ) -> dict:
        """Drive the server with the bundle's traffic processes for
        ``horizon_s`` seconds of arrival time; returns ``server.report()``."""
        if not self.traffic:
            raise ValueError("bundle was built without traffic; pass traffic= to build_server")
        if frame_fn is None:
            counts: dict[str, int] = {}

            def frame_fn(name: str):
                t = counts.get(name, 0)
                counts[name] = t + 1
                return self.frame_for(name, t)

        return run_open_loop(
            self.server, self.traffic, frame_fn, horizon_s, drain=drain, max_wall_s=max_wall_s
        )

    def report(self) -> dict:
        return self.server.report()

    def close(self):
        """Release server resources — shuts down the worker processes of a
        multi-process fleet; a no-op for in-process servers."""
        close = getattr(self.server, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "ServerBundle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _normalize_slos(slos, deadline_ms, streams: list[StreamSpec]):
    """Resolve the facade's SLO inputs to one policy (or None) per stream.

    ``slos`` may be a single ``SLOPolicy`` (every stream), a dict keyed by
    stream name or model index, or None. ``deadline_ms`` is the shorthand:
    one deadline for all streams, detection streams (model 1) at tier 0
    and reconstruction streams at tier 1 — the paper's priority split."""
    if slos is None and deadline_ms is None:
        return [None] * len(streams)
    out = []
    for s in streams:
        if isinstance(slos, SLOPolicy):
            out.append(slos)
        elif isinstance(slos, dict):
            p = slos.get(s.name, slos.get(s.model_index))
            out.append(p)
        else:
            tier = 0 if s.model_index == 1 else 1
            out.append(SLOPolicy(deadline_ms=deadline_ms, tier=tier, name=f"{s.name}-slo"))
    return out


def _warm_start(target, path: str | None) -> None:
    """Load the calibration JSON at ``path`` into ``target`` (a
    ``Replanner``, which also baselines its drift detector on it, or an
    ``OnlineCost``) when the file exists and ``target`` has no scales yet.
    Scales learned over another base provider are in other units: they
    warn and are not loaded, and the re-planner calibrates live."""
    online = getattr(target, "online", target)
    if not path or not os.path.exists(path) or online.snapshot():
        return
    try:
        target.load_calibration(path)
    except ValueError as e:
        warnings.warn(f"calibration {path} not applicable, re-calibrating: {e}")


def _normalize_traffic(traffic, streams: list[StreamSpec]) -> dict[str, TrafficConfig]:
    """One ``TrafficConfig`` per stream: a single config fans out to every
    stream (re-seeded per stream so arrival processes are independent);
    a dict keyed by stream name passes through (missing names get no
    traffic)."""
    if traffic is None:
        return {}
    if isinstance(traffic, TrafficConfig):
        return {
            s.name: dataclasses.replace(traffic, seed=traffic.seed + si)
            for si, s in enumerate(streams)
        }
    unknown = set(traffic) - {s.name for s in streams}
    if unknown:
        raise ValueError(f"traffic for unknown streams: {sorted(unknown)}")
    return dict(traffic)


def build_server(
    *,
    # workload
    img: int = 64,
    base: int = 8,
    n_pix: int = 4,
    n_yolo: int = 1,
    seed: int = 0,
    norm: str = "batch",
    # planning (repro_torch.core.plan)
    cost: str | CostProvider = "analytic",
    search: str = "auto",
    granularity: str = "coarse",
    stride: int = 1,
    max_cuts: int | str = 1,
    impl: str = "xla",
    # serving
    max_queue: int = 4,
    microbatch: int = 1,
    merge_batches: bool | list[bool] | None = None,
    batching: BatchConfig | int | None = None,
    dispatch: str = "overlapped",
    jit_segments: bool = True,
    # SLOs + open loop
    slos: SLOPolicy | dict | None = None,
    deadline_ms: float | None = None,
    traffic: TrafficConfig | dict[str, TrafficConfig] | None = None,
    admission: AdmissionConfig | bool | None = None,
    resolution_flexible: bool | list[bool] = False,
    # online re-planning
    replan: bool | ReplanConfig = False,
    calibration_path: str | None = None,
    # fleet replication
    replicas: int = 1,
    router_seed: int = 0,
    # multi-process fleet
    workers: int = 0,
    calib_sync_every: int = 16,
    # placement
    device: str | torch.device | None = None,
) -> ServerBundle:
    """Build the full serving stack in one call; see module docstring.

    ``device=None`` is the CUDA card, and raises without one; pass
    ``device="cpu"`` to run on the CPU. ``merge_batches=None`` derives the
    per-model flags from batch independence (``merge_flags_for``).
    ``batching`` turns on the deadline-aware continuous-batching
    coalescer: pass a ``BatchConfig`` or an int shorthand (``batching=8``
    == ``BatchConfig(max_batch=8)``); it only engages on batch-independent
    models. ``admission=True`` uses the default degradation ladder.
    ``deadline_ms`` is the SLO shorthand (detection tier 0,
    reconstruction tier 1); pass ``slos`` for full control. ``impl``
    selects the implementation-planning mode (``xla`` | ``auto`` |
    ``pallas``); segments planned ``pallas_fused`` run the fused CUDA
    serving kernels on the card. ``jit_segments`` captures each planned
    segment in a CUDA graph on the card and replays it (bit-identical to
    the eager ops; ``False`` runs them eagerly).

    ``replan=True`` attaches a ``Replanner`` with the default
    ``ReplanConfig`` (or pass one) over the planning provider — an
    ``OnlineCost`` provider is reused, so the live observations feed it.
    ``calibration_path`` warm-starts that re-planner's per-engine scales
    from a ``save_calibration`` JSON when the file exists and the provider
    has none yet (a calibration learned over another base provider warns
    and is not loaded: the re-planner calibrates live).

    ``replicas > 1`` returns the bundle over a ``FleetServer``: R
    replicated (plan, executor) groups over a ``DevicePool`` on ``device``
    behind a sticky load-aware ``FleetRouter`` seeded ``router_seed``. The
    plan is solved once — over replica 0's engine slice, which is
    value-identical to every other slice (only the device binding
    differs) — and with ``replan`` each replica gets its own ``Replanner``,
    all sharing one thread-safe ``OnlineCost`` so calibration is
    fleet-wide.

    ``workers > 0`` returns the bundle over a ``ProcFleetServer`` instead:
    R worker *processes* on ``device``, each rebuilding the same replica
    group from the serialized plan, behind the same sticky router over IPC
    (``serve.multiproc``). Mutually exclusive with ``replicas > 1`` — one
    replica group per worker process. ``cost`` must then be a provider
    name (the build spec crosses the process boundary as JSON), and with
    ``replan`` on the workers' calibrations sync fleet-wide every
    ``calib_sync_every`` front ticks, checkpointing atomically to
    ``calibration_path`` (which also warm-starts workers on spawn). Call
    ``bundle.close()`` (or use the bundle as a context manager) to shut
    the workers down."""
    if workers and replicas > 1:
        raise ValueError(
            "workers and replicas are mutually exclusive: a multi-process fleet "
            "hosts one replica group per worker process"
        )
    if workers and not isinstance(cost, str):
        raise ValueError(
            "multi-process fleet needs a cost provider *name* (the build spec "
            f"crosses the process boundary as JSON), got {type(cost).__name__}"
        )
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    device = resolve_device(device)
    provider = cost if isinstance(cost, CostProvider) else make_cost_provider(cost)
    models, streams, (gpu, dla) = _build_pix_yolo_models(
        img=img, base=base, n_pix=n_pix, n_yolo=n_yolo, seed=seed, norm=norm,
        granularity=granularity, device=device,
    )
    # in-process replicas share the models, so they share their device
    pool = DevicePool((dla, gpu), devices=[device])
    # one plan serves every replica: slice 0's bound engines plan exactly
    # like the abstract pair (device binding is excluded from spec equality)
    plan_engines = list(pool.engine_slice(0, replicas)) if replicas > 1 else [dla, gpu]
    plan_ir = core_plan(
        [m.graph for m in models],
        plan_engines,
        search=search,
        stride=stride,
        max_cuts=max_cuts,
        cost=provider,
        impl=impl,
    )
    policies = _normalize_slos(slos, deadline_ms, streams)
    streams = [
        dataclasses.replace(s, slo=p) if p is not None else s
        for s, p in zip(streams, policies)
    ]
    if merge_batches is None:
        merge_batches = merge_flags_for(models)
    if isinstance(batching, int):
        batching = BatchConfig(max_batch=batching)
    if admission is True:
        admission = AdmissionConfig()
    elif admission is False:
        admission = None
    replanner = None
    replanners = None
    if replan and not workers:
        config = replan if isinstance(replan, ReplanConfig) else None
        graphs = [m.graph for m in models]
        if replicas > 1:
            # one shared OnlineCost: every replica's Replanner reuses the
            # instance (thread-safe drain), so all replicas' segment
            # observations feed a single fleet-wide calibration store
            shared = provider if isinstance(provider, OnlineCost) else OnlineCost(base=provider)
            _warm_start(shared, calibration_path)
            replanners = [
                Replanner(graphs, [dla, gpu], config=config, base_provider=shared) for _ in range(replicas)
            ]
            replanner = replanners[0]
        else:
            replanner = Replanner(graphs, [dla, gpu], config=config, base_provider=provider)
            _warm_start(replanner, calibration_path)
    if workers:
        # workers rebuild their replanners in-process; the front only
        # carries the serialized config (True -> worker-side default)
        replan_payload = None
        if replan:
            replan_payload = dataclasses.asdict(replan) if isinstance(replan, ReplanConfig) else {}
        server = ProcFleetServer(
            plan_ir,
            streams,
            workers=workers,
            build={
                "img": img, "base": base, "n_pix": n_pix, "n_yolo": n_yolo,
                "seed": seed, "norm": norm, "granularity": granularity, "device": str(device),
            },
            router_seed=router_seed,
            max_queue=max_queue,
            microbatch=microbatch,
            merge_batches=merge_batches,
            batching=batching,
            dispatch=dispatch,
            jit_segments=jit_segments,
            admission=admission,
            resolution_flexible=resolution_flexible,
            cost=cost,
            replan=replan_payload,
            calibration_path=calibration_path,
            calib_sync_every=calib_sync_every,
        )
    elif replicas > 1:
        server = FleetServer(
            models,
            plan_ir,
            streams,
            replicas=replicas,
            pool=pool,
            router_seed=router_seed,
            max_queue=max_queue,
            microbatch=microbatch,
            merge_batches=merge_batches,
            batching=batching,
            dispatch=dispatch,
            jit_segments=jit_segments,
            replanners=replanners,
            admission=admission,
            resolution_flexible=resolution_flexible,
        )
    else:
        server = MultiStreamServer(
            models,
            plan_ir,
            streams,
            max_queue=max_queue,
            microbatch=microbatch,
            merge_batches=merge_batches,
            batching=batching,
            dispatch=dispatch,
            jit_segments=jit_segments,
            replanner=replanner,
            admission=admission,
            resolution_flexible=resolution_flexible,
        )
    return ServerBundle(
        models=models,
        plan=plan_ir,
        streams=streams,
        engines=(dla, gpu),
        provider=provider,
        server=server,
        replanner=replanner,
        admission=admission,
        traffic=_normalize_traffic(traffic, streams),
        img=img,
        replicas=replicas,
        workers=workers,
        device=device,
    )
