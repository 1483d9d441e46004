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
CUDA graph (``jit_segments``). Fleets (``replicas``/``workers``) are not
ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable

import torch

from ..core.api import plan as core_plan
from ..core.cost_model import CostProvider, make_cost_provider
from ..core.plan_ir import PlanIR
from .admission import AdmissionConfig
from .batching import BatchConfig
from .demo import _build_pix_yolo_models, merge_flags_for, resolve_device
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
    server: MultiStreamServer
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
        """Release server resources (a no-op for the in-process server;
        kept for the fleets' context-manager protocol)."""

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
    # fleets (not ported yet)
    replicas: int = 1,
    workers: int = 0,
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

    ``replicas > 1`` and ``workers > 0`` raise ``NotImplementedError``:
    ``DevicePool`` and the fleets are queued in ROADMAP.md."""
    if replicas != 1:
        raise NotImplementedError(
            "replicas > 1 needs DevicePool and serve.fleet (queued in ROADMAP.md, module queue item 2)"
        )
    if workers:
        raise NotImplementedError(
            "workers > 0 needs serve.multiproc (queued in ROADMAP.md, module queue item 2)"
        )
    device = resolve_device(device)
    provider = cost if isinstance(cost, CostProvider) else make_cost_provider(cost)
    models, streams, (gpu, dla) = _build_pix_yolo_models(
        img=img, base=base, n_pix=n_pix, n_yolo=n_yolo, seed=seed, norm=norm,
        granularity=granularity, device=device,
    )
    plan_ir = core_plan(
        [m.graph for m in models],
        [dla, gpu],
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
    if replan:
        config = replan if isinstance(replan, ReplanConfig) else None
        replanner = Replanner(
            [m.graph for m in models], [dla, gpu], config=config, base_provider=provider
        )
        if calibration_path and os.path.exists(calibration_path) and not replanner.online.snapshot():
            try:
                replanner.load_calibration(calibration_path)
            except ValueError as e:
                # scales learned over another base provider are in other
                # units: calibrate live instead
                warnings.warn(f"calibration {calibration_path} not applicable, re-calibrating: {e}")
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
        device=device,
    )
