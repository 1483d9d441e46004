"""Multi-stream serving front end: request queue -> stream assignment ->
executor -> metrics.

``MultiStreamServer`` owns the planned ``StreamExecutor`` plus a global
request queue. Requests name a *model* (not a stream); the server assigns
each to the least-loaded stream bound to that model, pumps the executor
when queues back up, and folds completions into per-stream latency /
throughput metrics — the stand-in for the paper's DeepStream app. On a
CUDA card the executor runs each engine of the plan on its own stream.

Pass a ``serve.Replanner`` to close the online re-planning loop: the
server wires it into the executor (profiled ticks feed the ``OnlineCost``
EMA, the drift detector hot-swaps plans at frame boundaries) and folds
its state — per-engine scales, drift, swap events — into ``report()``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

from ..core.pipeline import StagedModel
from ..core.plan_ir import PlanIR
from ..core.scheduler import NModelPlan
from .admission import ADMIT, DROP, AdmissionConfig
from .batching import BatchConfig
from .executor import StreamExecutor
from .metrics import ServeMetrics, segment_summary
from .replanner import Replanner
from .streams import StreamSpec


@dataclasses.dataclass
class Request:
    model_index: int
    frame: Any


class MultiStreamServer:
    def __init__(
        self,
        models: list[StagedModel],
        plan: PlanIR | NModelPlan | list,
        streams: list[StreamSpec],
        max_queue: int = 4,
        microbatch: int = 1,
        merge_batches: bool | list[bool] = False,
        place_fns=None,
        dispatch: str = "overlapped",
        jit_segments: bool = True,
        replanner: Replanner | None = None,
        admission: AdmissionConfig | None = None,
        resolution_flexible: bool | list[bool] = False,
        batching: BatchConfig | None = None,
    ):
        self.executor = StreamExecutor(
            models,
            plan,
            streams,
            max_queue=max_queue,
            microbatch=microbatch,
            merge_batches=merge_batches,
            place_fns=place_fns,
            dispatch=dispatch,
            jit_segments=jit_segments,
            batching=batching,
        )
        self.replanner = replanner
        self.metrics = ServeMetrics(
            [s.name for s in streams], slos={s.name: s.slo for s in streams if s.slo is not None}
        )
        if replanner is not None:
            replanner.attach(self.executor)
            # close the SLO feedback loop: sustained deadline misses are a
            # re-plan trigger alongside queue growth and cost drift
            replanner.slo_miss_fn = self.metrics.recent_slo_miss_rate
        self.admission = admission
        if isinstance(resolution_flexible, bool):
            self.resolution_flexible = [resolution_flexible] * len(models)
        else:
            self.resolution_flexible = list(resolution_flexible)
        self._backlog: deque[Request] = deque()
        self._recorded = 0
        self._recorded_ticks = 0
        self._t0: float | None = None

    # -- request intake -----------------------------------------------------

    def submit(self, model_index: int, frame: Any):
        """Enqueue one frame for a model; assignment + execution happen in
        ``pump``/``drain``. Starts the wall clock on first submission."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._backlog.append(Request(model_index, frame))

    def _least_loaded_stream(self, model_index: int) -> int:
        ex = self.executor
        best, best_depth = -1, None
        for si, s in enumerate(ex.streams):
            if s.model_index != model_index:
                continue
            depth = len(ex.queues[si])
            if best_depth is None or depth < best_depth:
                best, best_depth = si, depth
        if best < 0:
            raise ValueError(f"no stream serves model index {model_index}")
        return best

    # -- open-loop intake ---------------------------------------------------

    def offer(self, target: int | str, frame: Any) -> str:
        """Open-loop admission: take one arriving frame *now*, without
        blocking and without backlogging — the open-loop counterpart of
        ``submit``/``pump``. ``target`` is a model index (assigned to its
        least-loaded stream) or a stream name.

        The admission controller reads the model's queue pressure and
        degrades in escalating order: shed resolution, shed staging, and —
        past ``drop_at`` — drop arrivals whose priority tier is not the
        highest contending one (their queued service time would come out
        of the high-priority streams' deadline budget). A full queue
        drops the arrival regardless of tier (it is the newest frame of
        its own stream). Returns the recorded decision (``admission``
        module constants)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        ex = self.executor
        si = self._least_loaded_stream(target) if isinstance(target, int) else ex._stream_index(target)
        spec = ex.streams[si]
        self.metrics.record_arrival(spec.name)
        decision, level = ADMIT, 0
        if self.admission is not None:
            pressure = ex.queue_pressure(spec.model_index)
            decision, level = self.admission.decide(pressure)
            if (
                self.admission.enabled
                and pressure >= self.admission.drop_at
                and spec.tier > self._min_tier(spec.model_index)
            ):
                self.metrics.record_admission(spec.name, DROP)
                return DROP
        if level >= 1 and not self.resolution_flexible[spec.model_index]:
            # shape-specialized model: record the shed intent but keep the
            # frame intact (level 2 still reroutes; level 1 becomes a no-op)
            degraded_frame = frame
        elif level >= 1:
            degraded_frame = self.admission.degrade(frame)
        else:
            degraded_frame = frame
        if not ex.submit(si, degraded_frame, degrade=level):
            self.metrics.record_admission(spec.name, DROP)
            return DROP
        self.metrics.record_admission(spec.name, decision)
        return decision

    def _min_tier(self, model_index: int) -> int:
        """Highest priority (lowest tier number) among the model's streams."""
        return min(
            (s.tier for s in self.executor.streams if s.model_index == model_index), default=0
        )

    def tick(self):
        """One executor tick + metrics fold — the open-loop driver's unit
        of service (it never blocks on admission the way ``pump`` does)."""
        self.executor.tick()
        self._fold_completions()

    def finish(self):
        """Fold any unrecorded completions/ticks (end-of-run bookkeeping)."""
        self._fold_completions()

    def reset_metrics(self):
        """Start a fresh measurement window: discard recorded metrics and
        the wall clock, keep the executor's compiled/warmed state and plan.
        The warm-then-measure idiom for benches — warmup frames (compiles,
        cache fills) should not pollute goodput-under-SLO numbers."""
        ex = self.executor
        self._fold_completions()  # drop anything pending into the old window
        self._recorded = len(ex.completions)
        self._recorded_ticks = len(ex.tick_stats)
        self.metrics = ServeMetrics(
            [s.name for s in ex.streams],
            slos={s.name: s.slo for s in ex.streams if s.slo is not None},
        )
        self._t0 = None
        if self.replanner is not None:
            self.replanner.slo_miss_fn = self.metrics.recent_slo_miss_rate

    # -- closed-loop intake -------------------------------------------------

    def pump(self):
        """Move backlog into stream queues, ticking the executor whenever
        the chosen queue pushes back; then fold new completions."""
        while self._backlog:
            req = self._backlog[0]
            si = self._least_loaded_stream(req.model_index)
            if self.executor.submit(si, req.frame):
                self._backlog.popleft()
            else:
                self.executor.tick()  # backpressure: make room before retrying
        self._fold_completions()

    def drain(self):
        self.pump()
        self.executor.run_until_drained()
        self._fold_completions()
        return self.executor.outputs

    def _fold_completions(self):
        for c in self.executor.completions[self._recorded :]:
            self.metrics.record(
                c.stream, c.latency_s, degrade=c.degrade, batch=c.batch, held=c.held
            )
        self._recorded = len(self.executor.completions)
        for t in self.executor.tick_stats[self._recorded_ticks :]:
            self.metrics.record_tick(t)
        self._recorded_ticks = len(self.executor.tick_stats)

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        wall = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        rep = self.metrics.report(wall)
        rep["dispatch"] = self.executor.dispatch
        rep["plan_revision"] = self.executor.plan_revision
        if self.replanner is not None:
            rep["replan"] = self.replanner.summary()
            rep["segments"] = segment_summary(self.executor.segment_obs)
        return rep
