"""Online re-planning control loop: drift detection + live plan hot-swap.

The paper's engine allocation is only optimal while the per-layer costs
it was planned against still hold; on real edge deployments they drift
with batch size, thermal state, and co-located load. The ``Replanner``
closes the loop:

  1. **observe** — the executor's profiled ticks emit per-segment wall
     times (``SegmentObservation``). Observations accumulate per (tick,
     engine) and fold into an ``OnlineCost`` EMA as one magnitude-weighted
     (engine -> sum observed / sum expected) ratio per profiled tick —
     big segments dominate, so host-overhead noise on near-empty spans
     cannot swing the scale. *Expected* is re-derived from the graphs
     under the base provider — a fixed base-units -> wall-clock
     calibration that survives plan swaps regardless of which provider
     scored the active plan.
  2. **detect** — after calibration (every engine seen ``warmup_obs``
     times), per-engine drift is the relative change of its scale vs the
     calibration snapshot. The detector requires ``hysteresis``
     consecutive ticks above ``drift_threshold`` (noise stays quiet) and
     ``cooldown_ticks`` between swaps (no thrashing).
  3. **re-plan** — the beam-search planner re-runs on the live-calibrated
     costs, at the *incumbent plan's cut budget* (``max_cuts``: a
     multi-cut plan is re-planned as a multi-cut plan; override with
     ``ReplanConfig.max_cuts``). With ``partial_swaps`` the loop first
     tries a **partial re-plan**: every model's route is held fixed
     except the one carrying the most planned work on the most-drifted
     engine; if that single-route plan predicts a cycle within
     ``partial_tolerance`` of the full re-plan's, only the drifted route
     is swapped (recorded as a partial swap in ``metrics.SwapStall``).
     The refreshed costs also re-score the *current* routes (``fixed=``
     evaluation), and the swap only happens if the chosen plan's
     predicted cycle beats that by ``min_improvement``.
  4. **swap** — ``executor.prepare_plan`` warms the new segment
     executables on zero states (off the hot path), then
     ``executor.swap_plan`` installs the plan at the frame boundary:
     in-flight frames finish on their admitted routes, zero drops.

**Coarse -> fine escalation** (``escalate_after > 0``): after that many
drift-triggered re-plans the loop escalates its planning granularity —
sustained drift means the coarse cut set cannot rebalance the engines,
so the re-planner widens the search to the fine-grained boundary space.
Two deployments:

  * planner graphs == executor graphs (the common case): escalation
    re-plans with ``escalate_stride`` instead of ``stride`` — on
    expanded-graph deployments that unlocks the full stage-boundary cut
    set the initial (strided) plan skipped.
  * planner graphs are *coarse* while the executor's models were staged
    *fine* (cheap-planning deployment; detected at ``attach`` by layer
    counts): normal re-plans run on the coarse graphs and are translated
    to fine indices (``plan_ir.translate_ir``); escalation switches the
    planning graphs to the expansions themselves, unlocking cuts inside
    composite blocks that coarse planning cannot express.

``background=True`` runs step 3 *and* the ``prepare_plan`` warmup in a
worker thread on a snapshot of the scales — the hot loop only pays for
the swap itself; the default is synchronous for deterministic tests. An
executor that captures CUDA graphs (``StreamExecutor.captures_graphs``)
is warmed on the serving thread instead, when the planned swap is picked
up: a capture must not run while another thread launches work on the
card, so there the worker only plans. Either way the
per-swap hot-path stall is recorded as a ``metrics.SwapStall`` and
folded into ``summary()``. An ``OnlineCost`` whose scales were
warm-started from a calibration JSON (``--calibration-cache``) seeds the
drift baseline immediately — no warmup ticks needed after a restart.
Attach to any ``StreamExecutor`` via ``attach`` (sets ``profile_every``,
``on_segment``, ``on_tick``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

from ..core.api import plan as core_plan
from ..core.cost_model import ANALYTIC, CostProvider, OnlineCost, _effective_impls
from ..core.plan_ir import PlanIR, translate_ir
from .executor import SegmentObservation, StreamExecutor
from .metrics import SwapStall, swap_stall_summary


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the drift detector + re-plan loop (see module docstring)."""

    drift_threshold: float = 0.6  # relative scale change that counts as drift
    hysteresis: int = 3  # consecutive drifting ticks required to fire
    cooldown_ticks: int = 10  # min ticks between plan swaps
    min_improvement: float = 0.05  # predicted cycle gain required to swap
    ema_alpha: float = 0.25  # OnlineCost EMA coefficient
    warmup_obs: int = 8  # per-engine folded ticks before auto-calibration
    profile_every: int = 2  # executor segment-profiling cadence (ticks)
    search: str = "auto"  # planner search mode for re-plans
    beam_width: int = 64
    stride: int = 1  # candidate cut-point stride (match the initial plan's)
    background: bool = False  # plan + prepare in a worker thread (off the hot path)
    max_cuts: int = 0  # cut budget for re-plans; 0 = inherit the incumbent plan's
    partial_swaps: bool = True  # try single-route re-plans before full swaps
    # a partial plan is preferred when its predicted cycle is within this
    # factor of the full re-plan's (it swaps one route instead of all)
    partial_tolerance: float = 0.02
    escalate_after: int = 0  # drift fires before escalating granularity (0 = never)
    escalate_stride: int = 1  # the stride escalated re-plans search with
    # -- load-pressure trigger (0.0 = disabled) ----------------------------
    # Sustained queue growth or SLO-miss rate fires a re-plan too: an
    # overloaded server is mis-planned for the *offered* load even when
    # no per-engine cost has drifted.
    load_threshold: float = 0.0  # aggregate queue fill fraction that counts as pressure
    slo_miss_threshold: float = 0.0  # recent deadline-miss rate that counts as pressure
    load_hysteresis: int = 5  # consecutive pressured ticks required to fire


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    tick: int
    drift: dict[str, float]
    old_partitions: tuple[int, ...]
    new_partitions: tuple[int, ...]
    old_cycle: float  # current routes re-scored under live costs
    new_cycle: float  # candidate plan under live costs
    swapped: bool
    revision: int  # executor plan revision after the event
    old_cuts: tuple[tuple[int, ...], ...] = ()
    new_cuts: tuple[tuple[int, ...], ...] = ()
    partial: bool = False  # only the drifted model's route was re-planned
    escalated: bool = False  # this re-plan ran at escalated granularity
    trigger: str = "drift"  # what fired this re-plan: drift | load


class Replanner:
    """Watches one executor's live segment costs and hot-swaps its plan."""

    def __init__(
        self,
        graphs: Sequence,
        engines: Sequence,
        config: ReplanConfig | None = None,
        base_provider: CostProvider | None = None,
        allow_fallback: bool = True,
    ):
        self.graphs = list(graphs)
        self.engines = list(engines)
        self.config = config or ReplanConfig()
        if isinstance(base_provider, OnlineCost):
            # reuse the caller's OnlineCost (e.g. --cost online planned the
            # initial routes with it) instead of double-wrapping: the same
            # instance then receives the live observations, so later
            # planning calls through the caller's handle see the scales
            self.online = base_provider
            self.online.alpha = self.config.ema_alpha
        else:
            self.online = OnlineCost(base_provider or ANALYTIC, alpha=self.config.ema_alpha)
        self.allow_fallback = allow_fallback
        self.events: list[ReplanEvent] = []
        self.swap_stalls: list[SwapStall] = []
        self._baseline: dict[str, float] = {}  # calibration snapshot of scales
        if self.online.calibrated([e.name for e in self.engines]):
            # warm-started scales (e.g. loaded from a calibration JSON):
            # baseline immediately instead of waiting out warmup_obs ticks
            self._baseline = self.online.snapshot()
        self._obs_count: dict[str, int] = {}
        self._tick_acc: dict[str, list[float]] = {}  # engine -> [wall, expected]
        self._above = 0  # consecutive drifting ticks (hysteresis counter)
        self._load_above = 0  # consecutive load-pressured ticks
        # Hook for the SLO-pressure signal: () -> recent deadline-miss rate
        # (the server wires metrics.recent_slo_miss_rate here).
        self.slo_miss_fn = None
        self._last_swap_tick: int | None = None
        self._expected_cache: dict[tuple[int, int, int, int, str, int], float] = {}
        # continuous-batching state: the admission bucket the incumbent
        # plan was scored at, a magnitude-weighted EMA of the buckets
        # observed flights actually ran at, and the hysteresis counter of
        # the batch-shift trigger (sustained concurrency change re-plans
        # even when no per-engine scale has drifted)
        self._planned_batch = 1
        self._batch_ema = 1.0
        self._batch_above = 0
        self._tick_batch: list[float] = [0.0, 0.0]  # [sum bucket*w, sum w]
        # implementation-selection mode re-plans run with; inherited from
        # the attached executor's plan (and refreshed on every swap)
        self._impl_mode = "xla"
        self._job: threading.Thread | None = None
        self._job_result: list = []
        # granularity state: _fine holds the expanded planning graphs when
        # the executor's models are staged finer than self.graphs (plans
        # are then translated to fine indices); _escalated flips planning
        # onto the fine graphs / escalate_stride after sustained drift
        self._fine = None
        self._translate = False
        self._escalated = False
        self._fires = 0  # drift-triggered re-plans (escalation counter)
        self._incumbent_max_cuts = 1

    # -- wiring -------------------------------------------------------------

    def attach(self, executor: StreamExecutor) -> StreamExecutor:
        """Wire the feedback loop into an executor (observer + tick hook).

        When the executor's staged models carry more layers than the
        planning graphs (fine staging, coarse planning), the expansions
        must match the staged layer counts — re-plans are then made
        coarse and translated to fine indices, and escalation switches
        planning onto the expansions themselves."""
        if executor.plan.n_engines != len(self.engines):
            raise ValueError(
                f"replanner has {len(self.engines)} engines but plan uses {executor.plan.n_engines}"
            )
        n_exec = list(executor.plan.n_layers)
        if [len(g) for g in self.graphs] != n_exec:
            fine = [g.expand() for g in self.graphs]
            if [len(g) for g in fine] != n_exec:
                raise ValueError(
                    f"replanner graphs ({[len(g) for g in self.graphs]} layers) match "
                    f"neither the executor's models ({n_exec}) nor their expansions"
                )
            self._fine = fine
            self._translate = True
        self._incumbent_max_cuts = executor.plan.max_cuts
        self._impl_mode = getattr(executor.plan, "impl_mode", "xla")
        self._planned_batch = max(int(getattr(executor.plan, "batch", 1)), 1)
        self._batch_ema = float(self._planned_batch)
        executor.profile_every = max(1, self.config.profile_every)
        executor.on_segment = self.observe
        executor.on_tick = self.maybe_replan
        return executor

    # -- observation --------------------------------------------------------

    @property
    def _exec_graphs(self):
        """Graphs in the executor's (staged) index space — what profiled
        observations and incumbent plans are expressed in."""
        return self._fine if self._translate else self.graphs

    def _plan_graphs(self):
        """Graphs the next re-plan searches: coarse until escalation
        switches to the fine expansions (no-op when not translating)."""
        if self._translate and self._escalated:
            return self._fine
        return self.graphs

    def _expected_base(
        self, model_index: int, engine: int, lo: int, hi: int, impl: str = "xla", batch: int = 1
    ) -> float:
        """Base-provider cost of graph[lo:hi) on the engine — the fixed
        denominator of the wall-clock calibration (never a scaled plan's
        expected_cost, which would drift with each re-plan). Spans are
        executor-space indices, so the expectation walks the executor's
        graphs — under the implementation the span actually ran with, so
        each variant calibrates against its own expectation. ``batch``
        derives the expectation at the bucket the span actually ran at
        (per-frame amortized), so the modeled amortization curve cancels
        out of the engine scale instead of reading as drift."""
        key = (model_index, engine, lo, hi, impl, batch)
        t = self._expected_cache.get(key)
        if t is None:
            g = self._exec_graphs[model_index]
            e = self.engines[engine]
            eff = _effective_impls(g, lo, hi, impl)
            t = sum(
                self.online.base.layer_time(
                    g[i], e, eff[i - lo] if eff else "xla", batch=batch
                )
                for i in range(lo, hi)
            )
            self._expected_cache[key] = t
        return t

    def observe(self, obs: SegmentObservation):
        """Accumulate one profiled segment into the current tick's
        per-engine (wall, expected) sums; ``_fold_tick`` turns each sum
        pair into one magnitude-weighted EMA sample at the frame boundary
        (per-segment ratios on near-empty spans are all host overhead —
        summing first keeps them from swinging the scale)."""
        impl = getattr(obs, "impl", "xla")
        # coalesced flights run the span once for the whole (padded)
        # bucket; normalize wall AND expectation to that bucket so the
        # modeled batching amortization cancels out of the engine scale.
        # What remains in the per-bucket channels below is the *residual*
        # — how far the bucket's real batched wall deviates from the
        # amortization curve the planner scored it with.
        bucket = max(int(getattr(obs, "bucket", 0)), int(getattr(obs, "batch", 1)), 1)
        expected = self._expected_base(obs.model_index, obs.engine, obs.lo, obs.hi, impl, bucket)
        wall = obs.wall_s / bucket
        name = self.engines[obs.engine].name
        acc = self._tick_acc.setdefault(name, [0.0, 0.0])
        acc[0] += wall
        acc[1] += expected
        if impl != "xla":
            # fold into the variant's own calibration channel too, so
            # drift in one implementation (and only it) can flip the
            # planner's per-segment impl choice on the next re-plan
            ch = self._tick_acc.setdefault(f"{name}|{impl}", [0.0, 0.0])
            ch[0] += wall
            ch[1] += expected
        if bucket > 1:
            # per-bucket calibration channel (``OnlineCost.scale_for``
            # resolves ``{engine}[|{impl}]|b{bucket}`` before falling back
            # to the engine-wide scale): drift in one bucket's batching
            # efficiency re-scores plans at that bucket, and only them
            base_ch = name if impl == "xla" else f"{name}|{impl}"
            bch = self._tick_acc.setdefault(f"{base_ch}|b{bucket}", [0.0, 0.0])
            bch[0] += wall
            bch[1] += expected
        # magnitude-weighted admission-bucket sample for the batch-shift
        # trigger (big spans dominate, matching the scale folding above)
        self._tick_batch[0] += bucket * obs.wall_s
        self._tick_batch[1] += obs.wall_s

    def _fold_tick(self):
        for name, (wall, expected) in self._tick_acc.items():
            self.online.observe(name, wall, expected)
            self._obs_count[name] = self._obs_count.get(name, 0) + 1
        self._tick_acc.clear()
        if self._tick_batch[1] > 0:
            mean = self._tick_batch[0] / self._tick_batch[1]
            a = self.config.ema_alpha
            self._batch_ema = (1.0 - a) * self._batch_ema + a * mean
            self._tick_batch = [0.0, 0.0]

    # -- drift detection ----------------------------------------------------

    @property
    def calibrated(self) -> bool:
        return bool(self._baseline)

    def _try_calibrate(self):
        names = [e.name for e in self.engines]
        if all(self._obs_count.get(n, 0) >= self.config.warmup_obs for n in names):
            self._baseline = self.online.snapshot()

    def drift(self) -> dict[str, float]:
        """Per-engine relative scale change vs the calibration snapshot."""
        if not self._baseline:
            return {}
        out = {}
        for name, base in self._baseline.items():
            cur = self.online.scale(name)
            out[name] = abs(cur / base - 1.0) if base > 0 else 0.0
        return out

    def _rebaseline(self):
        self._baseline = self.online.snapshot()
        self._above = 0
        self._load_above = 0

    def calibrate(self):
        """Snapshot the current scales as the drift baseline now — callers
        that control warmup (benches) use this right after it, once
        first-use walls (kernel builds, graph captures) have washed out of
        the EMA, instead of waiting
        for ``warmup_obs`` folded ticks."""
        self._fold_tick()
        self._rebaseline()

    def load_calibration(self, path: str) -> "Replanner":
        """Warm-start from a persisted calibration (``--calibration-cache``):
        restore the per-engine EMA state into the ``OnlineCost`` and, when
        it covers every engine, seed the drift baseline from it — works
        regardless of which base provider the online calibrator wraps."""
        self.online.load_calibration(path)
        if self.online.calibrated([e.name for e in self.engines]):
            self._baseline = self.online.snapshot()
        return self

    # -- planning -----------------------------------------------------------

    @property
    def escalated(self) -> bool:
        return self._escalated

    def _active_max_cuts(self) -> int:
        return self.config.max_cuts or self._incumbent_max_cuts

    def _plan(self, online: OnlineCost, fixed=None) -> PlanIR:
        cfg = self.config
        return core_plan(
            self._plan_graphs(),
            self.engines,
            allow_fallback=self.allow_fallback,
            cost=online,
            search=cfg.search,
            beam_width=cfg.beam_width,
            stride=cfg.escalate_stride if self._escalated else cfg.stride,
            max_cuts=self._active_max_cuts(),
            fixed=fixed,
            impl=self._impl_mode,
            batch=self._planned_batch,
        )

    def _score_fixed(self, routes, online: OnlineCost) -> float:
        """Re-score pinned routes under the live costs. ``routes`` entries
        are planning-space ``(cuts, engines)`` specs (or bare ints)."""
        return self._plan(online, fixed=list(routes)).expected_cycle

    def _incumbent_routes(self, plan: PlanIR):
        """The executor's live routes in *planning-space* indices, or None
        when they are not expressible there (a fine cut inside a
        composite while still planning coarse — forces escalation)."""
        specs = plan.route_specs()
        if not self._translate or self._escalated:
            return specs
        out = []
        for (cuts, engines), g in zip(specs, self._fine):
            coarse = tuple(g.coarse_cut(c) for c in cuts)
            if any(c is None for c in coarse):
                return None
            out.append((coarse, engines))
        return out

    def _to_exec_ir(self, ir: PlanIR, models: tuple[str, ...]) -> PlanIR:
        """Translate a planning-space IR to executor indices (identity
        unless planning coarse for a fine-staged executor) and restore the
        executor's model names — planning on an expansion renames graphs
        (``[expanded]``), but the swap contract matches names exactly."""
        if self._translate and not self._escalated:
            ir = translate_ir(ir, self._fine)
        if tuple(ir.models) != tuple(models):
            ir = dataclasses.replace(ir, models=tuple(models))
        return ir

    def _drift_target_model(self, plan: PlanIR, drift: dict[str, float]) -> int:
        """The model to re-route in a partial re-plan: the one whose
        incumbent route carries the most base-cost on the most-drifted
        engine (executor-space accounting)."""
        names = [e.name for e in self.engines]
        worst = max(range(len(names)), key=lambda e: drift.get(names[e], 0.0))
        loads = []
        for mi in range(plan.n_models):
            loads.append(
                sum(
                    self._expected_base(mi, s.engine, s.lo, s.hi, getattr(s, "impl", "xla"))
                    for s in plan.route(mi)
                    if s.engine == worst
                )
            )
        return max(range(len(loads)), key=lambda mi: (loads[mi], -mi))

    def _propose(self, executor_plan: PlanIR, online: OnlineCost, drift: dict[str, float]):
        """Produce the candidate swap for one drift fire: (plan, exec-space
        IR, incumbent cycle under live costs, partial?)."""
        cfg = self.config
        incumbent = self._incumbent_routes(executor_plan)
        if incumbent is None:
            # the live routes are not expressible at coarse planning
            # granularity — fall forward to fine planning permanently
            self._escalated = True
            incumbent = self._incumbent_routes(executor_plan)
        full = self._plan(online)
        old_cycle = self._score_fixed(incumbent, online)
        choice, partial = full, False
        if cfg.partial_swaps and len(self.graphs) > 1:
            target = self._drift_target_model(executor_plan, drift)
            pinned = [r if mi != target else None for mi, r in enumerate(incumbent)]
            part = self._plan(online, fixed=pinned)
            if part.expected_cycle <= full.expected_cycle * (1.0 + cfg.partial_tolerance):
                choice, partial = part, True
        return choice, self._to_exec_ir(choice, executor_plan.models), old_cycle, partial

    def _snapshot_online(self) -> OnlineCost:
        snap = OnlineCost(self.online.base, alpha=self.online.alpha)
        snap._num = dict(self.online._num)
        snap._den = dict(self.online._den)
        return snap

    # -- the control loop ---------------------------------------------------

    def _load_signal(self, executor: StreamExecutor) -> dict[str, float] | None:
        """Evaluate the load-pressure trigger for this tick: sustained
        queue growth or SLO-miss rate above threshold (``load_threshold``
        / ``slo_miss_threshold``; both disabled at 0.0). Returns the
        pressure readings when the hysteresis fires, else None."""
        cfg = self.config
        if not cfg.load_threshold and not cfg.slo_miss_threshold:
            return None
        pressure = executor.queue_pressure()
        miss = float(self.slo_miss_fn()) if self.slo_miss_fn is not None else 0.0
        hot = (cfg.load_threshold and pressure >= cfg.load_threshold) or (
            cfg.slo_miss_threshold and miss >= cfg.slo_miss_threshold
        )
        if not hot:
            self._load_above = 0
            return None
        self._load_above += 1
        if self._load_above < cfg.load_hysteresis:
            return None
        return {"queue_pressure": pressure, "slo_miss_rate": miss}

    def _batch_signal(self, executor: StreamExecutor) -> dict[str, float] | None:
        """Evaluate the batch-shift trigger: the coalescer's observed
        admission bucket (EMA, quantized to the executor's bucket ladder)
        has moved away from the bucket the incumbent plan was scored at,
        for ``hysteresis`` consecutive ticks. An arrival-concurrency
        shift re-plans even when no per-engine scale has drifted — the
        routes were balanced for a different effective batch."""
        bc = getattr(executor, "batching", None)
        if bc is None or not bc.enabled:
            return None
        observed = bc.bucket_for(int(round(self._batch_ema)))
        if observed == self._planned_batch:
            self._batch_above = 0
            return None
        self._batch_above += 1
        if self._batch_above < self.config.hysteresis:
            return None
        return {"observed_batch": float(observed), "planned_batch": float(self._planned_batch)}

    def maybe_replan(self, executor: StreamExecutor) -> ReplanEvent | None:
        """Called at every frame boundary (executor ``on_tick``)."""
        cfg = self.config
        self._fold_tick()
        # harvest a finished background planning job first
        if self._job is not None:
            if self._job.is_alive():
                return None
            self._job = None
            if self._job_result:
                return self._finish(executor, *self._job_result.pop())
            return None
        if not self._baseline:
            self._try_calibrate()
        trigger, d = None, {}
        if self._baseline:
            d = self.drift()
            if d and max(d.values()) > cfg.drift_threshold:
                self._above += 1
            else:
                self._above = 0
            if self._above >= cfg.hysteresis:
                trigger = "drift"
        if trigger is None:
            load = self._load_signal(executor)
            if load is not None:
                trigger, d = "load", load
        if trigger is None:
            shift = self._batch_signal(executor)
            if shift is not None:
                trigger, d = "batch", shift
        if trigger is None:
            return None
        tick = executor.tick_count
        if self._last_swap_tick is not None and tick - self._last_swap_tick < cfg.cooldown_ticks:
            return None
        if trigger == "batch":
            # commit the new planning bucket only once the fire is going
            # through: incumbent and candidates are then both re-scored at
            # the same amortized costs, and planned == observed afterwards
            # quiesces the trigger whether or not the swap happens
            self._planned_batch = int(d["observed_batch"])
            self._batch_above = 0
        # this is a re-plan fire: bump the escalation counter before
        # planning, so the escalate_after-th fire already plans fine
        self._fires += 1
        if cfg.escalate_after and not self._escalated and self._fires >= cfg.escalate_after:
            self._escalated = True
        if cfg.background:
            online = self._snapshot_online()
            plan_snapshot = executor.plan
            drift_snapshot = dict(d)
            fire_trigger = trigger

            def job():
                plan, ir, old_cycle, partial = self._propose(plan_snapshot, online, drift_snapshot)
                # warm the candidate plan's segment runners here, in the
                # worker — first-use costs stay off the tick thread; the
                # warmup is harmless if the swap is later rejected (it
                # only seeds runner caches). Graph captures are left to
                # the serving thread (_finish, prepare_s None)
                prepare_s = None
                if not executor.captures_graphs:
                    t0 = time.perf_counter()
                    executor.prepare_plan(ir)
                    prepare_s = time.perf_counter() - t0
                self._job_result.append(
                    (plan, old_cycle, drift_snapshot, prepare_s, partial, ir, fire_trigger)
                )

            self._job = threading.Thread(target=job, daemon=True)
            self._job.start()
            return None
        online = self._snapshot_online()
        plan, ir, old_cycle, partial = self._propose(executor.plan, online, dict(d))
        return self._finish(executor, plan, old_cycle, dict(d), partial=partial, ir=ir, trigger=trigger)

    def _finish(
        self,
        executor: StreamExecutor,
        plan,
        old_cycle: float,
        drift,
        prepare_s: float | None = None,
        partial: bool = False,
        ir: PlanIR | None = None,
        trigger: str = "drift",
    ) -> ReplanEvent:
        cfg = self.config
        background = prepare_s is not None
        # accept a legacy scheduler plan (NModelPlan et al.) as well as PlanIR
        if not isinstance(plan, PlanIR):
            plan = plan.ir
        ir = ir if ir is not None else plan
        old_partitions = tuple(executor.plan.partitions)
        old_cuts = executor.plan.cuts
        improves = plan.expected_cycle < old_cycle * (1.0 - cfg.min_improvement)
        changes = (
            ir.route_specs() != executor.plan.route_specs()
            or ir.impl_bindings() != executor.plan.impl_bindings()
        )
        swapped = improves and changes
        if swapped:
            if not background:
                t0 = time.perf_counter()
                executor.prepare_plan(ir)
                prepare_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            executor.swap_plan(ir)
            self.swap_stalls.append(
                SwapStall(
                    tick=executor.tick_count,
                    prepare_s=prepare_s,
                    swap_s=time.perf_counter() - t0,
                    background=background,
                    partial=partial,
                )
            )
            self._last_swap_tick = executor.tick_count
            self._incumbent_max_cuts = executor.plan.max_cuts
            self._impl_mode = getattr(executor.plan, "impl_mode", "xla")
            self._planned_batch = max(int(getattr(executor.plan, "batch", 1)), 1)
            self._rebaseline()
        else:
            # plan already as good as it gets under the drifted costs: stop
            # re-firing on the same signal until it changes again
            self._rebaseline()
            self._last_swap_tick = executor.tick_count
        self._load_above = 0
        ev = ReplanEvent(
            tick=executor.tick_count,
            drift=drift,
            old_partitions=old_partitions,
            new_partitions=tuple(ir.partitions),
            old_cycle=old_cycle,
            new_cycle=plan.expected_cycle,
            swapped=swapped,
            revision=executor.plan.revision,
            old_cuts=old_cuts,
            new_cuts=ir.cuts,
            partial=partial,
            escalated=self._escalated,
            trigger=trigger,
        )
        self.events.append(ev)
        return ev

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "calibrated": self.calibrated,
            "observations": self.online.observations,
            "scales": self.online.snapshot(),
            "baseline": dict(self._baseline),
            "drift": self.drift(),
            "replans": len(self.events),
            "swaps": sum(e.swapped for e in self.events),
            "partial_swaps": sum(e.swapped and e.partial for e in self.events),
            "escalated": self._escalated,
            "drift_fires": self._fires,
            "load_fires": sum(e.trigger == "load" for e in self.events),
            "batch_fires": sum(e.trigger == "batch" for e in self.events),
            "planned_batch": self._planned_batch,
            "batch_ema": round(self._batch_ema, 3),
            "swap_stall": swap_stall_summary(self.swap_stalls),
            "events": [
                {
                    "tick": e.tick,
                    "drift": {k: round(v, 4) for k, v in e.drift.items()},
                    "old_partitions": list(e.old_partitions),
                    "new_partitions": list(e.new_partitions),
                    "old_cuts": [list(c) for c in e.old_cuts],
                    "new_cuts": [list(c) for c in e.new_cuts],
                    "old_cycle": e.old_cycle,
                    "new_cycle": e.new_cycle,
                    "swapped": e.swapped,
                    "partial": e.partial,
                    "escalated": e.escalated,
                    "revision": e.revision,
                    "trigger": e.trigger,
                }
                for e in self.events
            ],
        }
