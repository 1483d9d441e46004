"""Generic tick-based multi-stream executor with overlapped dispatch and
live plan hot-swap.

Generalizes the two-model HaX-CoNN swap pipeline: N staged models, each
with a planner-assigned route of ``PlanSegment``s (layer span + engine
binding), fed by K bounded per-stream frame queues. The executor consumes
*only* the typed ``core.plan_ir.PlanIR`` — scheduler results
(``NModelPlan``, ``HaxConnResult``) and legacy ``ModelRoute`` lists are
normalized to an IR at construction, and nothing downstream reaches into
scheduler internals. Plan spans are *layer* indices: on fine-granularity
(expanded-graph) models the ``StagedModel`` maps each span to its
sub-block stage executables (``op_spans``), so cuts inside composite
blocks stage and run exactly like coarse cuts — spans that don't land on
stage boundaries are rejected at staging time. One *tick* is one
steady-state cycle in two phases:

  * **issue** — every in-flight frame advances exactly one route segment
    (deepest stage first — the double-buffered counter-phase), then each
    model admits up to ``microbatch`` queued frames (round-robin over its
    streams) into stage 0. On a CUDA card each engine is one CUDA stream:
    a segment waits on the event its state's producer recorded, runs on its
    engine's stream and records its own event, and every state tensor it
    reads is ``record_stream``-ed on that stream so the caching allocator
    never hands its memory to another stream while the read is pending. In
    the default ``dispatch="overlapped"`` mode the segments are only
    *enqueued*: the host keeps issuing the other engine's segments while
    earlier ones compute, so counter-phased engines genuinely overlap.
    With ``jit_segments=True`` (the default) each (model, span, impl)
    segment on the card is additionally captured in a CUDA graph
    (``StagedModel.jitted_segment_fn``) and replayed — one launch per
    engine call instead of one per op. The replay runs the same kernels
    with the same launches as the eager op sequence, so its outputs are
    bit-identical to ``jit_segments=False`` (eager ``segment_fn``); on the
    CPU both run ``segment_fn``. As the JAX executor's jitted segments take
    their state donated, a captured flight's state lives in a *slot*
    (``Slot``): buffers its route's graphs were captured on, segment k's
    graph reading where segment k-1's wrote. Admission writes each frame
    once into its rows of the slot's stage-0 buffers, completion clones
    the finalized outputs once, and nothing copies the state between two
    segments. Each (model, route, stage-0 state structure) keeps as many
    slots as it can have flights in flight (``slot_bound``), all captured
    when the executor first sees it or in ``prepare_plan``, so no capture
    lands on a later tick.
  * **resolve** — frames whose route finished are completed: the host
    waits for their last segment's event (the only synchronization point
    of the tick), slices merged groups apart, and stamps latencies.

**Plan hot-swap** (the online re-planning runtime): ``swap_plan(new_ir)``
replaces the active plan at a frame boundary — between ticks, or at the
end of the tick that called it. Each flight snapshots its route at
admission, so in-flight frames finish on the plan they started under
while new admissions take the new routes: zero dropped frames, no
ordering change, and (routes being a pure re-orchestration of the same
op sequence) outputs equal to an unswapped run. ``prepare_plan(new_ir)``
pre-executes the new plan's segment executables on zero-filled states of
the shapes seen so far — the double-buffered staged-weights warmup that
keeps graph captures and the kernels' first-use costs off the hot path
before the swap.

**Per-segment observation**: with ``profile_every=k``, every k-th tick is
a *profiled* tick — each segment call is individually synchronized and
its wall time recorded as a ``SegmentObservation`` (and pushed to the
``on_segment`` callback). That is the live cost feedback the
``serve.replanner`` folds into its ``OnlineCost`` EMA; non-profiled ticks
keep full overlap. ``segment_delay_fn`` injects an extra per-segment cost
on its engine (perturbation harness for the recovery benchmark): stalls
accrue per engine and the tick pays the slowest engine's total once,
overlapped with the async compute — a slowed *parallel* engine looks
exactly like this — while profiled observations report the engine-virtual
wall (compute + stall) so the drift detector sees the slowdown.

``dispatch="serialized"`` instead synchronizes after *every* segment
call — the pre-overlap behaviour kept as the measurable baseline. Both
modes run the exact same op sequence per frame as ``StagedModel.run_all``
(and the kernels use no atomics), so their outputs are bit-identical.
Per-tick host wall/blocked time is recorded in ``tick_stats`` (see
``metrics.TickStats.overlap_efficiency``).

Micro-batching (``microbatch > 1``) admits up to that many same-model
frames per tick; with ``merge_batches`` the group is concatenated along
the leading axis and the route runs once for the merged state (only for
batch-independent models — see ``Pix2PixConfig(norm="instance")``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

import torch

from ..core import pipeline as _pipeline
from ..core.pipeline import StagedModel, TickLog
from ..core.plan_ir import PlanIR, PlanSegment, ir_from_routes
from ..core.scheduler import NModelPlan
from ..nn.module import tree_def, tree_leaves, tree_map
from .batching import BatchConfig
from .metrics import TickStats
from .streams import FrameQueue, StreamSpec


@dataclasses.dataclass
class FlightMember:
    stream_index: int
    frame_id: int
    size: int  # leading-axis extent of this frame in the (possibly merged) state
    t_submit: float
    tick_submit: int
    degrade: int = 0  # admission degrade level (0 none, 1 resolution, 2 route)


@dataclasses.dataclass
class Flight:
    model_index: int
    members: list[FlightMember]
    state: Any
    stage: int  # segments already executed
    route: tuple[PlanSegment, ...]  # snapshot of the plan at admission
    revision: int  # plan revision the flight was admitted under
    degrade: int = 0  # level 2 flights run the degraded (single-segment) route
    valid: int = 0  # real frames in the (possibly padded) state; 0 = all
    bucket: int = 0  # padded leading-axis extent (the compiled bucket); 0 = valid
    held: bool = False  # the coalescer delayed this flight waiting for co-riders
    t_issue: float = 0.0  # admission wall clock (feeds the service-time EMA)
    ready: Any = None  # CUDA event: the state is complete once it fires (None on CPU)
    slot: Any = None  # the Slot the state lives in (captured segments), else None


@dataclasses.dataclass
class Completion:
    stream: str
    frame_id: int
    output: Any
    tick_submit: int
    tick_done: int
    latency_s: float  # wall-clock submit -> completion
    degrade: int = 0  # admission degrade level the frame ran under
    batch: int = 1  # real frames in the flight this frame rode in (occupancy)
    held: bool = False  # the flight was held by the coalescer before running


@dataclasses.dataclass(frozen=True)
class SegmentObservation:
    """One profiled segment execution — the executor's live cost signal."""

    tick: int
    model_index: int
    stage: int
    engine: int
    lo: int
    hi: int
    wall_s: float  # dispatch + sync wall time of this segment call
    batch: int  # leading-axis frames in the flight (merged groups > 1)
    revision: int  # plan revision the segment ran under
    impl: str = "xla"  # implementation variant the segment ran with
    bucket: int = 0  # padded bucket the segment executed at (0 = batch)


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    tick: int
    revision: int
    partitions: tuple[int, ...]  # first cut per model (legacy view)
    expected_cycle: float
    cuts: tuple[tuple[int, ...], ...] = ()  # full k-cut vectors per model


@dataclasses.dataclass(eq=False)
class Slot:
    """The buffers one flight's state lives in while its route runs as
    captured graphs, and those graphs. ``state`` is the stage-0 buffer
    tree (zeros at first; admission writes each frame into its rows);
    ``graphs[k]`` is segment k's graph, captured on the leaves in its
    ``static_in``: segment k-1's outputs where the engine hand-off keeps
    the tensors (one card), else the tensors the first hand-off across
    devices made, which later ones are copied into. One flight at a time
    holds a slot; its graphs share one memory pool (``token``), as they
    never run at once."""

    key: tuple  # (model, route key, stage-0 state structure)
    token: int  # the graphs' memory pool (``core.pipeline._graph_pool``)
    state: Any
    graphs: list
    runners: list  # per stage: the CapturedSegment whose graph it is
    rows: int = 0  # leading-axis rows the last flight wrote into ``state``
    busy: bool = False


# slot tokens, unique across executors: two replicas' slots never share a
# graph pool (their graphs may run at once)
_SLOT_TOKENS = itertools.count(1)


def _route_key(route) -> tuple:
    """What a slot's graphs depend on in a route: each segment's span,
    implementation and engine."""
    return tuple((s.lo, s.hi, getattr(s, "impl", "xla"), s.engine) for s in route)


def _struct_key(state) -> tuple:
    leaves = tree_leaves(state)
    return tree_def(state), tuple((tuple(t.shape), t.dtype) for t in leaves)


@dataclasses.dataclass(frozen=True)
class TensorStruct:
    """Shape and dtype of one state tensor (a tree leaf, not a tuple node)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _leading(state) -> int:
    """Leading-axis extent of a state tree (the executed batch bucket)."""
    leaves = tree_leaves(state)
    if not leaves:
        return 1
    shape = leaves[0].shape
    return int(shape[0]) if shape else 1


def _spans(routes) -> set[tuple[int, int, int, str]]:
    """The (model, lo, hi, impl) spans of some routes."""
    return {(s.model_index, s.lo, s.hi, getattr(s, "impl", "xla")) for segs in routes for s in segs}


def _param_device(model: StagedModel) -> torch.device:
    """The device of the model's first parameter tensor (the CPU for a
    model without tensors, such as one whose ops take no params)."""
    leaves = [t for t in tree_leaves(model.params) if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _as_plan_ir(plan, engine_names=None) -> PlanIR:
    """Normalize every accepted plan form to the IR contract."""
    if isinstance(plan, PlanIR):
        return plan
    if isinstance(plan, NModelPlan):
        return plan.ir
    if hasattr(plan, "ir") and isinstance(getattr(plan, "ir"), PlanIR):
        return plan.ir  # HaxConnResult / Schedule
    return ir_from_routes(plan, engine_names=engine_names)


class StreamExecutor:
    """Drives N staged models over their planned routes for K streams."""

    def __init__(
        self,
        models: list[StagedModel],
        plan: PlanIR | NModelPlan | list,
        streams: list[StreamSpec],
        max_queue: int = 8,
        microbatch: int = 1,
        merge_batches: bool | list[bool] = False,
        place_fns: list[Callable] | None = None,
        engine_names: list[str] | None = None,
        model_labels: list[str] | None = None,
        dispatch: str = "overlapped",
        jit_segments: bool = True,
        profile_every: int = 0,
        on_segment: Callable[[SegmentObservation], None] | None = None,
        segment_delay_fn: Callable[[PlanSegment], float] | None = None,
        batching: BatchConfig | None = None,
    ):
        ir = _as_plan_ir(plan, engine_names)
        if len(models) != ir.n_models:
            raise ValueError(f"{len(models)} models but plan routes {ir.n_models}")
        ir.validate_against([m.n_layers for m in models])
        self._check_span_staging(ir, models)
        for s in streams:
            if not 0 <= s.model_index < len(models):
                raise ValueError(f"stream {s.name} references unknown model {s.model_index}")
        if microbatch < 1:
            raise ValueError("microbatch must be >= 1")
        if dispatch not in ("overlapped", "serialized"):
            raise ValueError(f"dispatch must be 'overlapped' or 'serialized', got {dispatch!r}")
        if profile_every < 0:
            raise ValueError("profile_every must be >= 0 (0 = no segment profiling)")
        self.models = models
        self.plan = ir
        self.streams = streams
        self.microbatch = microbatch
        self.dispatch = dispatch
        if isinstance(merge_batches, bool):
            self.merge_batches = [merge_batches] * len(models)
        else:
            if len(merge_batches) != len(models):
                raise ValueError(f"{len(merge_batches)} merge flags but {len(models)} models")
            self.merge_batches = list(merge_batches)
        n_engines = ir.n_engines
        self.place_fns = place_fns or [lambda x: x] * n_engines
        self.engine_names = list(engine_names) if engine_names else list(ir.engine_names)
        self.model_labels = model_labels or [m.name for m in models]
        self.queues = [FrameQueue(max_queue) for _ in streams]
        self.in_flight: list[Flight] = []
        self.completions: list[Completion] = []
        self.outputs: dict[str, list] = {s.name: [] for s in streams}
        self.log: list[TickLog] = []
        self.tick_stats: list[TickStats] = []
        self.tick_count = 0
        self._frame_ids = [0] * len(streams)
        self._rr = [0] * len(models)  # round-robin cursor per model
        self._streams_of = [
            [i for i, s in enumerate(streams) if s.model_index == m] for m in range(len(models))
        ]
        self._blocked_s = 0.0  # host time waiting on the card inside the current tick
        self._segments_issued = 0
        # live cost feedback + re-planning hooks
        self.profile_every = profile_every
        self.on_segment = on_segment
        self.on_tick: Callable[["StreamExecutor"], None] | None = None
        self.segment_delay_fn = segment_delay_fn
        self._tick_delay: dict[int, float] = {}  # engine -> accrued stall this tick
        self.segment_obs: list[SegmentObservation] = []
        self.swap_events: list[SwapEvent] = []
        self._profiling_tick = False
        # stage-0 state structs seen per model (for prepare_plan warmups)
        self._state_structs: dict[int, list] = {m: [] for m in range(len(models))}
        # one CUDA stream per engine when the models live on a card; on the
        # CPU every op completes before it returns and no stream is needed
        device = _param_device(models[0]) if models else torch.device("cpu")
        self._device = device
        self._engine_streams = (
            [torch.cuda.Stream(device) for _ in self.place_fns] if device.type == "cuda" else None
        )
        self.jit_segments = jit_segments
        # captured segments run on slots (``Slot``): keyed (model, route
        # key, stage-0 structure), each key's slots made and captured
        # together (``slot_bound``); routes prepared for a coming swap keep
        # theirs until the swap
        self._use_slots = self.captures_graphs
        self._slots: dict[tuple, list[Slot]] = {}
        self._slot_bounds: dict[tuple, int] = {}
        self._prepared_routes: set[tuple[int, tuple]] = set()
        self.slots_beyond_bound = 0  # slots made past their key's bound (each a capture on the hot path)
        # keyed by (model, lo, hi, impl, bucket): hot-swapped plans whose
        # spans (and implementation bindings) coincide with an old plan's
        # reuse the same (possibly compiled) runner; the bucket key gives
        # every batch size its own warmed executable so steady-state
        # batched serving never recompiles
        self._seg_fns: dict[tuple[int, int, int, str, int], Callable] = {}
        # (model, lo, hi, impl) spans a swap took out of the plan: their
        # runners (and CUDA graphs) are dropped once no flight uses them
        self._retired: set[tuple[int, int, int, str]] = set()
        # degraded single-segment routes, keyed (model, plan revision)
        self._degraded_routes: dict[tuple[int, int], tuple[PlanSegment, ...]] = {}
        # per-model stream admission order: strictly tier-first (round-robin
        # within a tier); identical to plain round-robin when no stream
        # carries an SLO, so closed-loop behaviour is unchanged
        self._tiers = [s.tier for s in streams]
        # continuous batching (coalescer) state
        self.batching = batching or BatchConfig()
        self._hold_since: dict[int, float] = {}  # model -> wall clock hold start
        self._held_pending: set[int] = set()  # models with a hold in progress
        # observed admission->completion service time EMA per (model, bucket):
        # the self-calibrating "expected batched segment time" the hold
        # decision compares slack against
        self._svc_ema: dict[tuple[int, int], float] = {}
        # per-engine host-time breakdown for the current tick (satellite
        # diagnostic): engine index -> [issue_s, transfer_s, resolve_s]
        self._wait_acc: dict[int, list[float]] = {}

    # -- submission ---------------------------------------------------------

    def submit(self, stream: int | str, frame: Any, degrade: int = 0) -> bool:
        """Queue a frame on a stream; False = queue full (backpressure).

        ``degrade`` is the admission controller's degrade level: level-1
        frames were resolution-shed upstream (they only opt out of merge
        batching — their shapes differ), level-2 frames run the degraded
        single-segment route instead of the plan's."""
        si = stream if isinstance(stream, int) else self._stream_index(stream)
        fid = self._frame_ids[si]
        if not self.queues[si].push((fid, frame, time.perf_counter(), degrade)):
            return False
        self._frame_ids[si] += 1
        return True

    def _stream_index(self, name: str) -> int:
        for i, s in enumerate(self.streams):
            if s.name == name:
                return i
        raise KeyError(f"unknown stream {name!r}")

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues) + sum(len(f.members) for f in self.in_flight)

    def queue_pressure(self, model_index: int | None = None) -> float:
        """Aggregate queue fill fraction in [0, 1] — the admission
        controller's and re-planner's load signal. Restricted to one
        model's streams when ``model_index`` is given."""
        qs = [
            q
            for si, q in enumerate(self.queues)
            if model_index is None or self.streams[si].model_index == model_index
        ]
        cap = sum(q.maxdepth for q in qs)
        return sum(len(q) for q in qs) / cap if cap else 0.0

    # -- plan hot-swap ------------------------------------------------------

    @property
    def plan_revision(self) -> int:
        return self.plan.revision

    @staticmethod
    def _check_span_staging(ir: PlanIR, models):
        """Reject plans whose spans can't stage before any frame runs:
        on fine-granularity models every route segment — however many
        cuts the plan takes — must start and end on stage-callable
        boundaries (``StagedModel.check_route``)."""
        for mi, segs in enumerate(ir.segments):
            models[mi].check_route([(s.lo, s.hi) for s in segs])

    def swap_plan(self, new_ir: PlanIR) -> int:
        """Install a new plan at the next frame boundary (new admissions).

        In-flight frames keep their admission-time route snapshots, so the
        swap drops nothing and changes no frame's op sequence — only where
        future segments run. The old plan's spans that the new one does not
        run keep their runners until the last flight on them completes;
        then ``tick`` drops the runners and their captured graphs
        (``StagedModel.drop_graphs``), and the old routes' slots with
        theirs, so a server that re-plans for good holds the graphs of its
        live routes only. Returns the new plan revision.
        """
        if tuple(new_ir.models) != tuple(self.plan.models):
            raise ValueError(
                f"swap changes the model set {self.plan.models} -> {new_ir.models}"
            )
        if new_ir.n_engines > len(self.place_fns):
            raise ValueError(
                f"swap needs {new_ir.n_engines} engines but executor has {len(self.place_fns)}"
            )
        new_ir.validate_against([m.n_layers for m in self.models])
        self._check_span_staging(new_ir, self.models)
        rev = self.plan.revision + 1
        self._retired |= _spans(self.plan.segments)
        self._prepared_routes.clear()
        self.plan = new_ir.with_revision(rev)
        self.swap_events.append(
            SwapEvent(
                tick=self.tick_count,
                revision=rev,
                partitions=tuple(new_ir.partitions),
                expected_cycle=new_ir.expected_cycle,
                cuts=new_ir.cuts,
            )
        )
        self.log.append(TickLog(self.tick_count, "*", f"swap->rev{rev} cuts={list(new_ir.cuts)}"))
        return rev

    def prepare_plan(self, new_ir: PlanIR) -> int:
        """Warm the new plan's segment executables off the hot path.

        For every stage-0 state shape seen so far, threads zeros of that
        shape through the new routes (on the models' device), running each
        segment once on its engine's stream — seeding the runner cache, the
        runners' CUDA graphs (captured here, on the calling thread, for the
        stream that will replay them) and the kernels' first-use costs (the
        old plan's runners stay valid for in-flight frames). With captured
        segments it makes and captures the new routes' slots instead, as
        many per state shape as can be in flight (``_prepare_slots``), each
        run once on zeros. Returns the number of (state shape, segment)
        pairs warmed; silently skips models that have not seen a frame
        yet.
        """
        new_ir.validate_against([m.n_layers for m in self.models])
        self._check_span_staging(new_ir, self.models)
        if self._use_slots:
            return self._prepare_slots(new_ir)
        warmed = 0
        for mi, segs in enumerate(new_ir.segments):
            model = self.models[mi]
            device = _param_device(model)
            for _, struct in self._state_structs[mi]:
                for bstruct in self._warm_structs(mi, struct):
                    bucket = _leading(bstruct)
                    state = tree_map(
                        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), bstruct
                    )
                    for seg in segs:
                        impl = getattr(seg, "impl", "xla")
                        key = (mi, seg.lo, seg.hi, impl, bucket)
                        if key not in self._seg_fns:
                            self._seg_fns[key] = self._make_runner(mi, seg.lo, seg.hi, impl)
                        if device.type == "cuda":
                            # one segment at a time, each on its engine's
                            # stream: the state changes streams only here,
                            # with the card idle
                            torch.cuda.synchronize(device)
                        with torch.cuda.stream(self._stream_of(seg.engine)):
                            state = self._seg_fns[key](model.params, state)
                        warmed += 1
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
        return warmed

    def _prepare_slots(self, new_ir: PlanIR) -> int:
        """``prepare_plan`` for captured segments: every slot the new routes
        can hold in flight, for each stage-0 struct seen so far and each
        bucket variant, made and captured (``_slots_of``). Returns the
        (struct, segment) pairs warmed."""
        warmed = 0
        for mi, segs in enumerate(new_ir.segments):
            route = tuple(segs)
            self._prepared_routes.add((mi, _route_key(route)))
            for _, struct in self._state_structs[mi]:
                for bstruct in self._warm_structs(mi, struct):
                    merged = bstruct is not struct or _leading(struct) > 1
                    self._slots_of(mi, route, bstruct, merged)
                    warmed += len(route)
        return warmed

    def slot_bound(self, mi: int, route, merged: bool) -> int:
        """How many flights of one (model, route, stage-0 structure) can be
        in flight at once: a flight runs one segment a tick and gives its
        slot back in the tick of its last, after that tick's admissions,
        so the route's length times the flights admitted a tick — one
        merged flight, else one a stream up to ``microbatch`` (the
        coalescer's ``max_batch`` for degraded frames)."""
        if merged:
            per_tick = 1
        elif self.batching.enabled and self.merge_batches[mi]:
            per_tick = self.batching.max_batch
        else:
            per_tick = min(self.microbatch, max(1, len(self._streams_of[mi])))
        return len(route) * per_tick

    def _slots_of(self, mi: int, route, struct, merged: bool) -> list[Slot]:
        """The slots of (model, route, stage-0 ``struct``): at the first
        call ``slot_bound`` of them, each captured through the route."""
        key = (mi, _route_key(route), _struct_key(struct))
        slots = self._slots.get(key)
        if slots is None:
            slots = self._slots[key] = []
            self._slot_bounds[key] = self.slot_bound(mi, route, merged)
            for _ in range(self._slot_bounds[key]):
                slots.append(self._new_slot(key, route, struct))
        return slots

    def _new_slot(self, key: tuple, route, struct) -> Slot:
        """A slot of zeros with its route's graphs captured on it and each
        replayed once (the graph's first launch, and the pool's first
        allocations, stay off the hot path), one segment at a time on its
        engine's stream with the card idle in between."""
        state = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self._device), struct)
        slot = Slot(key, next(_SLOT_TOKENS), state, [None] * len(route), [None] * len(route))
        bucket = _leading(state)
        for stage, seg in enumerate(route):
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            with torch.cuda.stream(self._stream_of(seg.engine)):
                state = self._slot_segment(slot, stage, seg, self.place_fns[seg.engine](state), bucket)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return slot

    def _slot_segment(self, slot: Slot, stage: int, seg: PlanSegment, state, bucket: int):
        """Replay segment ``stage`` of the slot's route on ``state`` (the
        previous segment's outputs after the engine hand-off), capturing it
        on those leaves at the first call. A hand-off that moved the state
        to other tensors (another device) is copied into the leaves the
        graph reads."""
        g = slot.graphs[stage]
        if g is None:
            mi = slot.key[0]
            runner = self._segment_runner(mi, seg, bucket)
            g = slot.graphs[stage] = runner.graph_for(self.models[mi].params, state, owner=slot.token)
            slot.runners[stage] = runner
        else:
            for buf, t in zip(g.static_in, tree_leaves(state)):
                if buf is not t:
                    buf.copy_(t)
        return slot.runners[stage].replay(g)

    def _take_slot(self, mi: int, route, states: list, bucket: int, merged: bool) -> Slot:
        """A free slot for a flight of ``states`` (one per member, in row
        order) padded to ``bucket`` rows, with each member's leaves written
        into its rows of the stage-0 buffers; rows a larger earlier flight
        left beyond the new ones are zeroed (pad rows stay zero)."""
        struct = tree_map(lambda a: TensorStruct((bucket,) + tuple(a.shape[1:]), a.dtype), states[0])
        slots = self._slots_of(mi, route, struct, merged)
        slot = next((s for s in slots if not s.busy), None)
        if slot is None:
            self.slots_beyond_bound += 1
            slot = self._new_slot(slots[0].key, route, struct)
            slots.append(slot)
        slot.busy = True
        bufs = tree_leaves(slot.state)
        off = 0
        for st in states:
            leaves = tree_leaves(st)
            n = _leading(st)
            for buf, t in zip(bufs, leaves):
                (buf if n == bucket else buf[off : off + n]).copy_(t)
            off += n
        if slot.rows > off:
            for buf in bufs:
                buf[off : slot.rows].zero_()
        slot.rows = off
        return slot

    def _drop_slots(self, live_routes: set) -> None:
        """Drop the slots of routes no plan, degraded route, prepared plan
        or flight runs, with their graphs (whose memory pools go with the
        last of them)."""
        for key in [k for k in self._slots if k[:2] not in live_routes]:
            del self._slot_bounds[key]
            for slot in self._slots.pop(key):
                for runner, g in zip(slot.runners, slot.graphs):
                    if g is not None:
                        runner.drop(g)

    def slot_counts(self) -> list[dict]:
        """Per slot key: the model, route, stage-0 shapes, slots held, how
        many are in flight and the bound."""
        return [
            {"model": key[0], "route": [list(r) for r in key[1]], "shapes": [list(s) for s, _ in key[2][1]],
             "slots": len(slots), "busy": sum(s.busy for s in slots), "bound": self._slot_bounds[key]}
            for key, slots in self._slots.items()
        ]

    def _warm_structs(self, mi: int, struct):
        """The state structs a plan warmup must compile for: the seen
        struct itself plus — for models the coalescer may batch — every
        bucket-scaled variant of its single-frame shapes, so a plan swap
        lands with all bucket executables warm and steady-state batched
        serving never compiles on the hot path."""
        out = [struct]
        bc = self.batching
        if bc.enabled and self.merge_batches[mi] and _leading(struct) == 1:
            for b in bc.buckets:
                if b == 1:
                    continue
                out.append(
                    tree_map(
                        lambda s, b=b: TensorStruct((b,) + tuple(s.shape[1:]), s.dtype), struct
                    )
                )
        return out

    # -- execution ----------------------------------------------------------

    def _block(self, flight: Flight, engine: int | None = None):
        """Wait until the flight's state is complete, with the wait charged
        to this tick's stats (and, when ``engine`` is given, to that
        engine's resolve-wait in the per-engine breakdown)."""
        t0 = time.perf_counter()
        if flight.ready is not None:
            flight.ready.synchronize()
        dt = time.perf_counter() - t0
        self._blocked_s += dt
        if engine is not None:
            self._charge_wait(engine, 2, dt)

    def _charge_wait(self, engine: int, slot: int, dt: float):
        """Accrue host time to one engine's (issue, transfer, resolve)
        breakdown for the current tick."""
        acc = self._wait_acc.get(engine)
        if acc is None:
            acc = self._wait_acc[engine] = [0.0, 0.0, 0.0]
        acc[slot] += dt

    @property
    def captures_graphs(self) -> bool:
        """Whether segments run as captured CUDA graphs (``jit_segments``
        with the models on a card)."""
        return self.jit_segments and _pipeline.captures_on(self._device)

    def _stream_of(self, engine: int):
        """The CUDA stream of an engine (None on the CPU)."""
        return self._engine_streams[engine] if self._engine_streams is not None else None

    def _make_runner(self, mi: int, lo: int, hi: int, impl: str = "xla") -> Callable:
        model = self.models[mi]
        if self.jit_segments:
            # cached on the model: executors over the same span share its
            # captured runner (one graph per state structure and stream),
            # each holding a reference to it until it retires the span
            return model.jitted_segment_fn(lo, hi, impl=impl, holder=self)
        return model.segment_fn(lo, hi, impl=impl)

    def _degraded_route(self, mi: int) -> tuple[PlanSegment, ...]:
        """The model's shed-staging route: the whole layer span as one
        coarse segment on the engine already carrying most of its planned
        work (fewest hand-offs, no inter-engine transfers — the minimum
        service-time fallback admission control escalates to). Always
        stage-legal: [0, n_layers) starts and ends on stage boundaries."""
        key = (mi, self.plan.revision)
        route = self._degraded_routes.get(key)
        if route is None:
            segs = self.plan.route(mi)
            load: dict[int, float] = {}
            for s in segs:
                load[s.engine] = load.get(s.engine, 0.0) + s.expected_cost
            eng = max(load, key=lambda e: (load[e], -e))
            route = (
                PlanSegment(
                    model_index=mi,
                    stage=0,
                    engine=eng,
                    lo=0,
                    hi=segs[-1].hi,
                    expected_cost=sum(s.expected_cost for s in segs),
                ),
            )
            self._degraded_routes[key] = route
        return route

    def _drop_retired(self):
        """Drop the runners (and CUDA graphs) of retired spans that neither
        the plan, a degraded route nor an in-flight flight still runs. A
        completed flight's last segment was waited on, and it waited on
        the flight's earlier ones, so no replay of a dropped graph is still
        on the card. Runners are shared with the other executors over the
        same models (fleet replicas): this one gives back its reference and
        the graphs captured on its own streams, and the runner leaves the
        model's cache when no executor runs the span any more."""
        live = _spans(self.plan.segments) | _spans(self._degraded_routes.values())
        live |= _spans(f.route for f in self.in_flight)
        if self._slots:
            routes = [(mi, r) for mi, r in enumerate(self.plan.segments)]
            routes += [(mi, r) for (mi, _), r in self._degraded_routes.items()]
            routes += [(f.model_index, f.route) for f in self.in_flight]
            self._drop_slots({(mi, _route_key(r)) for mi, r in routes} | self._prepared_routes)
        for mi, lo, hi, impl in self._retired - live:
            for key in [k for k in self._seg_fns if k[:4] == (mi, lo, hi, impl)]:
                del self._seg_fns[key]
            if self.jit_segments:
                streams = [st.cuda_stream for st in self._engine_streams or ()]
                self.models[mi].drop_graphs(lo, hi, impl, holder=self, streams=streams)
        self._retired &= live

    def _segment_runner(self, mi: int, seg: PlanSegment, bucket: int = 1) -> Callable:
        impl = getattr(seg, "impl", "xla")
        key = (mi, seg.lo, seg.hi, impl, bucket)
        fn = self._seg_fns.get(key)
        if fn is None:
            fn = self._make_runner(mi, seg.lo, seg.hi, impl)
            self._seg_fns[key] = fn
        return fn

    def _run_segment(self, flight: Flight):
        """Issue one route segment for a flight. In overlapped mode this
        only enqueues the computation on the engine's stream; serialized
        mode waits for it. Profiled ticks synchronize per segment to stamp
        a wall-time observation (the live cost feedback)."""
        seg = flight.route[flight.stage]
        eng = seg.engine
        t0 = time.perf_counter()
        stream = self._stream_of(eng)
        with torch.cuda.stream(stream):  # a no-op for None (CPU)
            # the hand-off: wait for the producing stream's event, and keep
            # the allocator from reusing the inputs' memory until this
            # stream's reads are done
            if stream is not None:
                stream.wait_event(flight.ready)
            state = self.place_fns[eng](flight.state)
            if stream is not None and flight.slot is None:
                # slot buffers live as long as their graphs; a fresh state
                # tensor does not
                for t in tree_leaves(state):
                    t.record_stream(stream)
            t1 = time.perf_counter()
            self._charge_wait(eng, 1, t1 - t0)
            bucket = flight.bucket or flight.valid or _leading(state)
            if flight.slot is not None:
                flight.state = self._slot_segment(flight.slot, flight.stage, seg, state, bucket)
            else:
                flight.state = self._segment_runner(flight.model_index, seg, bucket)(
                    self.models[flight.model_index].params, state
                )
            if stream is not None:
                flight.ready = torch.cuda.Event()
                flight.ready.record(stream)
        self._charge_wait(eng, 0, time.perf_counter() - t1)
        d = 0.0
        if self.segment_delay_fn is not None:
            d = self.segment_delay_fn(seg)
            if d > 0:
                # simulated engine slowdown: engines stall concurrently on
                # real hardware, so the stall accrues to this engine's
                # per-tick total (paid as max over engines at tick end)
                # instead of sleeping inline, which would serialize
                # stalls that genuinely overlap
                self._tick_delay[eng] = self._tick_delay.get(eng, 0.0) + d
        flight.stage += 1
        self._segments_issued += 1
        ids = ",".join(str(m.frame_id) for m in flight.members)
        self.log.append(
            TickLog(
                self.tick_count,
                self.engine_names[eng],
                f"{self.model_labels[flight.model_index]}[{seg.lo}:{seg.hi})#f{ids}",
            )
        )
        if self._profiling_tick:
            self._block(flight, engine=eng)
            obs = SegmentObservation(
                tick=self.tick_count,
                model_index=flight.model_index,
                stage=seg.stage,
                engine=eng,
                lo=seg.lo,
                hi=seg.hi,
                # the engine-virtual wall: what this span costs on its
                # (possibly slowed) engine
                wall_s=time.perf_counter() - t0 + d,
                batch=sum(m.size for m in flight.members),
                revision=flight.revision,
                impl=getattr(seg, "impl", "xla"),
                bucket=bucket,
            )
            self.segment_obs.append(obs)
            if self.on_segment is not None:
                self.on_segment(obs)
        elif self.dispatch == "serialized":
            self._block(flight, engine=eng)

    def _complete(self, flight: Flight):
        model = self.models[flight.model_index]
        last_eng = flight.route[-1].engine if flight.route else None
        self._block(flight, engine=last_eng)
        out = model.finalize(flight.state)
        if flight.slot is not None:
            # the frame's output outlives the slot's next flight: one clone,
            # on the caller's stream (the slot's next admission writes on
            # it too, so after this read)
            out = tree_map(torch.clone, out)
            flight.slot.busy = False
            flight.slot = None
        elif self._engine_streams is not None:
            # the caller reads the outputs on its own stream from here on
            caller = torch.cuda.current_stream(_param_device(model))
            for t in tree_leaves(out):
                t.record_stream(caller)
        now = time.perf_counter()
        valid = flight.valid or sum(m.size for m in flight.members)
        if flight.t_issue:
            # fold this flight's admission->completion wall into the
            # per-(model, bucket) service EMA the coalescer's hold
            # decision consults
            key = (flight.model_index, flight.bucket or valid)
            svc = now - flight.t_issue
            prev = self._svc_ema.get(key)
            self._svc_ema[key] = svc if prev is None else 0.7 * prev + 0.3 * svc
        if len(flight.members) == 1 and not (flight.bucket and flight.bucket > valid):
            sliced = [out]
        else:
            # padded lanes (bucket > valid) fall off here: member slices
            # only ever index [0, valid), so the zero-filled pad rows are
            # never observable in any completion — bit-exactness vs
            # per-frame execution is a slicing invariant, not a masking op
            off, sliced = 0, []
            for m in flight.members:
                o = off
                sliced.append(tree_map(lambda a, o=o, n=m.size: a[o : o + n], out))
                off += m.size
        for m, o in zip(flight.members, sliced):
            name = self.streams[m.stream_index].name
            self.outputs[name].append(o)
            self.completions.append(
                Completion(
                    stream=name,
                    frame_id=m.frame_id,
                    output=o,
                    tick_submit=m.tick_submit,
                    tick_done=self.tick_count,
                    latency_s=now - m.t_submit,
                    degrade=m.degrade,
                    batch=valid,
                    held=flight.held,
                )
            )

    def _note_state_struct(self, mi: int, state):
        struct = tree_map(lambda x: TensorStruct(tuple(x.shape), x.dtype), state)
        key = (tree_def(struct), tuple((s.shape, s.dtype) for s in tree_leaves(struct)))
        known = self._state_structs[mi]
        if key not in [k for k, _ in known]:
            known.append((key, struct))

    def expected_service(self, mi: int, bucket: int) -> float:
        """Observed admission->completion wall EMA for (model, bucket) —
        the coalescer's self-calibrating estimate of what riding a batch
        of that size costs. Falls back to the largest smaller bucket seen
        (batched service is monotone-ish in bucket), 0.0 before any
        observation (hold decisions then bound only by the hold window)."""
        t = self._svc_ema.get((mi, bucket))
        if t is not None:
            return t
        seen = [b for (m, b), _ in self._svc_ema.items() if m == mi and b < bucket]
        return self._svc_ema[(mi, max(seen))] if seen else 0.0

    def _should_hold(self, mi: int, cands: list[tuple[int, tuple]], now: float) -> bool:
        """The slack-driven hold decision for a partial bucket: wait for
        co-riders only when *every* waiting member's SLO slack clears the
        expected batched service time (scaled by ``min_slack_factor``)
        plus the full hold window — so a hold can never turn a meetable
        deadline into a miss — and the hold window has not expired. Any
        degraded candidate or an empty window admits immediately (under
        queue pressure the caller has already filled the bucket, so high
        load never holds and batching never costs goodput)."""
        bc = self.batching
        if bc.hold_s <= 0.0:
            return False
        started = self._hold_since.get(mi)
        if started is not None and now - started >= bc.hold_s:
            return False  # window expired: admit what we have
        if any(item[3] > 0 for _, item in cands):
            return False  # degraded frames never wait on a merge they can't join
        total = sum(
            int(item[1].shape[0]) if hasattr(item[1], "shape") and item[1].shape else 1
            for _, item in cands
        )
        t_b = self.expected_service(mi, bc.bucket_for(total))
        floor = bc.min_slack_factor * t_b + bc.hold_s
        for si, item in cands:
            slo = self.streams[si].slo
            if slo is None:
                continue
            slack = slo.deadline_s - (now - item[2])
            if slack <= floor:
                return False
        return True

    def _admit(self, mi: int) -> list[Flight]:
        """Admit queued frames for model ``mi`` into stage 0 of the
        *current* plan; returns the flights that already finished their
        route (single-segment models). Streams are drained strictly
        tier-first (SLO priority); within a tier the oldest waiting head
        goes first (age tiebreak — a stream can no longer lose the
        microbatch cut forever to rotation phasing), falling back to
        round-robin order on equal ages. With no SLOs attached every tier
        is 0 and fresh frames tie, so closed-loop behaviour is unchanged.

        With an enabled ``BatchConfig`` and a batch-independent model
        (``merge_batches``), admission becomes the cross-stream
        coalescer: up to ``max_batch`` clean frames from any of the
        model's streams merge into one flight, padded to the power-of-two
        bucket; a partial bucket may *hold* (frames stay queued) while
        every member's slack allows it — see ``_should_hold``."""
        model = self.models[mi]
        stream_idxs = self._streams_of[mi]
        if not stream_idxs:
            return []
        bc = self.batching
        coalesce = bc.enabled and self.merge_batches[mi]
        cap = bc.max_batch if coalesce else self.microbatch
        n = len(stream_idxs)
        start = self._rr[mi]
        rotated = [stream_idxs[(start + k) % n] for k in range(n)]
        now = time.perf_counter()

        def head_age(si: int) -> float:
            q = self.queues[si]
            return now - q.peek()[2] if len(q) else -1.0

        # stable: (tier, oldest-head-first), rr order breaking exact ties
        rotated.sort(key=lambda si: (self._tiers[si], -head_age(si)))
        # candidate collection peeks without popping: a held bucket's
        # frames must stay queued (and keep aging) until admission.
        # Coalescing drains multiple frames per stream (greedy bucket
        # fill under queue pressure); classic admission keeps the one-
        # frame-per-stream round-robin cut.
        cands: list[tuple[int, tuple]] = []
        if coalesce:
            pos = {si: 0 for si in rotated}
            progress = True
            while len(cands) < cap and progress:
                progress = False
                for si in rotated:
                    if len(cands) >= cap:
                        break
                    if pos[si] < len(self.queues[si]):
                        cands.append((si, self.queues[si].peek(pos[si])))
                        pos[si] += 1
                        progress = True
        else:
            for si in rotated:
                if len(cands) >= cap:
                    break
                if len(self.queues[si]):
                    cands.append((si, self.queues[si].peek()))
        if not cands:
            return []
        held = mi in self._held_pending
        if coalesce and len(cands) < cap and self._should_hold(mi, cands, now):
            if mi not in self._hold_since:
                self._hold_since[mi] = now
            self._held_pending.add(mi)
            return []
        self._hold_since.pop(mi, None)
        self._held_pending.discard(mi)
        picked: list[tuple[int, int, Any, float, int]] = []
        for si, _ in cands:
            fid, frame, t_sub, degrade = self.queues[si].pop()
            picked.append((si, fid, frame, t_sub, degrade))
        self._rr[mi] = (start + len(picked)) % n
        members, states = [], []
        for si, fid, frame, t_sub, degrade in picked:
            size = int(frame.shape[0]) if hasattr(frame, "shape") and frame.shape else 1
            members.append(FlightMember(si, fid, size, t_sub, self.tick_count, degrade=degrade))
            states.append(model.init_state(frame))
        route = self.plan.route(mi)
        rev = self.plan.revision
        # Degraded frames never merge: level-1 frames have shed shapes,
        # level-2 frames run the degraded route, both incompatible with a
        # concatenated full-route group.
        clean = [(m, s) for m, s in zip(members, states) if m.degrade == 0]
        shed = [(m, s) for m, s in zip(members, states) if m.degrade > 0]
        def slot_for(route_, sts, bucket_, merged_):
            return self._take_slot(mi, route_, sts, bucket_, merged_) if self._use_slots else None

        if self.merge_batches[mi] and len(clean) > 1:
            total = sum(m.size for m, _ in clean)
            bucket = bc.bucket_for(total) if coalesce else total
            slot = slot_for(route, [s for _, s in clean], bucket, True)
            if slot is not None:
                # each frame written once into its rows: no cat, no pad
                merged = slot.state
            else:
                merged = tree_map(lambda *xs: torch.cat(xs, dim=0), *(s for _, s in clean))
            if slot is None and bucket > total:
                # pad to the compiled bucket with zero lanes; _complete
                # slices members out of [0, total) so the pads are never
                # observable (bit-exact vs per-frame execution)
                merged = tree_map(
                    lambda a: torch.cat(
                        [
                            a,
                            torch.zeros(
                                (bucket - total,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device
                            ),
                        ],
                        dim=0,
                    ),
                    merged,
                )
            flights = [
                Flight(
                    model_index=mi,
                    members=[m for m, _ in clean],
                    state=merged,
                    stage=0,
                    route=route,
                    revision=rev,
                    valid=total,
                    bucket=bucket,
                    held=held,
                    slot=slot,
                )
            ]
        else:
            flights = []
            for m, s in clean:
                slot = slot_for(route, [s], m.size, False)
                flights.append(
                    Flight(
                        model_index=mi,
                        members=[m],
                        state=s if slot is None else slot.state,
                        stage=0,
                        route=route,
                        revision=rev,
                        valid=m.size,
                        bucket=m.size,
                        held=held and m.degrade == 0,
                        slot=slot,
                    )
                )
        for m, s in shed:
            shed_route = self._degraded_route(mi) if m.degrade >= 2 else route
            slot = slot_for(shed_route, [s], m.size, False)
            flights.append(
                Flight(
                    model_index=mi,
                    members=[m],
                    state=s if slot is None else slot.state,
                    stage=0,
                    route=shed_route,
                    revision=rev,
                    degrade=m.degrade,
                    valid=m.size,
                    bucket=m.size,
                    slot=slot,
                )
            )
        for flight in flights:
            self._note_state_struct(mi, flight.state)
            if self._engine_streams is not None:
                # the frames (and merge/pad tensors, or the writes into the
                # slot) were made on the caller's stream
                flight.ready = torch.cuda.Event()
                flight.ready.record(torch.cuda.current_stream(_param_device(model)))
            flight.t_issue = time.perf_counter()
        done = []
        for flight in flights:
            self._run_segment(flight)
            if flight.stage == len(flight.route):
                done.append(flight)
            else:
                self.in_flight.append(flight)
        return done

    def tick(self):
        """One steady-state cycle. Issue phase: advance every in-flight
        frame one segment (deepest first), then admit new frames into
        stage 0 — all dispatched without waiting in overlapped mode.
        Resolve phase: block on (only) the frames whose route finished."""
        t_start = time.perf_counter()
        self._blocked_s = 0.0
        self._segments_issued = 0
        self._wait_acc = {}
        self._profiling_tick = self.profile_every > 0 and self.tick_count % self.profile_every == 0
        if self._profiling_tick and self.in_flight:
            # drain the async dispatch queue before timing anything: without
            # this barrier the first profiled segment absorbs the previous
            # tick's in-flight work and its wall time is attributed to the
            # wrong (model, engine, span) — poisoning the cost calibration
            for f in self.in_flight:
                last = f.route[min(f.stage, len(f.route) - 1)].engine if f.route else None
                self._block(f, engine=last)
        done: list[Flight] = []
        # deepest stage first; route lengths may differ across plan
        # revisions, so the depth bound comes from the live flights
        max_stages = max((len(f.route) for f in self.in_flight), default=1)
        for stage in range(max_stages - 1, 0, -1):
            for mi in range(len(self.models)):
                for flight in [
                    f for f in self.in_flight if f.model_index == mi and f.stage == stage
                ]:
                    self._run_segment(flight)
                    if flight.stage == len(flight.route):
                        done.append(flight)
                        self.in_flight.remove(flight)
        for mi in range(len(self.models)):
            done.extend(self._admit(mi))
        if self._tick_delay:
            # pay the slowest engine's accrued stall once per tick, before
            # resolving: concurrent engines' stalls overlap each other and
            # the still-async dispatched compute
            time.sleep(max(self._tick_delay.values()))
            self._tick_delay.clear()
        for flight in done:
            self._complete(flight)
        if self._retired:
            self._drop_retired()
        self.tick_stats.append(
            TickStats(
                tick=self.tick_count,
                wall_s=time.perf_counter() - t_start,
                blocked_s=self._blocked_s,
                segments=self._segments_issued,
                engine_wait={
                    self.engine_names[e]: tuple(acc) for e, acc in self._wait_acc.items()
                }
                or None,
            )
        )
        self.tick_count += 1
        if self.on_tick is not None:
            # frame boundary: the replanner's chance to observe drift and
            # hot-swap before the next admission
            self.on_tick(self)

    def run_until_drained(self, max_ticks: int = 100000):
        while self.pending:
            if self.tick_count >= max_ticks:
                raise RuntimeError(f"executor did not drain within {max_ticks} ticks")
            self.tick()
        return self.outputs

    def overlap_efficiency(self) -> float:
        """Aggregate fraction of tick time the host was not blocked."""
        from .metrics import overlap_summary

        return overlap_summary(self.tick_stats)["overlap_efficiency"]
