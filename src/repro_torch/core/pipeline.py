"""Staged models: per-layer executable ops aligned with a ``LayerGraph``.

A ``StagedModel`` wraps the ops of one model so that any planned layer
span ``[lo, hi)`` runs as one segment; ``serve.StreamExecutor`` drives the
segments of a ``PlanIR`` over the engines. ``pix2pix_staged`` and
``yolo_staged`` build the serving pair at coarse or fine granularity, each
with its ``pallas_fused`` variant (the fused CUDA serving kernels).

``StagedModel.jitted_segment_fn`` is the counterpart of the JAX package's
jitted segments, whose state is donated: a ``CapturedSegment`` runner that
captures the segment in a CUDA graph once per set of state buffers, on
those buffers, and replays it (one launch of the whole segment instead of
one per op, and no copy of the state in or out).

``TwoModelPipeline`` executes a HaX-CoNN swap schedule in steady state with
double buffering (the paper's DeepStream analogue):

  tick t:  E_con runs A[0:pa) of frame t      E_flex runs B[0:pb) of frame t
           E_con runs B[pb:)  of frame t-1    E_flex runs A[pa:)  of frame t-1

On one card the two engines are two CUDA streams; ``place_fn`` hooks the
engine-boundary transfers (``.to(device, non_blocking=True)`` across
devices, ``submesh_placers``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch

from ..kernels import graph_launches, launch_counters
from ..nn.module import tree_def, tree_leaves, tree_map, tree_unflatten
from .graph import LayerGraph

# CUDA-graph memory pools by (device, CUDA stream) or by owner (a served
# flight's slot, ``serve.executor``; a captured train step's key,
# ``train.steps``), each with the graphs captured into it, and the side
# stream each device captures on. Graphs that share a pool
# may reuse each other's intermediate memory, which is safe only while they
# never run at once and none of them keeps an output past another's replay:
# a stream's graphs are ordered by that stream and their outputs are read
# before the next replay (the decode step's logits are cloned); a slot's
# graphs run one after another, for one flight at a time, and their outputs
# are the slot's own buffers.
_POOLS: dict[tuple, tuple[Any, "weakref.WeakSet[CapturedGraph]"]] = {}
_CAPTURE_STREAMS: dict[int, Any] = {}


def captures_on(device: torch.device) -> bool:
    """Whether segments run on ``device`` as captured CUDA graphs: on the
    card. On the CPU they run ``segment_fn`` (the caller asked for the
    CPU)."""
    return device.type == "cuda"


def _graph_pool(stream, owner=None) -> tuple[Any, "weakref.WeakSet[CapturedGraph]"]:
    """The pool handle and the set of live graphs captured into it: the
    stream's pool, or with ``owner`` (a hashable token) the owner's own,
    whatever stream its graphs replay on. Once every graph of a pool is
    gone the caching allocator releases the pool and refuses a capture into
    it, so the key starts a new one (a server that dropped all of a
    stream's graphs after a re-plan captures again)."""
    key = (stream.device.index, stream.cuda_stream) if owner is None else ("owner", owner)
    entry = _POOLS.get(key)
    if entry is None or not entry[1]:
        for k in [k for k, (_, graphs) in _POOLS.items() if not graphs]:
            del _POOLS[k]
        entry = _POOLS[key] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    return entry


def _capture_stream(device: torch.device):
    """The device's side stream for captures (None off the card)."""
    if device.type != "cuda":
        return None
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


def _current_stream(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def capture_graph(stream, side, run: Callable, what: str, owner=None, generators=()):
    """``run()`` captured into a ``torch.cuda.CUDAGraph`` on the side
    stream ``side``, into ``stream``'s pool or ``owner``'s (``_graph_pool``):
    returns the graph, ``run``'s outputs and the pool's set of graphs, to
    which the caller adds its ``CapturedGraph``. ``generators``: the CUDA
    ``torch.Generator``s ``run`` draws from, registered with the graph, so
    each replay draws from a generator's state at that time and advances it
    as the eager ops would (the capture leaves it as it was). A capture
    that fails raises, naming ``what``. capture_begin/end rather than
    torch.cuda.graph, whose entry also empties the allocator's cache: every
    later allocation would pay a cudaMalloc again, on the hot path when a
    capture happens there."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    pool, pool_graphs = _graph_pool(stream, owner)
    torch.cuda.synchronize(stream.device)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = run()
            finally:
                graph.capture_end()
    except Exception as e:
        raise RuntimeError(
            f"CUDA-graph capture of {what} failed (a host sync such as .item() or .cpu(), or a branch on a tensor "
            f"value, inside it?): {e}"
        ) from e
    stream.wait_stream(side)
    return graph, out, pool_graphs


@dataclasses.dataclass(eq=False)  # identity: a pool tracks its graphs in a WeakSet
class CapturedGraph:
    """One segment captured for one state structure, params and stream."""

    graph: Any  # torch.cuda.CUDAGraph
    params: Any  # held so the id in the cache key stays this object's
    static_in: list  # the graph's input buffers, one per state leaf
    static_out: Any  # the graph's output tree (overwritten by every replay)
    alias: list  # per output leaf: the input leaf it passes through, or None
    launches: dict  # kernel launches the capture recorded, by kernel
    replays: int = 0


class CapturedSegment:
    """CUDA-graph runner of one segment: ``(params, state) -> state`` like
    ``segment_fn``, on a state of CUDA tensors, with the state donated as
    the JAX executor's jitted segments take it (``donate_argnums=(1,)``).

    A graph is captured once per key: the params' identity, the current
    stream, the state's tree and each state leaf's shape, dtype, strides
    and address. It is captured directly on the leaves it is given (after
    one eager run of the segment on them, on a side stream, so the
    kernels' build, load and shared-memory attributes stay out of the
    graph; the segment is pure and writes none of its inputs), into the
    pool of ``owner`` where one is given (a served flight's slot) and a
    pool of its own otherwise. A call replays the graph and returns its
    output tree as it is: the leaves the graph writes (the same tensors at
    every replay) and the input leaves it passes through. So nothing is
    copied in or out: a caller that runs the next segment on that output
    replays the next segment's graph on these buffers, as
    ``serve.executor`` chains a flight's segments through its slot, and a
    caller that keeps an output past the next replay clones it.

    A capture that fails (a host sync such as ``.item()`` or ``.cpu()``, or
    a branch on a tensor value, inside the segment) raises, naming the
    segment; nothing falls back to eager. On a CPU state the segment runs
    as ``segment_fn``: the caller asked for the CPU. Each replay adds the
    launches its capture recorded to ``kernels.graph_launches``; the
    capture itself launches nothing and leaves the wrappers' counters as
    they were.
    """

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.graphs: dict[tuple, CapturedGraph] = {}
        # the executors that run this span (``StagedModel.jitted_segment_fn``
        # with a holder): the runner leaves the model's cache only when the
        # last of them retires the span
        self.holders = weakref.WeakSet()

    def __call__(self, params, state):
        leaves = tree_leaves(state)
        if not leaves or not captures_on(leaves[0].device):
            return self.fn(params, state)
        return self.replay(self.graph_for(params, state))

    def graph_for(self, params, state, owner=None) -> CapturedGraph:
        """The graph of ``state``'s buffers, captured on them at the first
        call (into ``owner``'s pool, or a pool of its own)."""
        leaves = tree_leaves(state)
        stream = _current_stream(leaves[0].device)
        key = (
            id(params),
            None if stream is None else stream.cuda_stream,
            tree_def(state),
            tuple((tuple(t.shape), t.dtype, t.stride(), t.device, t.data_ptr()) for t in leaves),
        )
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(params, state, leaves, stream, owner)
        return g

    def replay(self, g: CapturedGraph):
        """Replay ``g`` on the current stream; returns its output tree."""
        g.graph.replay()
        g.replays += 1
        graph_launches.update(g.launches)
        return g.static_out

    def drop(self, g: CapturedGraph) -> None:
        """Forget ``g`` (its memory returns to its pool once nothing holds it)."""
        for k in [k for k, v in self.graphs.items() if v is g]:
            del self.graphs[k]

    def _capture(self, params, state, leaves, stream, owner) -> CapturedGraph:
        side = _capture_stream(leaves[0].device)
        if side is not None:
            side.wait_stream(stream)
        static_state = tree_unflatten(state, leaves)  # fresh containers, the caller's leaves
        with torch.cuda.stream(side):
            self.fn(params, static_state)  # warm-up: first-use work stays out of the graph
        counters = launch_counters()
        before = {pkg: dict(c) for pkg, c in counters.items()}
        try:
            graph, static_out, pool_graphs = capture_graph(stream, side, lambda: self.fn(params, static_state),
                                                           f"segment {self.name}",
                                                           owner if owner is not None else object())
        finally:
            launched = {}
            for pkg, c in counters.items():
                for k, v in c.items():
                    if v != before[pkg][k]:
                        launched[k] = v - before[pkg][k]
                c.update(before[pkg])
        ids = {id(t): i for i, t in enumerate(leaves)}
        alias = [ids.get(id(o)) for o in tree_leaves(static_out)]
        captured = CapturedGraph(graph, params, list(leaves), static_out, alias, launched)
        pool_graphs.add(captured)
        return captured


@dataclasses.dataclass
class StagedModel:
    name: str
    ops: list[tuple[str, Callable]]  # (name, fn(params, state) -> state)
    params: Any
    graph: LayerGraph
    init_state: Callable[[Any], dict]
    finalize: Callable[[dict], Any]
    # per-frame outputs independent of batch companions (instance/group
    # norm) — the precondition for merge_batches micro-batching
    batch_independent: bool = False
    # layer span [lo, hi) each op covers when the graph is finer than the
    # op list (expanded graphs: one op per *stage callable*, several
    # primitive layers per op). None = ops align 1:1 with graph layers.
    op_spans: list[tuple[int, int]] | None = None
    # named implementation variants: impl -> same-length op list (e.g.
    # "pallas_fused" with each fused block collapsed onto its lead op), and
    # the op-index groups [a, b) that must be substituted atomically — a
    # group only switches impl when a segment contains it entirely, so cut
    # points interior to a fused block keep the reference ops
    variant_ops: dict[str, list[tuple[str, Callable]]] | None = None
    variant_groups: list[tuple[int, int]] | None = None

    def __post_init__(self):
        for impl, vops in (self.variant_ops or {}).items():
            assert len(vops) == len(self.ops), (
                f"{self.name}: variant {impl!r} has {len(vops)} ops, expected {len(self.ops)}"
            )
        if self.op_spans is None:
            assert len(self.ops) == len(self.graph), (
                f"{self.name}: ops ({len(self.ops)}) must align with layer graph ({len(self.graph)})"
            )
        else:
            assert len(self.op_spans) == len(self.ops), (
                f"{self.name}: {len(self.op_spans)} op spans for {len(self.ops)} ops"
            )
            pos = 0
            for lo, hi in self.op_spans:
                assert lo == pos and hi > lo, f"{self.name}: op spans must partition the graph"
                pos = hi
            assert pos == len(self.graph), (
                f"{self.name}: op spans cover [0,{pos}) but the graph has {len(self.graph)} layers"
            )
            self._op_start = {lo: i for i, (lo, _) in enumerate(self.op_spans)}
            self._op_end = {hi: i + 1 for i, (_, hi) in enumerate(self.op_spans)}

    @property
    def n_layers(self) -> int:
        """Layer count of the planning graph — the unit PlanIR spans use."""
        return len(self.graph)

    def op_range(self, lo, hi) -> tuple[int, int]:
        """Map a layer span [lo, hi) to the op range that executes it.

        With ``op_spans`` the span must start and end on stage-callable
        boundaries — exactly the cuts ``LayerGraph.cut_points`` declares
        legal; anything else raises."""
        if self.op_spans is None:
            return lo, hi
        try:
            return self._op_start[lo], self._op_end[hi]
        except KeyError:
            raise ValueError(
                f"{self.name}: layer span [{lo},{hi}) does not align with stage boundaries"
            ) from None

    def run_segment(self, state, lo, hi, impl: str = "xla"):
        return self.segment_fn(lo, hi, impl)(self.params, state)

    def segment_ops(self, lo, hi, impl: str = "xla"):
        """The (name, fn) ops executing layers ``[lo, hi)`` under ``impl``.

        Variant substitution is per fused group and only where the group's
        op span [a, b) lies entirely inside the segment; everything else —
        including blocks split by the segment boundary — stays ``xla``."""
        olo, ohi = self.op_range(lo, hi)
        ops = list(self.ops[olo:ohi])
        vops = (self.variant_ops or {}).get(impl)
        if impl != "xla" and vops is not None:
            for a, b in self.variant_groups or []:
                if a >= olo and b <= ohi:
                    ops[a - olo : b - olo] = vops[a:b]
        return ops

    def segment_fn(self, lo, hi, impl: str = "xla"):
        """Pure ``(params, state) -> state`` over the ops executing layers
        ``[lo, hi)``."""
        ops = self.segment_ops(lo, hi, impl)

        def f(params, state):
            for _, fn in ops:
                state = fn(params, state)
            return state

        return f

    def jitted_segment_fn(self, lo, hi, impl: str = "xla", holder=None) -> "CapturedSegment":
        """The captured form of ``segment_fn`` (a ``CapturedSegment``),
        cached on the model so every executor over the same span shares
        it, with a CUDA graph per set of state buffers and stream (an
        executor's slots, each holding one batch bucket). ``holder`` (an
        executor) takes a reference to the runner, which ``drop_graphs``
        gives back."""
        cache = self.__dict__.setdefault("_graph_runners", {})
        key = (lo, hi, impl)
        if key not in cache:
            cache[key] = CapturedSegment(f"{self.name}[{lo}:{hi}) {impl}", self.segment_fn(lo, hi, impl))
        if holder is not None:
            cache[key].holders.add(holder)
        return cache[key]

    def drop_graphs(self, lo, hi, impl: str = "xla", holder=None, streams=()) -> int:
        """Give back ``holder``'s reference to the captured runner of
        ``[lo, hi)`` under ``impl``: the graphs captured on ``streams`` (the
        holder's CUDA streams, as ``cuda_stream`` handles) go, and the
        runner with all its graphs leaves the model's cache once no other
        holder runs the span. Without a holder the runner goes whatever
        holds it. The freed graphs' memory returns to their pool for later
        captures (with the pool's last graph, to the caching allocator: the
        next capture into it starts a new pool). Returns
        how many graphs went. The caller makes sure no replay of them is
        still on the card; an executor that runs the span again takes the
        runner anew (captured anew if it went)."""
        cache = self.__dict__.get("_graph_runners", {})
        runner = cache.get((lo, hi, impl))
        if runner is None:
            return 0
        if holder is not None:
            runner.holders.discard(holder)
        if holder is None or not runner.holders:
            del cache[(lo, hi, impl)]
            return len(runner.graphs)
        streams = set(streams)
        gone = [k for k in runner.graphs if k[1] in streams]
        for k in gone:
            del runner.graphs[k]
        return len(gone)

    def captured_graphs(self) -> list[tuple[str, CapturedGraph]]:
        """Every graph this model's segment runners captured, with the
        runner's name."""
        return [
            (r.name, g) for r in self.__dict__.get("_graph_runners", {}).values() for g in r.graphs.values()
        ]

    def check_route(self, spans) -> None:
        """Validate that an arbitrary span list tiles [0, n_layers) on
        stage-executable boundaries — the staging precondition for a
        k-segment route. Raises ``ValueError`` with the offending span
        otherwise (gaps, overlaps, short coverage, or a cut inside a
        fused stage callable)."""
        pos = 0
        for lo, hi in spans:
            if lo != pos or hi <= lo:
                raise ValueError(
                    f"{self.name}: route spans must tile the graph contiguously; "
                    f"got [{lo},{hi}) at layer {pos}"
                )
            self.op_range(lo, hi)  # stage-boundary legality
            pos = hi
        if pos != self.n_layers:
            raise ValueError(
                f"{self.name}: route covers [0,{pos}) but the model has {self.n_layers} layers"
            )

    def run_route(self, x, spans):
        """Execute an arbitrary (validated) multi-segment route eagerly —
        the per-model reference the multi-cut equivalence tests pin
        against ``run_all``."""
        self.check_route(spans)
        state = self.init_state(x)
        for lo, hi in spans:
            state = self.run_segment(state, lo, hi)
        return self.finalize(state)

    def run_all(self, x):
        return self.finalize(self.run_segment(self.init_state(x), 0, self.n_layers))


def stage_ops_from_graph(
    graph: LayerGraph, impl: str = "xla"
) -> tuple[list[tuple[str, Callable]], list[tuple[int, int]]]:
    """Fine-grained (op, span) lists from a coarse graph whose metas carry
    ``attrs["stages"]`` callables — one executable op per stage, spanning
    that stage's primitive layers in the *expanded* graph. ``impl`` picks
    a registered stage-callable variant where one exists."""
    from ..models.yolov8 import node_stages

    ops, spans, pos = [], [], 0
    for l in graph:
        if not l.attrs.get("stages"):
            raise ValueError(f"{l.name}: no stage callables; cannot stage at fine granularity")
        for sname, nprims, fn in node_stages(l, impl):
            ops.append((sname, fn))
            spans.append((pos, pos + nprims))
            pos += nprims
    return ops, spans


def fuse_groups_of(graph: LayerGraph) -> list[tuple[int, int]]:
    """Layer-index spans of the graph's marked fused blocks
    (``attrs["fuse"]`` on the lead layer — see the model layer_graphs)."""
    return [
        (i, i + l.attrs["fuse"]["span"]) for i, l in enumerate(graph) if "fuse" in l.attrs
    ]


def pix2pix_staged(cfg, params, batch_dtype=None, granularity: str = "coarse") -> StagedModel:
    from ..models.pix2pix import Pix2PixGenerator, generator_ops

    gen = Pix2PixGenerator(cfg)
    graph = gen.layer_graph()
    groups = fuse_groups_of(graph)  # ops align 1:1 with (primitive) layers
    if granularity == "fine":
        # the pix graph is already primitive-only; the expanded view keeps
        # the coarse index map so plans annotate coarse spans uniformly
        graph = graph.expand()
    return StagedModel(
        name=f"pix2pix[{cfg.deconv_mode}]",
        ops=generator_ops(cfg),
        params=params["generator"] if "generator" in params else params,
        graph=graph,
        init_state=lambda x: {"x": x.to(cfg.act_dtype), "skips": []},
        finalize=lambda s: s["x"],
        batch_independent=cfg.batch_independent,
        variant_ops={"pallas_fused": generator_ops(cfg, impl="pallas_fused")},
        variant_groups=groups,
    )


def yolo_staged(cfg, params, granularity: str = "coarse") -> StagedModel:
    """YOLO staged model at ``coarse`` (one op per composite node) or
    ``fine`` granularity (expanded primitive graph, one op per sub-block
    stage callable — cuts inside ``c2f``/``sppf``/``head`` become
    executable)."""
    from ..models.yolov8 import YOLOv8

    if granularity not in ("coarse", "fine"):
        raise ValueError(f"granularity must be 'coarse' or 'fine', got {granularity!r}")
    m = YOLOv8(cfg)
    coarse = m.layer_graph()
    if granularity == "fine":
        ops, spans = stage_ops_from_graph(coarse)
        vops, _ = stage_ops_from_graph(coarse, impl="pallas_fused")
        graph, op_spans = coarse.expand(), spans
        # fused blocks whose variant spans multiple stage ops (the SPPF
        # pool pyramid: three pool stages -> one kernel) must switch impl
        # atomically; every other op switches individually, as before —
        # ConvBlock fuse groups live inside a single stage callable
        multi = []
        for glo, ghi in fuse_groups_of(graph):
            a = max(i for i, (lo, _hi) in enumerate(spans) if lo <= glo)
            b = min(i + 1 for i, (_lo, hi) in enumerate(spans) if hi >= ghi)
            if b - a > 1:
                multi.append((a, b))
        covered = {i for a, b in multi for i in range(a, b)}
        groups = sorted(multi + [(i, i + 1) for i in range(len(ops)) if i not in covered])
    else:
        ops, graph, op_spans = m.staged_ops(coarse), coarse, None
        vops = m.staged_ops(coarse, impl="pallas_fused")
        # every op is stage-atomic (a coarse node's fused blocks live
        # wholly inside its one stage callable), so groups are single ops
        groups = [(i, i + 1) for i in range(len(ops))]
    return StagedModel(
        name=cfg.name,
        ops=ops,
        params=params,
        graph=graph,
        init_state=lambda x: {"x": x.to(cfg.act_dtype)},
        finalize=lambda s: {"p3": s["o3"], "p4": s["o4"], "p5": s["o5"]},
        op_spans=op_spans,
        variant_ops={"pallas_fused": vops},
        variant_groups=groups,
    )


@dataclasses.dataclass
class TickLog:
    tick: int
    engine: str
    work: str


class TwoModelPipeline:
    """Steady-state double-buffered execution of a HaX-CoNN schedule.

    Thin wrapper over the generic ``serve.StreamExecutor``: the two-model
    swap schedule is expressed as two counter-phased routes (A: con then
    flex, B: flex then con) with one stream per model, which the executor
    runs tick-for-tick as the original phase-1/phase-2 loop did.
    """

    def __init__(
        self,
        model_a: StagedModel,
        model_b: StagedModel,
        plan,
        place_con: Callable | None = None,
        place_flex: Callable | None = None,
    ):
        from .plan_ir import PlanIR

        self.a, self.b = model_a, model_b
        # accept the unified entry point's PlanIR or a HaxConnResult
        ir = plan if isinstance(plan, PlanIR) else plan.ir
        self.pa, self.pb = ir.partitions
        self.plan = ir
        self.place_con = place_con or (lambda x: x)
        self.place_flex = place_flex or (lambda x: x)
        self.log: list[TickLog] = []

    def run_stream(self, frames_a, frames_b):
        """frames_*: lists of model inputs (equal length). Returns
        (outputs_a, outputs_b) in input order + populates ``self.log``."""
        from ..serve.executor import StreamExecutor  # lazy: serve imports this module
        from ..serve.streams import StreamSpec
        from .plan_ir import make_plan_ir

        assert len(frames_a) == len(frames_b)
        la, lb = self.a.n_layers, self.b.n_layers
        # the scheduler's typed IR drives the executor; rebuild it from the
        # (possibly caller-overridden) partition points
        ir = self.plan
        if ir is None or ir.partitions != [self.pa, self.pb]:
            ir = make_plan_ir(
                (self.a.name, self.b.name),
                ("con", "flex"),
                [[(0, 0, self.pa), (1, self.pa, la)], [(1, 0, self.pb), (0, self.pb, lb)]],
                kind="haxconn",
            )
        ex = StreamExecutor(
            [self.a, self.b],
            ir,
            [StreamSpec("A", 0), StreamSpec("B", 1)],
            max_queue=max(1, len(frames_a)),
            place_fns=[self.place_con, self.place_flex],
            engine_names=["con", "flex"],
            model_labels=["A", "B"],
            # the two-model pipeline is the paper-faithful correctness
            # harness: keep the eager op sequence (bit-exact vs run_all)
            jit_segments=False,
        )
        for fa, fb in zip(frames_a, frames_b):
            ok = ex.submit(0, fa) and ex.submit(1, fb)
            if not ok:
                raise RuntimeError("pipeline frame queue refused a frame (depth mis-sized)")
        outs = ex.run_until_drained()
        self.log = ex.log
        return outs["A"], outs["B"]


def submesh_placers(mesh_devices, n_con: int):
    """Split a flat device list into (constrained, flexible) placement fns:
    each moves every state leaf to its group's first device."""
    con, flex = list(mesh_devices[:n_con]), list(mesh_devices[n_con:])

    def place(devs):
        def f(state):
            return tree_map(lambda x: x.to(devs[0], non_blocking=True), state)

        return f

    return place(con or flex), place(flex or con)
