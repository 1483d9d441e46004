"""The served segments with their state donated: the executor's slots.

The JAX executor jits each served segment with its state donated
(``donate_argnums=(1,)``): leaves that pass through come back as the same
buffers, new leaves are written by the executable, and nothing copies the
state between two segments. The port's captured segments do the same
through ``serve.executor.Slot``: a flight's state lives in buffers its
route's CUDA graphs were captured on, segment k's graph reading where
segment k-1's wrote; admission writes each frame once into its rows of the
slot's stage-0 buffers and completion clones the finalized outputs once.
The parent tree's runner, kept here (``ParentSegment``), copied every state
leaf into its graph's buffers and cloned every output leaf out.

On the CPU a stand-in for ``core.pipeline.capture_graph`` drives the slot
logic (``fake_card``): its "graph" reruns the captured function on the same
input buffers and writes into the same output buffers, as a replay does.
Held here, for Pix2Pix and YOLOv8n at smoke widths with two frames of one
route in flight, padded buckets with ``microbatch`` 2, degraded flights and
a plan hot-swapped mid-route: every completion is bit-equal to the eager
executor (``jit_segments=False``), to the parent's runner and, for frames
that ran alone, to ``segment_fn`` run frame by frame; under a dispatch mode
outside the stand-in's replays, each frame is copied in once and each
flight's outputs cloned out once (2 host copies a Pix2Pix frame, 4 a YOLOv8n
frame) and nothing else; no slot is captured after the warm-up, slots are
reused and bounded by ``slot_bound``; each segment's graph reads the
previous one's output leaves; a swap's retired slots go once their last
flight completes; a completion's output survives 8 more frames through the
same slots; pad rows stay zero; an engine hand-off that makes new tensors
is copied into the graph's inputs; two replicas' slots never share a graph
pool. The ``cuda`` cases run the same checks on real graphs. Every run
uses one intra-op thread.
"""
import contextlib
import weakref

import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.api import plan as core_plan  # noqa: E402
from repro_torch.core.pipeline import StagedModel  # noqa: E402
from repro_torch.nn.module import tree_def, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.serve import build_server  # noqa: E402

COPY_OPS = ("copy_", "clone", "cat", "_to_copy")
OUT_LEAVES = {0: 1, 1: 3}  # finalize's leaves: Pix2Pix x; YOLOv8n p3, p4, p5

CASES = {
    # two Pix2Pix streams: two flights of one route in flight every tick
    "two_in_flight": dict(img=32, base=8, n_pix=2, n_yolo=1),
    # three instance-norm Pix2Pix frames coalesced into a bucket of 4 (one
    # pad row); microbatch 2 admits both YOLOv8n frames in one tick
    "padded_microbatch": dict(img=32, base=8, n_pix=3, n_yolo=2, norm="instance", batching=4, microbatch=2),
    # level-2 frames run the single-segment degraded route; level-1 frames
    # (YOLOv8n at half resolution) have shed shapes
    "degraded": dict(img=64, base=8, n_pix=1, n_yolo=1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HostCopies(TorchDispatchMode):
    """While entered, counts the host-issued ops that copy a tensor
    (``COPY_OPS``) by op name, but those of a stand-in graph's replay
    (``replaying``)."""

    replaying = False

    def __init__(self):
        super().__init__()
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if not HostCopies.replaying and name in COPY_OPS:
            self.rows[name] = self.rows.get(name, 0) + 1
        return func(*args, **(kwargs or {}))

    def total(self):
        return sum(self.rows.values())


class FakeGraph:
    """A captured graph's stand-in: ``replay`` reruns the captured function
    on the same input buffers and writes its results into the same output
    buffers, outside the counting mode."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        HostCopies.replaying = True
        try:
            new = self.run()
            for o, n in zip(tree_leaves(self.out), tree_leaves(new)):
                if o is not n:
                    o.copy_(n)
        finally:
            HostCopies.replaying = False


@pytest.fixture
def fake_card(monkeypatch):
    """Segments on the CPU run as the stand-in graphs; yields a counting
    mode whose ``captures`` lists the captures made."""
    mode = HostCopies()
    captures = []

    def capture_graph(stream, side, run, what, owner=None):
        out = run()
        captures.append((what, owner))
        return FakeGraph(run, out), out, weakref.WeakSet()

    monkeypatch.setattr(pipeline, "captures_on", lambda device: True)
    monkeypatch.setattr(pipeline, "capture_graph", capture_graph)
    mode.captures = captures
    yield mode


class ParentSegment:
    """The parent tree's runner: one graph per (params, state structure),
    captured on its own input buffers; each call copies every state leaf
    into them, replays, and clones every output leaf that is not a
    pass-through."""

    def __init__(self, name, fn):
        self.name, self.fn, self.graphs, self.holders = name, fn, {}, weakref.WeakSet()

    def __call__(self, params, state):
        leaves = tree_leaves(state)
        if not leaves or not pipeline.captures_on(leaves[0].device):
            return self.fn(params, state)
        stream = pipeline._current_stream(leaves[0].device)
        key = (id(params), None if stream is None else stream.cuda_stream, tree_def(state),
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        if key not in self.graphs:
            side = pipeline._capture_stream(leaves[0].device)
            if side is not None:
                side.wait_stream(stream)
            with torch.cuda.stream(side):
                static_in = [t.clone() for t in leaves]
                static_state = tree_unflatten(state, static_in)
                self.fn(params, static_state)
            graph, out, _ = pipeline.capture_graph(stream, side, lambda: self.fn(params, static_state), self.name)
            ids = {id(t): i for i, t in enumerate(static_in)}
            self.graphs[key] = (graph, static_in, out, [ids.get(id(o)) for o in tree_leaves(out)])
        graph, static_in, out, alias = self.graphs[key]
        for buf, t in zip(static_in, leaves):
            buf.copy_(t)
        graph.replay()
        return tree_unflatten(out, [leaves[a] if a is not None else o.clone()
                                    for o, a in zip(tree_leaves(out), alias)])


@contextlib.contextmanager
def parent_runner(monkeypatch):
    """Executors built inside run their captured segments on
    ``ParentSegment`` and admit by ``torch.cat`` (the non-slot path)."""

    def jitted(self, lo, hi, impl="xla", holder=None):
        cache = self.__dict__.setdefault("_parent_runners", {})
        if (lo, hi, impl) not in cache:
            cache[(lo, hi, impl)] = ParentSegment(f"{self.name}[{lo}:{hi}) {impl}", self.segment_fn(lo, hi, impl))
        return cache[(lo, hi, impl)]

    with monkeypatch.context() as m:
        m.setattr(StagedModel, "jitted_segment_fn", jitted)
        yield


def _frames(bundle, case, n, first=0):
    """``n`` rounds of (stream, frame, degrade) arrivals, one a stream each;
    the degraded case sends each model's level-2 frames and YOLOv8n's
    level-1 (half-resolution) frames beside the clean ones."""
    rounds = []
    for t in range(first, first + n):
        out = []
        for s in bundle.streams:
            x = bundle.frame_for(s.name, t)
            out.append((s.name, x, 0))
            if case == "degraded":
                out.append((s.name, x, 2))
                if s.model_index == 1:
                    out.append((s.name, x[:, ::2, ::2, :].contiguous(), 1))
        rounds.append(out)
    return rounds


def _serve(ex, rounds, mode=None, sent=None):
    """Submit each round and tick, then run the executor until drained
    (under ``mode`` where given); returns the completions of this run.
    ``sent`` collects each arrival by (stream, frame id)."""
    start = len(ex.completions)
    with mode if mode is not None else contextlib.nullcontext():
        for arrivals in rounds:
            for name, x, degrade in arrivals:
                if sent is not None:
                    sent[(name, ex._frame_ids[ex._stream_index(name)])] = (x, degrade)
                assert ex.submit(name, x, degrade=degrade)
            ex.tick()
        ex.run_until_drained()
    return ex.completions[start:]


def _recording(ex):
    """Wrap the executor's ``_complete`` and ``_take_slot``: the completed
    flights' (model, members) and the slots taken."""
    flights, taken = [], []
    complete, take = ex._complete, getattr(ex, "_take_slot", None)

    def rec_complete(flight):
        flights.append((flight.model_index, len(flight.members), flight.slot))
        return complete(flight)

    def rec_take(*a, **kw):
        taken.append(take(*a, **kw))
        return taken[-1]

    ex._complete = rec_complete
    if take is not None:
        ex._take_slot = rec_take
    return flights, taken


def _same(got, want):
    assert [(c.stream, c.frame_id) for c in got] == [(c.stream, c.frame_id) for c in want]
    for a, b in zip(got, want):
        la, lb = tree_leaves(a.output), tree_leaves(b.output)
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb)), (a.stream, a.frame_id)


def _reference(model, x, route):
    """``segment_fn`` along ``route`` on one frame."""
    state = model.init_state(x)
    for seg in route:
        state = model.segment_fn(seg.lo, seg.hi, seg.impl)(model.params, state)
    return model.finalize(state)


def _graph_count(bundle):
    return sum(len(m.captured_graphs()) for m in bundle.models)


def check_case(case, mode, device="cpu", monkeypatch=None):
    """The slots' checks on one case (see the module docstring); ``mode``
    counts host copies outside the replays."""
    kw = dict(CASES[case], impl="pallas", device=device, max_queue=16)
    bundle = build_server(**kw)
    ex = bundle.server.executor
    assert ex.captures_graphs and ex._use_slots
    # warm-up: one arrival of each kind a stream makes (and captures) every slot
    warm = _frames(bundle, case, 1, first=99)
    _serve(ex, warm)
    slots0 = {k: list(v) for k, v in ex._slots.items()}
    assert slots0 and all(len(v) == ex._slot_bounds[k] for k, v in slots0.items())
    graphs0, captures0 = _graph_count(bundle), len(getattr(mode, "captures", ()))
    assert graphs0 == sum(len(v) * len(k[1]) for k, v in slots0.items())
    for slots in slots0.values():  # segment k's graph reads segment k-1's outputs: the chain
        for slot in slots:
            assert all(a is b for a, b in zip(slot.graphs[0].static_in, tree_leaves(slot.state), strict=True))
            for prev, g in zip(slot.graphs, slot.graphs[1:]):
                outs = {id(t) for t in tree_leaves(prev.static_out)}
                assert all(id(t) in outs for t in g.static_in)

    flights, taken = _recording(ex)
    arrivals, sent = _frames(bundle, case, 4), {}
    got = _serve(ex, arrivals, mode, sent)
    if device == "cuda":
        torch.cuda.synchronize()
    # no capture in the run, and the slots are the warm-up's
    assert _graph_count(bundle) == graphs0 and len(getattr(mode, "captures", ())) == captures0
    assert ex.slots_beyond_bound == 0 and {k: list(v) for k, v in ex._slots.items()} == slots0
    assert not any(s.busy for v in ex._slots.values() for s in v)
    # reused: more flights than slots, each taken from its key's set
    assert len(taken) == len(flights) > len({id(s) for s in taken})
    # the host copies: each frame in once, each flight's outputs out once
    assert mode.rows.get("cat", 0) == 0 and mode.rows.get("_to_copy", 0) == 0
    assert mode.rows.get("copy_", 0) == sum(n for _, n, _ in flights) == len(sent)
    assert mode.rows.get("clone", 0) == sum(OUT_LEAVES[mi] for mi, _, _ in flights)
    n_frames = {mi: sum(n for m, n, _ in flights if m == mi) for mi in OUT_LEAVES}
    assert mode.total() <= 2 * n_frames[0] + 4 * n_frames[1]

    # the eager executor and the parent's runner, on the same arrivals
    twins = {}
    for name in ("eager", "parent"):
        with parent_runner(monkeypatch) if name == "parent" else contextlib.nullcontext():
            tw = build_server(**kw, jit_segments=name != "eager")
            tex = tw.server.executor
            if name == "parent":
                tex._use_slots = False
            _serve(tex, warm)
            parent_mode = HostCopies() if name == "parent" else None
            twins[name] = _serve(tex, arrivals, parent_mode)
            if name == "parent":
                assert tw.server.executor._slots == {} and parent_mode.total() > mode.total()
    _same(got, twins["eager"])
    _same(got, twins["parent"])
    # frames that ran alone: segment_fn frame by frame on the route they took
    alone = 0
    for c in got:
        if c.batch == 1:
            mi = next(s.model_index for s in bundle.streams if s.name == c.stream)
            x, degrade = sent[(c.stream, c.frame_id)]
            assert degrade == c.degrade
            route = ex._degraded_route(mi) if degrade == 2 else ex.plan.route(mi)
            want = _reference(bundle.models[mi], x, route)
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c.output), tree_leaves(want)))
            alone += 1
    assert alone == len(got) - sum(c.batch > 1 for c in got) > 0

    # a completion's output survives 8 more frames through the same slots
    kept = [t.clone() for t in tree_leaves(got[0].output)]
    for t in range(2):
        _serve(ex, _frames(bundle, case, 4, first=10 + 4 * t))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0].output), kept))
    assert {k: list(v) for k, v in ex._slots.items()} == slots0
    return ex


@pytest.mark.parametrize("case", sorted(CASES))
def test_slots_hold_each_flight_state_on_the_fake_card(fake_card, monkeypatch, case):
    ex = check_case(case, fake_card, monkeypatch=monkeypatch)
    if case == "two_in_flight":
        # two Pix2Pix frames of one route in flight each tick: two slots
        assert [r["slots"] for r in ex.slot_counts() if r["model"] == 0] == [2]
    if case == "padded_microbatch":
        rows = {r["model"]: r for r in ex.slot_counts()}
        assert rows[0]["shapes"][0][0] == 4 and rows[1]["bound"] == 2 * len(rows[1]["route"])
    if case == "degraded":
        routes = {(r["model"], len(r["route"])) for r in ex.slot_counts()}
        assert (0, 1) in routes and (1, 1) in routes  # the degraded single-segment routes
        shapes = {tuple(r["shapes"][0]) for r in ex.slot_counts() if r["model"] == 1}
        assert (1, 32, 32, 3) in shapes and (1, 64, 64, 3) in shapes  # the shed resolution


def test_pad_rows_stay_zero_after_a_fuller_flight(fake_card):
    """A bucket-4 slot that held 4 frames, then 3: its fourth row is zero
    again before the second flight runs."""
    bundle = build_server(**CASES["padded_microbatch"], impl="pallas", device="cpu", max_queue=16)
    ex = bundle.server.executor
    extra = bundle.frame_for("mri-0", 50)
    arrivals = [(s.name, bundle.frame_for(s.name, 0), 0) for s in bundle.streams if s.model_index == 0]
    _serve(ex, [arrivals + [("mri-0", extra, 0)]])  # 4 frames: one full bucket
    (key,) = [k for k in ex._slots if k[0] == 0 and k[2][1][0][0][0] == 4]
    full = [s for s in ex._slots[key] if s.rows == 4]
    assert full
    seen = []
    take = ex._take_slot

    def rec(*a, **kw):
        slot = take(*a, **kw)
        seen.append((slot, tree_leaves(slot.state)[0][3].clone()))
        return slot

    ex._take_slot = rec
    _serve(ex, [arrivals])  # 3 frames
    slot, row3 = next((s, r) for s, r in seen if s.key == key)
    assert slot.rows == 3 and not row3.any()


def test_hot_swap_mid_route_retires_the_old_routes_slots(fake_card, monkeypatch):
    """Flights in flight at a swap finish on their admitted route through
    its slots; the old route's slots (and their graphs) go with its last
    flight; every output is bit-equal to the eager executor given the same
    swap at the same tick, and to the parent's runner."""
    kw = dict(CASES["two_in_flight"], impl="pallas", device="cpu", max_queue=16)

    def run(jit=True, parent=False):
        with parent_runner(monkeypatch) if parent else contextlib.nullcontext():
            bundle = build_server(**kw, jit_segments=jit)
            ex = bundle.server.executor
            if parent:
                ex._use_slots = False
            alt = core_plan([m.graph for m in bundle.models], list(bundle.engines), max_cuts=2, impl="pallas")
            old = [tuple((s.lo, s.hi) for s in segs) for segs in bundle.plan.segments]
            assert old != [tuple((s.lo, s.hi) for s in segs) for segs in alt.segments]
            _serve(ex, _frames(bundle, "two_in_flight", 1, first=99))
            for name, x, d in [a for r in _frames(bundle, "two_in_flight", 4) for a in r]:
                assert ex.submit(name, x, degrade=d)
            ex.tick()
            ex.tick()
            at_swap = list(ex.in_flight)
            assert at_swap and all(0 < f.stage < len(f.route) for f in at_swap)
            ex.prepare_plan(alt)
            ex.swap_plan(alt)
            seen = []
            while ex.pending:
                ex.tick()
                seen.append(({k[:2] for k in ex._slots}, [f for f in ex.in_flight if f in at_swap]))
            return bundle, ex, at_swap, seen

    bundle, ex, at_swap, seen = run()
    old_routes = {(f.model_index, tuple((s.lo, s.hi, s.impl, s.engine) for s in f.route)) for f in at_swap}
    for live, old_flights in seen:
        held = {(f.model_index, tuple((s.lo, s.hi, s.impl, s.engine) for s in f.route)) for f in old_flights}
        assert held <= live  # an old flight's route keeps its slots
        if not old_flights:
            assert not live & old_routes  # ... and they go with its last flight
    new_routes = {(mi, tuple((s.lo, s.hi, s.impl, s.engine) for s in segs)) for mi, segs in enumerate(ex.plan.segments)}
    assert {k[:2] for k in ex._slots} == new_routes
    # the captured graphs are the live slots' only
    assert _graph_count(bundle) == sum(len(v) * len(k[1]) for k, v in ex._slots.items())
    got = ex.completions
    _same(got, run(jit=False)[1].completions)
    _same(got, run(parent=True)[1].completions)


def test_replicas_hold_slots_and_pools_of_their_own(fake_card):
    """Two in-process replicas over shared models: each executor's slots
    are its own, their graphs' memory pools (the capture's ``owner``) never
    shared, and the fleet serves every stream the single server's bits."""
    kw = dict(CASES["two_in_flight"], impl="pallas", device="cpu", max_queue=16)
    outs = {}
    for key, extra in (("single", {}), ("fleet", {"replicas": 2})):
        bundle = build_server(**kw, **extra)
        srv = bundle.server
        for t in (99, 0, 1, 2):
            for s in bundle.streams:
                srv.offer(s.name, bundle.frame_for(s.name, t))
            srv.tick()
        outs[key] = {n: v[-3:] for n, v in srv.drain().items()}
    executors = [s.executor for s in bundle.server.servers]
    tokens = [{sl.token for v in ex._slots.values() for sl in v} for ex in executors]
    assert all(tokens) and not tokens[0] & tokens[1]
    owners = [o for _, o in fake_card.captures]
    assert {o for o in owners if o in tokens[0]}.isdisjoint(tokens[1])
    for name in outs["single"]:
        for a, b in zip(outs["fleet"][name], outs["single"][name]):
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_a_hand_off_that_moves_the_state_is_copied_into_the_graph_inputs(fake_card):
    """Engine hand-offs that make new tensors (as a move to another device
    does): each segment's graph keeps reading the tensors it was captured
    on, and each hand-off is copied into them, once a leaf."""
    from repro_torch.core.graph import LayerGraph, pointwise_meta
    from repro_torch.core.plan_ir import make_plan_ir
    from repro_torch.nn.module import tree_map
    from repro_torch.serve import StreamExecutor, StreamSpec

    ops = [(f"mul{i}", lambda p, s: {"x": s["x"] * 1.5 + 0.5}) for i in range(6)]
    graph = LayerGraph("toy", [pointwise_meta(i, f"mul{i}", "act", (1, 64)) for i in range(6)]).renumber()
    sm = StagedModel(name="toy", ops=ops, params={"w": torch.zeros(1)}, graph=graph,
                     init_state=lambda x: {"x": x}, finalize=lambda s: s["x"])
    move = [lambda s: tree_map(torch.clone, s)] * 2  # a new tensor each hand-off
    ex = StreamExecutor([sm], make_plan_ir(("toy",), ("E0", "E1"), [[(0, 0, 2), (1, 2, 4), (0, 4, 6)]]),
                        [StreamSpec("s0", 0)], max_queue=8, place_fns=move)
    frames = [torch.full((1, 64), float(t)) for t in range(6)]
    _serve(ex, [[("s0", frames[0], 0)]])
    graphs = [g for slots in ex._slots.values() for s in slots for g in s.graphs]
    inputs = {id(t) for g in graphs for t in g.static_in}
    got = _serve(ex, [[("s0", x, 0)] for x in frames[1:]], fake_card)
    for c, x in zip(got, frames[1:]):
        want = x
        for _ in range(6):
            want = want * 1.5 + 0.5
        assert torch.equal(c.output, want)
    assert {id(t) for g in graphs for t in g.static_in} == inputs
    # per frame: its copy in, three hand-offs (a clone each, made by the
    # placement) copied into the graphs' inputs, its output cloned out
    assert fake_card.rows == {"copy_": 5 * 4, "clone": 5 * 4}


def test_eager_and_cpu_executors_hold_no_slots():
    """``jit_segments=False`` and a CPU executor (no stand-in) run
    ``segment_fn`` on fresh tensors: no slot, no capture."""
    for jit in (True, False):
        bundle = build_server(**CASES["two_in_flight"], impl="pallas", device="cpu", jit_segments=jit)
        ex = bundle.server.executor
        _serve(ex, _frames(bundle, "two_in_flight", 2))
        assert not ex._use_slots and ex._slots == {} and _graph_count(bundle) == 0


def test_slot_bound_counts_the_flights_a_key_can_hold():
    bundle = build_server(**CASES["padded_microbatch"], impl="pallas", device="cpu")
    ex = bundle.server.executor
    pix, yolo = (ex.plan.route(mi) for mi in (0, 1))
    assert ex.slot_bound(0, pix, merged=True) == len(pix)  # one merged flight a tick
    assert ex.slot_bound(0, pix, merged=False) == len(pix) * 4  # degraded frames: up to max_batch a tick
    assert ex.slot_bound(1, yolo, merged=False) == len(yolo) * 2  # microbatch 2 over two streams
    one = build_server(**CASES["two_in_flight"], impl="pallas", device="cpu").server.executor
    assert one.slot_bound(0, one.plan.route(0), merged=False) == len(one.plan.route(0))


# ---- on the card --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_slots_hold_each_flight_state(monkeypatch, case):
    """The same checks on the card's CUDA graphs (a replay is no dispatched
    op, so the mode counts the host's copies only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the degraded route runs the plain ops, whose cuDNN kernels may give
    # other bits from one eager run to the next unless made deterministic
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    check_case(case, HostCopies(), device="cuda", monkeypatch=monkeypatch)
