"""The CUDA-graph segment runners (``StagedModel.jitted_segment_fn``) and the
executor's ``jit_segments`` switch.

On the CPU the switch runs ``segment_fn`` (the caller asked for the CPU):
outputs are identical either way, no graph is captured, and the runner
cache is keyed ``(model, lo, hi, impl, bucket)``. On the card (``cuda``
marker) a replayed graph is held bit-exact against the eager ops with two
frames of one segment in flight and a bucket-padded batch, launches are
counted per replay, and a capture that meets a host sync raises naming
the segment.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core.graph import LayerGraph, pointwise_meta  # noqa: E402
from repro_torch.core.pipeline import CapturedSegment, StagedModel  # noqa: E402
from repro_torch.core.plan_ir import make_plan_ir  # noqa: E402
from repro_torch.kernels.fused import ops  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402
from repro_torch.serve import StreamExecutor, StreamSpec, build_server  # noqa: E402


def _serve(bundle, frames=2):
    srv = bundle.server
    for t in range(frames):
        for s in bundle.streams:
            srv.submit(s.model_index, bundle.frame_for(s.name, t))
    srv.pump()
    return srv.drain()


def _same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert len(a[name]) == len(b[name])
        for oa, ob in zip(a[name], b[name]):
            for ta, tb in zip(tree_leaves(oa), tree_leaves(ob)):
                assert torch.equal(ta, tb)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_jit_segments_switch_gives_identical_outputs_on_the_cpu(impl):
    kw = dict(img=32, base=8, n_pix=2, n_yolo=1, impl=impl, device="cpu")
    on, off = build_server(jit_segments=True, **kw), build_server(jit_segments=False, **kw)
    _same(_serve(on), _serve(off))
    assert on.server.executor.jit_segments and not on.server.executor.captures_graphs
    for model in on.models:
        assert model.captured_graphs() == []  # the CPU captures nothing
        for runner in model.__dict__["_graph_runners"].values():
            assert isinstance(runner, CapturedSegment)


def test_runner_cache_keys_are_model_span_impl_bucket():
    bundle = build_server(img=32, base=8, n_pix=3, n_yolo=1, norm="instance", batching=4, impl="pallas",
                          device="cpu")
    _serve(bundle, frames=2)
    ex = bundle.server.executor
    keys = set(ex._seg_fns)
    spans = {mi: {(s.lo, s.hi, s.impl) for s in segs} for mi, segs in enumerate(bundle.plan.segments)}
    for mi, lo, hi, impl, bucket in keys:
        assert (lo, hi, impl) in spans[mi]
        # Pix2Pix frames coalesce into power-of-two buckets; YOLO runs alone
        assert bucket in ((1, 2, 4) if mi == 0 else (1,))
    assert {k[4] for k in keys if k[0] == 0} >= {4} and {k[4] for k in keys if k[0] == 1} == {1}
    for (mi, lo, hi, impl, _), fn in ex._seg_fns.items():
        assert fn is bundle.models[mi].jitted_segment_fn(lo, hi, impl)  # shared through the model
    assert ex.prepare_plan(bundle.plan) > 0
    assert set(ex._seg_fns) == keys  # the warmup of the same plan reuses every runner


def _toy(n_layers=6, device="cpu"):
    ops = [(f"mul{i}", lambda p, s: {"x": s["x"] * 1.5 + 0.5}) for i in range(n_layers)]
    graph = LayerGraph("toy", [pointwise_meta(i, f"mul{i}", "act", (1, 64)) for i in range(n_layers)]).renumber()
    # a parameter tensor puts the executor (and its engine streams) on the device
    return StagedModel(name="toy", ops=ops, params={"w": torch.zeros(1, device=device)}, graph=graph,
                       init_state=lambda x: {"x": x}, finalize=lambda s: s["x"])


@pytest.mark.cuda
def test_card_capture_after_every_graph_of_a_stream_dropped():
    """A swap after the server drained: the next tick drops the old route's
    graphs, which leaves one engine's stream with none, before the new
    route reaches that stream. Its capture takes a new pool (the caching
    allocator refuses a capture into a pool whose graphs are all gone),
    and every frame's output is right."""
    _card()
    sm = _toy(device="cuda")
    ex = StreamExecutor([sm], make_plan_ir(("toy",), ("E0", "E1"), ROUTE_A), [StreamSpec("s0", 0)], max_queue=8)
    frames = [torch.full((1, 64), float(t), device="cuda") for t in range(6)]
    for x in frames[:2]:
        assert ex.submit(0, x)
    ex.run_until_drained()
    ex.swap_plan(make_plan_ir(("toy",), ("E0", "E1"), ROUTE_B))
    for x in frames[2:]:
        assert ex.submit(0, x)
    ex.run_until_drained()
    assert {name for name, _ in sm.captured_graphs()} == {f"toy[{lo}:{hi}) xla" for _, lo, hi in ROUTE_B[0]}
    want = list(frames)
    for _ in range(6):
        want = [w * 1.5 + 0.5 for w in want]
    for got, w in zip(ex.outputs["s0"], want):
        assert torch.equal(got, w)


# a three-segment route swapped for a two-segment one that shares no span
ROUTE_A = [[(0, 0, 2), (1, 2, 4), (0, 4, 6)]]
ROUTE_B = [[(0, 0, 1), (1, 1, 6)]]


def _swap_mid_route(device, jit_segments):
    """Two frames in flight on ROUTE_A when ROUTE_B is swapped in; returns
    the executor, the model and the runner keys after each tick from the
    swap on."""
    sm = _toy(device=device)
    ex = StreamExecutor([sm], make_plan_ir(("toy",), ("E0", "E1"), ROUTE_A), [StreamSpec("s0", 0)], max_queue=8,
                        jit_segments=jit_segments)
    for t in range(6):
        assert ex.submit(0, torch.full((1, 64), float(t), device=device))
    ex.tick()
    ex.tick()
    assert [f.stage for f in ex.in_flight] == [2, 1]
    new_ir = make_plan_ir(("toy",), ("E0", "E1"), ROUTE_B)
    assert ex.prepare_plan(new_ir) == 2
    ex.swap_plan(new_ir)
    keys = []
    while ex.pending:
        ex.tick()
        keys.append({k[:4] for k in ex._seg_fns})
    return ex, sm, keys


@pytest.mark.parametrize("jit_segments", [True, False])
def test_swap_drops_retired_runners_once_their_last_flight_completes(jit_segments):
    """The old route's runners stay while a flight admitted under it is in
    flight (tick 1 after the swap), and go with its completion (tick 2):
    a server that re-plans for good keeps the runners of live routes only."""
    ex, sm, keys = _swap_mid_route("cpu", jit_segments)
    old = {(0, lo, hi, "xla") for _, lo, hi in ROUTE_A[0]}
    new = {(0, lo, hi, "xla") for _, lo, hi in ROUTE_B[0]}
    assert keys[0] == old | new and all(k == new for k in keys[1:])
    assert set(sm.__dict__.get("_graph_runners", {})) == ({(lo, hi, "xla") for _, lo, hi in ROUTE_B[0]}
                                                          if jit_segments else set())
    fids = [c.frame_id for c in ex.completions]
    assert fids == list(range(6)) and not ex._retired
    want = [torch.full((1, 64), float(t)) for t in range(6)]
    for _ in range(6):
        want = [w * 1.5 + 0.5 for w in want]
    for got, w in zip(ex.outputs["s0"], want):
        assert torch.equal(got, w)


def test_drop_graphs_forgets_the_runner():
    sm = _toy()
    runner = sm.jitted_segment_fn(0, 2)
    assert sm.jitted_segment_fn(0, 2) is runner
    assert sm.drop_graphs(0, 2) == 0 and sm.drop_graphs(0, 2) == 0  # the CPU captured nothing
    assert sm.jitted_segment_fn(0, 2) is not runner


def test_a_stream_whose_graphs_are_all_gone_takes_a_new_pool(monkeypatch):
    """The pool bookkeeping of the captures: a stream keeps its pool while
    a graph captured into it lives, and takes a new one once they are all
    gone (the caching allocator refuses a capture into such a pool)."""
    import types

    from repro_torch.core import pipeline

    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(handles))
    monkeypatch.setattr(pipeline, "_POOLS", {})
    stream = types.SimpleNamespace(device=torch.device("cpu"), cuda_stream=7)
    pool, graphs = pipeline._graph_pool(stream)
    g = pipeline.CapturedGraph(None, None, [], {}, [], {})
    graphs.add(g)
    assert pipeline._graph_pool(stream) == (pool, graphs)  # a live graph keeps the pool
    del g
    again, fresh = pipeline._graph_pool(stream)
    assert again != pool and not fresh


def test_launch_counters_cover_every_kernel_package():
    counters = kernels.launch_counters()
    assert set(counters) == {"fused", "deconv", "attention", "ssd"}
    assert counters["fused"] is ops.launches
    kernels.graph_launches["conv_block"] += 3
    kernels.reset_graph_launches()
    assert not kernels.graph_launches


# ---- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_card_graph_replay_bit_exact_with_frames_in_flight_and_padded_buckets():
    """Instance-norm Pix2Pix coalesced into padded buckets (3 of 4 lanes)
    and YOLO with two frames of one segment in flight (overlapped
    dispatch): the replayed graphs give the eager ops' bits, and the
    kernel launches of the replays (counted per captured graph) equal the
    eager run's."""
    _card()
    # three Pix2Pix frames ride one bucket of 4; microbatch 2 admits both
    # YOLO frames in one tick, so they run each segment back to back
    kw = dict(img=64, base=8, n_pix=3, n_yolo=2, norm="instance", batching=4, microbatch=2, impl="pallas",
              device="cuda")
    on, off = build_server(jit_segments=True, **kw), build_server(jit_segments=False, **kw)
    for b in (on, off):
        _serve(b, frames=1)  # warm-up: builds and captures (the same buckets as the run below)
    torch.cuda.synchronize()
    counts = {}
    for name, b in (("on", on), ("off", off)):
        ops.reset_launches()
        kernels.reset_graph_launches()
        if name == "on":
            start = len(b.server.executor.log)  # the log of the run below
        outs = _serve(b, frames=1)
        torch.cuda.synchronize()
        counts[name] = {k: ops.launches[k] + kernels.graph_launches[k] for k in ops.launches}
        if name == "on":
            assert all(v == 0 for v in ops.launches.values())  # every launch was a replay
            outs_on = outs
        else:
            outs_off = outs
    _same(outs_on, outs_off)
    assert counts["on"] == counts["off"] and counts["on"]["sppf_pyramid"] == 2
    ex = on.server.executor
    assert {c.batch for c in ex.completions if c.stream.startswith("mri")} == {3}  # padded bucket of 4
    det = [e.tick for e in ex.log[start:] if e.work.startswith("yolo") and "[0:" in e.work]
    assert len(det) == 2 and det[0] == det[1]  # two YOLO frames through segment 0 in one tick
    graphs = [g for m in on.models for _, g in m.captured_graphs()]
    assert graphs and all(g.replays > 0 for g in graphs)
    assert {b for (_, _, _, _, b) in ex._seg_fns} == {1, 4}


@pytest.mark.cuda
def test_card_capture_with_a_host_sync_raises_naming_the_segment():
    _card()
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, impl="pallas", device="cuda")
    model = bundle.models[1]
    ops_ = list(model.ops)
    name, fn = ops_[0]

    def syncing(p, s):
        s = fn(p, s)
        if s["x"].sum().item() > 1e30:  # a branch on a tensor value
            s = dict(s)
        return s

    model.ops = [(name, syncing)] + ops_[1:]
    runner = model.jitted_segment_fn(0, 1, "xla")
    x = bundle.frame_for("det-0", 0)
    with pytest.raises(RuntimeError, match=r"CUDA-graph capture of segment .*\[0:1\) xla failed"):
        runner(model.params, model.init_state(x))
    model.ops = ops_


@pytest.mark.cuda
def test_card_swap_drops_the_retired_graphs():
    """On the card the old route's graphs are replayed by the flights in
    flight at the swap, then dropped with their runners: the model keeps
    the new route's graphs only, and every frame's output is right."""
    _card()
    ex, sm, keys = _swap_mid_route("cuda", True)
    assert ex.captures_graphs
    names = {name for name, _ in sm.captured_graphs()}
    assert names == {f"toy[{lo}:{hi}) xla" for _, lo, hi in ROUTE_B[0]}
    assert all(g.replays > 0 for _, g in sm.captured_graphs())
    want = [torch.full((1, 64), float(t), device="cuda") for t in range(6)]
    for _ in range(6):
        want = [w * 1.5 + 0.5 for w in want]
    for got, w in zip(ex.outputs["s0"], want):
        assert torch.equal(got, w)
