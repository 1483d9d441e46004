"""The port's in-process fleet (``repro_torch.serve.fleet``), ``DevicePool``
and ``TwoModelPipeline`` against the JAX package.

Mirrors ``tests/test_fleet.py``. Pins: ``DevicePool`` slices devices as the
JAX pool does and places state with ``.to``; the ``FleetRouter`` gives the
JAX router's assignments for the same seed, arrivals and loads; a 2-replica
``FleetServer`` serves each stream bit for bit what one executor fed the
same arrivals serves, and what the JAX ``FleetServer`` serves on the same
bridged params and frames within the repo's f32 whole-model pin (atol and
rtol 1e-3, ``tests/test_torch_models.py``: the deep blocks batch-normalise
over 1-4 pixels at img 32, which amplifies the rounding differences
between XLA's and ATen's convolutions past the 1e-4 single-block pin); the
report merge, one shared ``OnlineCost`` and the sticky router across a
plan swap; a swap in one replica leaves the other's outputs bit-exact, and
a graph runner leaves the shared models' cache only once every replica has
retired its span; ``TwoModelPipeline.run_stream`` logs the JAX pipeline's
ticks and gives its outputs within that pin (widened by the JAX package's
own eager-vs-jitted distance, which exceeds it on YOLO). Small sizes (img 32, base 8)
on the CPU; both packages run their segments eagerly where outputs are
compared across them.
"""
import dataclasses
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as JDLA  # noqa: E402
from repro.core.engine import DevicePool as JPool, jetson_orin_engines as jengines  # noqa: E402
import repro.models as jm  # noqa: E402
from repro.serve import FleetRouter as JRouter, FleetServer as JFleet, StreamSpec as JSpec  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as TDLA  # noqa: E402
from repro_torch.core.cost_model import OnlineCost  # noqa: E402
from repro_torch.core.engine import DevicePool, jetson_orin_engines  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.nn import from_jax  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FleetRouter,
    FleetServer,
    MultiStreamServer,
    StreamSpec,
    build_server,
)
from repro_torch.serve.metrics import router_imbalance  # noqa: E402

CPU = torch.device("cpu")
WHOLE_MODEL_PIN = dict(atol=1e-3, rtol=1e-3)  # f32 whole models (tests/test_torch_models.py)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the files the suite runs beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    return jetson_orin_engines(constraints_dla=TDLA)


def _jax_params(module, seed):
    """The JAX parameter tree of ``module`` with numpy-drawn values (weights
    N(0, 1/fan_in), norm scales near 1, the rest near 0)."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        if len(s.shape) > 1:
            return jnp.asarray(rs.randn(*s.shape) / np.sqrt(math.prod(s.shape[:-1])), s.dtype)
        name = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in name or "moving_var" in name) else 0.0
        return jnp.asarray(base + 0.1 * rs.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(draw, module.abstract())


@pytest.fixture(scope="module")
def pairs():
    """The serving pair (Pix2Pix cropping + YOLOv8) at img 32 / base 8 in
    both packages, on the same numpy-drawn parameters."""
    pj = _jax_params(jm.Pix2PixGenerator(jm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping")), 0)
    yj = _jax_params(jm.YOLOv8(jm.YOLOv8Config(img_size=32)), 1)
    jpair = (
        jcore.pix2pix_staged(jm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping"), {"generator": pj}),
        jcore.yolo_staged(jm.YOLOv8Config(img_size=32), yj),
    )
    tpair = (
        tpipe.pix2pix_staged(
            tm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping"),
            {"generator": from_jax(jax.tree.map(np.asarray, pj))},
        ),
        tpipe.yolo_staged(tm.YOLOv8Config(img_size=32), from_jax(jax.tree.map(np.asarray, yj))),
    )
    return jpair, tpair


def _plan(tpair, engines, **kw):
    gpu, dla = engines
    return tplan([m.graph for m in tpair], [dla, gpu], **kw)


STREAMS = [("mri-0", 0), ("mri-1", 0), ("det-0", 1)]


def _frames(n, seed=0):
    rs = np.random.RandomState(seed)
    return {name: [rs.randn(1, 32, 32, 3).astype(np.float32) for _ in range(n)] for name, _ in STREAMS}


def _drive_named(server, frames, n, to=torch.from_numpy, lo=0):
    for t in range(lo, lo + n):
        for name, _ in STREAMS:
            server.offer(name, to(frames[name][t]))
        server.tick()
    return server.drain()


def _same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert len(a[name]) == len(b[name])
        for oa, ob in zip(a[name], b[name]):
            for ta, tb in zip(tree_leaves(oa), tree_leaves(ob)):
                assert torch.equal(ta, tb)


# ---- DevicePool --------------------------------------------------------------


def test_device_pool_single_device_identity(engines):
    """On a one-device pool every replica binds the full virtual engine pair
    to that device and placement is the identity."""
    gpu, dla = engines
    pool = DevicePool((dla, gpu), devices=[CPU])
    assert pool.n_devices == 1 and pool.replica_devices(0, 2) == pool.replica_devices(1, 2) == [CPU]
    tree = {"x": torch.ones(2, 2)}
    for fn in pool.place_fns(0, 2):
        assert fn(tree) is tree  # no move, no copy
    for r in range(3):
        assert len(pool.replica_devices(r, 3)) >= 1


def test_device_pool_discover_defaults(monkeypatch):
    pool = DevicePool.discover(devices=[CPU])
    assert [e.name for e in pool.engines] == ["DLA", "GPU"]
    # with no device named the pool ranges over the CUDA cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert DevicePool.discover().devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA card"):
        DevicePool.discover()


@pytest.mark.parametrize("n_devices,n_replicas", [(1, 2), (2, 2), (4, 2), (4, 3), (3, 5), (8, 4)])
def test_device_pool_slices_as_the_jax_pool(engines, n_devices, n_replicas):
    gpu, dla = engines
    jg, jd = jengines(constraints_dla=JDLA)
    devices = [f"d{i}" for i in range(n_devices)]  # opaque placement targets
    pool, jpool = DevicePool((dla, gpu), devices=devices), JPool((jd, jg), devices=devices)
    for r in range(n_replicas):
        assert pool.replica_devices(r, n_replicas) == jpool.replica_devices(r, n_replicas)
        assert pool.worker_pool(r, n_replicas).devices == jpool.worker_pool(r, n_replicas).devices
        assert [e.device for e in pool.engine_slice(r, n_replicas)] == [
            e.device for e in jpool.engine_slice(r, n_replicas)
        ]


def test_engine_slice_binds_devices_without_changing_identity(engines):
    """Bound specs plan identically to the abstract pair: ``device`` is
    excluded from EngineSpec equality/hash, so one plan serves every
    replica slice."""
    gpu, dla = engines
    sliced = DevicePool((dla, gpu), devices=[CPU]).engine_slice(0, 2)
    assert list(sliced) == [dla, gpu]
    assert all(e.device == CPU for e in sliced)
    assert hash(sliced[0]) == hash(dla) and dla.bound(None) == dla


def test_place_fns_move_state_to_the_replica_devices(engines):
    """With several devices each engine's closure moves every state leaf to
    its device (here the CPU and the meta device)."""
    gpu, dla = engines
    meta = torch.device("meta")
    pool = DevicePool((dla, gpu), devices=[CPU, meta])
    state = {"x": torch.ones(1, 4), "skips": [torch.zeros(1, 2)]}
    (c0, c1), (m0, m1) = pool.place_fns(0, 2), pool.place_fns(1, 2)
    assert all(t.device == CPU for t in tree_leaves(c0(state)) + tree_leaves(c1(state)))
    moved = m0(state)
    assert all(t.device.type == "meta" for t in tree_leaves(moved))
    assert [tuple(t.shape) for t in tree_leaves(moved)] == [(1, 2), (1, 4)]


def test_device_pool_validates_inputs(engines):
    gpu, dla = engines
    with pytest.raises(ValueError):
        DevicePool((), devices=[CPU])
    with pytest.raises(ValueError):
        DevicePool((dla, gpu), devices=[])
    with pytest.raises(ValueError):
        DevicePool((dla, gpu), devices=[CPU]).replica_devices(2, 2)


# ---- FleetRouter -------------------------------------------------------------


def _route_sequence(router_cls, n, seed, n_streams, evict_at=None):
    """A seeded arrival sequence with bursty loads, periodic drains,
    mixed deadlines and one eviction, through one router."""
    rs = np.random.RandomState(seed)
    r = router_cls(n, seed=seed)
    loads = [0] * n
    routed = []
    for i in range(60):
        name = f"s{rs.randint(n_streams)}"
        deadline = [None, 0.01, 0.05, 0.2][rs.randint(4)]
        if rs.rand() < 0.2:
            w = r.pick(loads)
        else:
            w = r.route_arrival(name, loads, deadline_s=deadline)
        loads[w] += int(rs.randint(1, 4))
        if i % 7 == 6:
            loads = [max(0, x - 3) for x in loads]
        if evict_at is not None and i == evict_at:
            routed.append(("evict", r.evict(w)))
        routed.append(w)
    return routed, r.summary()


@pytest.mark.parametrize("n,seed,n_streams", [(2, 0, 4), (3, 11, 6), (4, 3, 9), (5, 7, 3)])
@pytest.mark.parametrize("evict", [False, True])
def test_router_assignments_equal_the_jax_router(n, seed, n_streams, evict):
    evict_at = 30 if evict else None
    assert _route_sequence(FleetRouter, n, seed, n_streams, evict_at) == _route_sequence(
        JRouter, n, seed, n_streams, evict_at
    )


def test_router_seeded_determinism():
    arrivals = [f"s{i % 6}" for i in range(40)]
    results = []
    for _ in range(2):
        r = FleetRouter(3, seed=11)
        loads = [0, 0, 0]
        routed = []
        for name in arrivals:
            rep = r.route_arrival(name, loads, deadline_s=0.1)
            loads[rep] += 1
            if len(routed) % 5 == 4:  # periodic service drains the queues
                loads = [0, 0, 0]
            routed.append(rep)
        results.append((routed, dict(r.assignments), list(r.routed_frames)))
    assert results[0] == results[1]


def test_router_sticky_stream_invariant():
    r = FleetRouter(2, seed=0)
    first = r.assign("mri-0", [0, 0], deadline_s=0.05)
    other_favored = [10**6, 10**6]
    other_favored[1 - first] = 0
    assert r.assign("mri-0", other_favored) == first
    assert r.replica_of("mri-0") == first


def test_router_deadline_pressure_tiebreak():
    r = FleetRouter(2, seed=0)
    a = r.assign("tight-0", [0, 0], deadline_s=0.01)
    b = r.assign("tight-1", [0, 0], deadline_s=0.01)
    assert a != b  # equal loads: accumulated pressure pushes b elsewhere


def test_router_bounded_imbalance_under_bursty_arrivals():
    r = FleetRouter(2, seed=3)
    loads = [0, 0]
    for _ in range(10):
        for i in range(8):
            for _ in range(3):  # bursty: 3 frames back-to-back per stream
                rep = r.route_arrival(f"s{i}", loads, deadline_s=0.1)
                loads[rep] += 1
        loads = [0, 0]  # inter-burst drain
    assert router_imbalance(r.routed_frames) <= 1.5
    summ = r.summary()
    assert summ["streams_assigned"] == 8 and sum(summ["routed_frames"]) == 10 * 8 * 3


def test_router_validates_and_resets():
    with pytest.raises(ValueError):
        FleetRouter(0)
    r = FleetRouter(2, seed=0)
    r.route_arrival("a", [0, 0])
    r.reset_counts()
    assert r.routed_frames == [0, 0] and r.replica_of("a") is not None


# ---- fleet vs single executor, and vs the JAX fleet --------------------------


def _fleet(tpair, plan, **kw):
    streams = [StreamSpec(n, m) for n, m in STREAMS]
    return FleetServer(list(tpair), plan, streams, replicas=2, max_queue=8, **kw)


@pytest.mark.parametrize("jit_segments", [True, False])
def test_fleet_bit_exact_vs_single_executor(pairs, engines, jit_segments):
    """R=2 outputs are bit-exact per stream vs the same arrivals through one
    MultiStreamServer: sticky routing is placement only."""
    _, tpair = pairs
    plan = _plan(tpair, engines)
    frames = _frames(3)
    fleet = _fleet(tpair, plan, jit_segments=jit_segments)
    single = MultiStreamServer(list(tpair), plan, [StreamSpec(n, m) for n, m in STREAMS], max_queue=8,
                               jit_segments=jit_segments)
    outs = _drive_named(fleet, frames, 3)
    _same(outs, _drive_named(single, frames, 3))
    assert all(len(v) == 3 for v in outs.values())
    assert set(fleet.router.assignments) == {n for n, _ in STREAMS}
    assert fleet.pool.devices == [CPU]  # the models' device


def test_fleet_matches_the_jax_fleet(pairs, engines):
    """The same bridged params and frames through the JAX ``FleetServer``
    (replicas 2, eager segments) and the port's: equal router assignments,
    outputs within the whole-model pin."""
    jpair, tpair = pairs
    gpu, dla = engines
    jg, jd = jengines(constraints_dla=JDLA)
    jplan_ = jcore.plan([m.graph for m in jpair], [jd, jg])
    plan = _plan(tpair, engines)
    assert plan.to_json() == jplan_.to_json()
    frames = _frames(2, seed=5)
    jfleet = JFleet(list(jpair), jplan_, [JSpec(n, m) for n, m in STREAMS], replicas=2,
                    pool=JPool((jd, jg)), max_queue=8, jit_segments=False)
    fleet = _fleet(tpair, plan, jit_segments=False)
    jouts = _drive_named(jfleet, frames, 2, to=jnp.asarray)
    touts = _drive_named(fleet, frames, 2)
    assert fleet.router.assignments == jfleet.router.assignments
    worst = 0.0
    for name, _ in STREAMS:
        assert len(touts[name]) == len(jouts[name]) == 2
        for a, b in zip(touts[name], jouts[name]):
            for ta, tb in zip(tree_leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(ta.numpy(), np.asarray(tb), **WHOLE_MODEL_PIN)
                worst = max(worst, float(np.abs(ta.numpy() - np.asarray(tb)).max()))
    print(f"max |port fleet - jax fleet| = {worst:.2e}")


def test_fleet_report_merges_replica_metrics(pairs, engines):
    _, tpair = pairs
    fleet = _fleet(tpair, _plan(tpair, engines))
    _drive_named(fleet, _frames(2, seed=7), 2)
    fleet.finish()
    rep = fleet.report()
    assert rep["replicas"] == 2 and rep["frames"] == 6
    assert rep["frames"] == sum(r["frames"] for r in rep["per_replica"])
    assert rep["router_imbalance"] >= 1.0 and sum(rep["router"]["routed_frames"]) == 6
    assert rep["dispatch"] == "overlapped"


def test_fleet_closed_loop_submit_balances(pairs, engines):
    _, tpair = pairs
    plan = _plan(tpair, engines)
    fleet = FleetServer(list(tpair), plan, [StreamSpec("mri-0", 0), StreamSpec("det-0", 1)], replicas=2,
                        max_queue=8)
    frames = _frames(4, seed=2)["mri-0"]
    for t in range(4):
        fleet.submit(0, torch.from_numpy(frames[t]))
        fleet.pump()
    outs = fleet.drain()
    assert sum(len(v) for v in outs.values()) == 4
    assert all(c > 0 for c in fleet.router.routed_frames)


def test_fleet_validates_replicas(pairs, engines):
    _, tpair = pairs
    plan = _plan(tpair, engines)
    streams = [StreamSpec("mri-0", 0), StreamSpec("det-0", 1)]
    with pytest.raises(ValueError):
        FleetServer(list(tpair), plan, streams, replicas=0)
    with pytest.raises(ValueError):
        FleetServer(list(tpair), plan, streams, replicas=2, replanners=[None])


def test_router_sticky_across_plan_hot_swap(pairs, engines):
    """A mid-stream ``swap_plan`` on one replica is a routing no-op: the
    assignments, per-stream order and frame counts are those before it."""
    _, tpair = pairs
    plan, alt = _plan(tpair, engines, max_cuts=1), _plan(tpair, engines, max_cuts=2)
    frames = _frames(4, seed=13)
    fleet = _fleet(tpair, plan)
    _drive_named(fleet, frames, 2)
    before = dict(fleet.router.assignments)
    assert set(before) == {n for n, _ in STREAMS}
    rev = fleet.servers[0].executor.swap_plan(alt)
    outs = _drive_named(fleet, frames, 2, lo=2)
    assert fleet.router.assignments == before
    assert all(len(outs[n]) == 4 for n, _ in STREAMS)
    assert fleet.report()["plan_revision"] == rev >= 1


def _runner_spans(model):
    return set(model.__dict__.get("_graph_runners", {}))


def _held(ex, mi):
    """The (lo, hi, impl) spans of model ``mi`` an executor holds runners of."""
    return {k[1:4] for k in ex._seg_fns if k[0] == mi}


def _plan_spans(plan, mi):
    return {(s.lo, s.hi, s.impl) for s in plan.segments[mi]}


def test_swap_in_one_replica_keeps_the_others_runners(pairs, engines):
    """Two replicas over shared models with graph runners (``jit_segments``,
    which builds the runners on the CPU too), both serving Pix2Pix streams.
    Replica A swaps to another plan: the old Pix2Pix spans' runners stay in
    the models' cache, held by B alone, while B runs them, and every stream
    keeps the bits an unswapped single executor serves. Once B has retired
    them too, each model's cache holds exactly the spans the replicas still
    run."""
    _, tpair = pairs
    plan, alt = _plan(tpair, engines, max_cuts=1), _plan(tpair, engines, max_cuts=2)
    retired = _plan_spans(plan, 0) - _plan_spans(alt, 0)
    assert retired
    # models with an empty runner cache, sharing the pair's ops and params
    fresh = [dataclasses.replace(m) for m in tpair]
    frames = _frames(6, seed=21)
    fleet = FleetServer(fresh, plan, [StreamSpec(n, m) for n, m in STREAMS], replicas=2, max_queue=8)
    single = MultiStreamServer(list(tpair), plan, [StreamSpec(n, m) for n, m in STREAMS], max_queue=8,
                               jit_segments=False)
    want = _drive_named(single, frames, 6)
    _drive_named(fleet, frames, 2)
    a, b = (s.executor for s in fleet.servers)
    assert fleet.router.replica_of("mri-0") != fleet.router.replica_of("mri-1")  # both serve Pix2Pix
    a.swap_plan(alt)
    _drive_named(fleet, frames, 2, lo=2)
    for mi, m in enumerate(fresh):
        assert _runner_spans(m) == _held(a, mi) | _held(b, mi)
    assert retired <= _runner_spans(fresh[0]) and not retired & _held(a, 0)
    assert all(set(fresh[0].__dict__["_graph_runners"][k].holders) == {b} for k in retired)
    b.swap_plan(alt)
    got = _drive_named(fleet, frames, 2, lo=4)
    _same(got, want)  # every stream, on either replica, before and after the swaps
    for mi, m in enumerate(fresh):
        assert _runner_spans(m) == _held(a, mi) | _held(b, mi)
    assert _runner_spans(fresh[0]) == _plan_spans(alt, 0)


# ---- facade + shared OnlineCost ------------------------------------------------


def test_build_server_fleet_shares_one_online_cost():
    bundle = build_server(img=32, base=8, n_pix=2, n_yolo=1, replicas=2, replan=True, device="cpu",
                          router_seed=5)
    server = bundle.server
    assert isinstance(server, FleetServer) and bundle.replicas == 2 and server.router.seed == 5
    onlines = [s.replanner.online for s in server.servers]
    assert all(o is onlines[0] for o in onlines)  # one fleet-wide store
    assert bundle.replanner is server.servers[0].replanner
    assert server.executor.captures_graphs is False  # the CPU captures nothing


def test_build_server_single_replica_unchanged():
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, replicas=1, device="cpu")
    assert isinstance(bundle.server, MultiStreamServer) and bundle.replicas == 1


def test_build_server_fleet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(img=32, base=8, n_pix=1, n_yolo=1, replicas=2)


def test_online_cost_threaded_observe_is_consistent():
    """Concurrent observes from replica executor threads never lose
    updates: the EMA store is lock-guarded."""
    oc = OnlineCost()

    def feed():
        for _ in range(200):
            oc.observe("GPU", observed_s=2.0e-3, expected_s=1.0e-3)
            oc.scale("GPU")

    threads = [threading.Thread(target=feed) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert oc.scale("GPU") == pytest.approx(2.0, rel=1e-6) and "GPU" in oc.snapshot()


# ---- TwoModelPipeline ------------------------------------------------------------


def test_two_model_pipeline_matches_the_jax_pipeline(pairs, engines):
    """The paper's swap schedule over the serving pair: the port's
    pipeline logs the JAX pipeline's ticks (engine and work, frame by
    frame) and gives its outputs within the whole-model pin, widened by
    the JAX package's own eager-vs-jitted distance on each output."""
    jpair, tpair = pairs
    gpu, dla = engines
    jg, jd = jengines(constraints_dla=JDLA)
    jp = jcore.plan([m.graph for m in jpair], [jd, jg], kind="haxconn")
    tp = tplan([m.graph for m in tpair], [dla, gpu], kind="haxconn")
    assert tp.to_json() == jp.to_json()
    rs = np.random.RandomState(3)
    xs = [rs.randn(1, 32, 32, 3).astype(np.float32) for _ in range(3)]
    jpipe_ = jcore.TwoModelPipeline(*jpair, jp)
    tpipe_ = tpipe.TwoModelPipeline(*tpair, tp)
    ja, jb = jpipe_.run_stream([jnp.asarray(x) for x in xs], [jnp.asarray(x) for x in xs[::-1]])
    ta, tb = tpipe_.run_stream([torch.from_numpy(x) for x in xs], [torch.from_numpy(x) for x in xs[::-1]])
    assert [(e.tick, e.engine, e.work) for e in tpipe_.log] == [(e.tick, e.engine, e.work) for e in jpipe_.log]
    assert (tpipe_.pa, tpipe_.pb) == (jpipe_.pa, jpipe_.pb)
    # the JAX pipeline runs XLA's ops eagerly, which on YOLO's deep blocks
    # (batch norm over 1-4 pixels at img 32) differ from its jitted run_all
    # by more than the whole-model pin (2.6e-3 on one p4 here): hold each
    # output to the pin plus the reference's own eager-vs-jit distance
    for got, want, model, frames in ((ta, ja, jpair[0], xs), (tb, jb, jpair[1], xs[::-1])):
        assert len(got) == len(want) == 3
        for g, w, x in zip(got, want, frames):
            jit = jax.jit(model.run_all)(jnp.asarray(x))
            for a, e, j in zip(tree_leaves(g), jax.tree.leaves(w), jax.tree.leaves(jit)):
                e, j = np.asarray(e), np.asarray(j)
                tol = WHOLE_MODEL_PIN["atol"] + WHOLE_MODEL_PIN["rtol"] * np.abs(e) + np.abs(e - j)
                assert (np.abs(a.numpy() - e) <= tol).all(), float(np.abs(a.numpy() - e).max())
    # eager and placement-only: bit-exact against the model's own run_all
    for x, g in zip(xs, ta):
        assert torch.equal(g, tpair[0].run_all(torch.from_numpy(x)))


def test_two_model_pipeline_rebuilds_overridden_partitions(pairs, engines):
    _, tpair = pairs
    gpu, dla = engines
    pipe = tpipe.TwoModelPipeline(tpair[0], tpair[0], tplan([tpair[0].graph] * 2, [dla, gpu], kind="haxconn"))
    pipe.pa, pipe.pb = 2, 3
    x = torch.from_numpy(_frames(1, seed=4)["mri-0"][0])
    a, b = pipe.run_stream([x, x], [x, x])
    assert all(torch.equal(o, tpair[0].run_all(x)) for o in a + b)
    assert any("[0:2)" in e.work for e in pipe.log) and any("[3:" in e.work for e in pipe.log)


def test_submesh_placers_split_the_device_list():
    meta = torch.device("meta")
    con, flex = tpipe.submesh_placers([CPU, meta], 1)
    state = {"x": torch.ones(2)}
    assert con(state)["x"].device == CPU and flex(state)["x"].device.type == "meta"
    con, flex = tpipe.submesh_placers([meta], 0)  # an empty group takes the other's
    assert con(state)["x"].device.type == "meta" and flex(state)["x"].device.type == "meta"


# ---- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_card_fleet_bit_exact_with_replayed_graphs():
    """On the card: a 2-replica fleet over the fused kernels, each segment a
    replayed CUDA graph on its replica's own streams, serves every stream
    the single server's bits, and the kernel launches of the frames
    (summed over the replicas) are those of the single server, all
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels.fused import ops

    kw = dict(img=64, base=8, n_pix=2, n_yolo=1, impl="pallas", device="cuda", max_queue=8)
    outs, launches = {}, {}
    for key, extra in (("single", {}), ("fleet", {"replicas": 2})):
        bundle = build_server(**kw, **extra)
        srv = bundle.server
        for s in bundle.streams:  # warm-up: the captures
            srv.offer(s.name, bundle.frame_for(s.name, 99))
        srv.drain()
        torch.cuda.synchronize()
        ops.reset_launches()
        kernels.reset_graph_launches()
        for t in range(3):
            for s in bundle.streams:
                srv.offer(s.name, bundle.frame_for(s.name, t))
            srv.tick()
        outs[key] = {n: v[-3:] for n, v in srv.drain().items()}
        torch.cuda.synchronize()
        assert not any(ops.launches.values())
        launches[key] = dict(kernels.graph_launches)
    assert launches["fleet"] == launches["single"] and launches["single"]["sppf_pyramid"] == 3
    _same(outs["fleet"], outs["single"])
