"""The port's multi-process fleet (``repro_torch.serve.multiproc``) against
the JAX package.

Mirrors the fast tier of ``tests/test_multiproc.py``. Pins: the
shared-memory ring round-trips frames (torch tensors included) bit for bit
and falls back to the pipe for oversized ones; ``merge_calibration`` equals
the JAX merge on the same states; the metrics payload round-trips exactly
and equals the JAX payload for the same records; router eviction;
``build_server``'s fleet rejections; the kernel libraries are
built in the front and required in a worker; one module-scoped 2-worker
CPU fleet serves every stream bit for bit what the in-process server
serves (the module runs on one intra-op thread, as a CPU worker does: the
bits of torch's CPU convolutions depend on the thread count), merges the workers' reports and returns
each worker's launch counters; a worker killed mid-run is evicted and its
streams are served by the survivor; a worker whose build fails makes the
fleet raise. Small sizes (img 32, base 8); the goodput comparisons run on
the card (``chip_smoke.py``), not as CPU timing assertions.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import merge_calibration as jmerge  # noqa: E402
from repro.serve.metrics import ServeMetrics as JMetrics, TickStats as JTick  # noqa: E402
from repro.serve.traffic import SLOPolicy as JSLO  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.cost_model import OnlineCost, make_cost_provider  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig,
    FleetRouter,
    ProcFleetServer,
    ShmRing,
    StreamSpec,
    WorkerError,
    build_server,
    merge_calibration,
    metrics_from_payload,
)
from repro_torch.serve import multiproc  # noqa: E402
from repro_torch.serve.demo import _build_pix_yolo_models  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics, TickStats  # noqa: E402
from repro_torch.serve.multiproc import _decode_frame, _encode_frame  # noqa: E402
from repro_torch.serve.traffic import SLOPolicy  # noqa: E402

# ---- shared-memory ring -----------------------------------------------------


def test_shm_ring_roundtrip_and_slot_reuse():
    ring = ShmRing(4 * 8 * 8 * 3, slots=2)
    try:
        view = ShmRing(ring.slot_bytes, ring.slots, name=ring.name)  # worker side
        rng = np.random.default_rng(0)
        # 5 puts over 2 slots: round-robin reuse must never corrupt a frame
        # read before the next put lands in its slot; tensors cross as their
        # host bits
        for t in range(5):
            a = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
            desc = _encode_frame(torch.from_numpy(a) if t % 2 else a, ring)
            assert desc["via"] == "shm"
            np.testing.assert_array_equal(_decode_frame(desc, view), a)
        view.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_pipe_fallback_for_oversized_frames():
    ring = ShmRing(4 * 8 * 8 * 3, slots=2)
    try:
        big = np.ones((2, 8, 8, 3), np.float32)  # 2x the slot size
        desc = _encode_frame(torch.from_numpy(big), ring)
        assert desc["via"] == "pipe" and isinstance(desc["array"], np.ndarray)
        np.testing.assert_array_equal(_decode_frame(desc, ring), big)
        with pytest.raises(ValueError):
            ring.put(big)
        with pytest.raises(WorkerError):
            _decode_frame({"via": "shm", "slot": 0, "shape": [1], "dtype": "float32"}, None)
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_validates_inputs():
    with pytest.raises(ValueError):
        ShmRing(0, slots=2)
    with pytest.raises(ValueError):
        ShmRing(16, slots=0)


def test_drained_outputs_cross_shared_memory_bit_for_bit():
    """A worker's drained outputs (tensors and YOLO's dicts of them) cross
    in one shared-memory block, which the front copies out and unlinks; an
    empty drain needs none."""
    from multiprocessing import shared_memory

    outs = {
        "mri-0": [torch.randn(1, 8, 8, 3), torch.randn(2, 8, 8, 3)[::2]],
        "det-0": [{"p3": torch.randn(1, 4, 4, 66), "p4": torch.randn(1, 2, 2, 66), "p5": torch.randn(1, 1, 1, 66)}],
        "mri-1": [],
    }
    payload = multiproc._ship_outputs(outs)
    assert payload["shm"] is not None
    back = multiproc._receive_outputs(payload)
    assert back.keys() == outs.keys() and back["mri-1"] == []
    for name in outs:
        for a, b in zip(outs[name], back[name]):
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert set(back["det-0"][0]) == {"p3", "p4", "p5"}
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=payload["shm"])
    assert multiproc._ship_outputs({"mri-0": []})["shm"] is None


# ---- calibration merge + OnlineCost state -----------------------------------


def _random_states(seed, n):
    rs = np.random.RandomState(seed)
    keys = ["GPU|xla", "DLA|xla", "GPU|pallas_fused", "DLA|pallas_fused"]
    out = []
    for _ in range(n):
        st = {}
        for k in keys:
            if rs.rand() < 0.7:
                num, den = rs.rand() * [1.0, 0.0, -1.0][rs.randint(3)], rs.rand() * 2.0
                st[k] = {"num": float(num), "den": float(den)}
        out.append(st)
    return out


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 3), (2, 5), (3, 1)])
def test_merge_calibration_equals_the_jax_merge(seed, n):
    states = _random_states(seed, n)
    assert merge_calibration(states) == jmerge(states)


def test_merge_calibration_is_magnitude_weighted():
    heavy = {"GPU|xla": {"num": 20.0, "den": 10.0}}  # scale 2.0, big mass
    light = {"GPU|xla": {"num": 1.0, "den": 1.0}}  # scale 1.0, small mass
    m = merge_calibration([heavy, light])
    assert m["GPU|xla"]["num"] / m["GPU|xla"]["den"] == pytest.approx(21.0 / 11.0)
    again = merge_calibration([m, m])  # a push/pull/push cycle is a fixed point
    assert again["GPU|xla"] == pytest.approx(m["GPU|xla"])
    assert set(merge_calibration([{"GPU|xla": {"num": 0.0, "den": 1.0}}, {"DLA|xla": {"num": 2.0, "den": 1.0}}, {}])) == {
        "DLA|xla"
    }


def test_save_calibration_atomic_under_concurrent_writers(tmp_path):
    """Threads checkpointing one path concurrently (the fleet's periodic
    sync against an exit save) never leave a torn file."""
    path = str(tmp_path / "calib.json")
    stop, errors = threading.Event(), []

    def writer(k):
        oc = OnlineCost()
        oc.observe("GPU", observed_s=(k + 2) * 1e-3, expected_s=1e-3)
        for _ in range(12):
            oc.save_calibration(path)

    def reader():
        while not stop.is_set():
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        payload = json.load(f)
                    assert payload["version"] == 1 and payload["engines"]
                except (json.JSONDecodeError, AssertionError) as e:
                    errors.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    observer = threading.Thread(target=reader)
    observer.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    observer.join()
    assert not errors, errors[:3]
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    assert OnlineCost().load_calibration(path).calibrated


# ---- metrics payload round-trip ---------------------------------------------


def _record(metrics_cls, slo_cls, tick_cls):
    m = metrics_cls(
        ["mri-0", "det-0"],
        slos={"mri-0": slo_cls(deadline_ms=50.0, tier=1, name="r"), "det-0": slo_cls(deadline_ms=30.0, tier=0, name="d")},
        recent_window=8,
    )
    for name, lat in (("mri-0", 0.01), ("mri-0", 0.2), ("det-0", 0.005)):
        m.record_arrival(name)
        m.record_admission(name, "admit")
        m.record(name, lat)
    m.record_admission("det-0", "drop")
    m.record_tick(tick_cls(0, 0.02, 0.01, 3))
    return m


def test_metrics_payload_roundtrip_exact_and_equal_to_the_jax_payload():
    m = _record(ServeMetrics, SLOPolicy, TickStats)
    r = metrics_from_payload(m.to_payload())
    assert r.report(1.0) == m.report(1.0)
    assert r.recent_slo_miss_rate() == m.recent_slo_miss_rate() and r._recent.maxlen == m._recent.maxlen
    assert m.to_payload() == _record(JMetrics, JSLO, JTick).to_payload()


# ---- router eviction --------------------------------------------------------


def test_router_evict_unpins_streams_and_excludes_replica():
    r = FleetRouter(2, seed=0)
    first = r.route_arrival("mri-0", [0, 0], deadline_s=0.05)
    other = 1 - first
    assert r.evict(first) == ["mri-0"] and r.alive == [other] and r.replica_of("mri-0") is None
    loads = [0, 0]
    loads[other] = 100
    assert r.route_arrival("mri-0", loads, deadline_s=0.05) == other  # the survivor, however loaded
    assert r.evict(first) == []  # idempotent
    summ = r.summary()
    assert summ["alive"] == [other] and summ["evicted"] == [first]
    r.evict(other)
    with pytest.raises(RuntimeError):
        r.pick([0, 0])


# ---- facade and constructor validation --------------------------------------


def test_build_server_rejects_workers_with_replicas():
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_server(img=32, n_pix=1, workers=2, replicas=2, device="cpu")


def test_build_server_rejects_provider_instance_for_workers():
    with pytest.raises(ValueError, match="name"):
        build_server(img=32, n_pix=1, workers=2, cost=make_cost_provider("analytic"), device="cpu")


def test_build_server_workers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(img=32, base=8, n_pix=1, n_yolo=1, workers=1)


@pytest.fixture(scope="module")
def plan_streams():
    models, _, (gpu, dla) = _build_pix_yolo_models(img=32, base=8, n_pix=1, n_yolo=1)
    return tplan([m.graph for m in models], [dla, gpu]), [StreamSpec("mri-0", 0), StreamSpec("det-0", 1)]


def test_proc_fleet_rejects_unserializable_knobs(plan_streams, monkeypatch):
    plan, streams = plan_streams
    with pytest.raises(ValueError, match="cost provider name"):
        ProcFleetServer(plan, streams, workers=1, cost="bogus")
    with pytest.raises(ValueError, match="degrade_frame"):
        ProcFleetServer(plan, streams, workers=1, admission=AdmissionConfig(degrade_frame=lambda f: f))
    with pytest.raises(ValueError, match="workers"):
        ProcFleetServer(plan, streams, workers=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcFleetServer(plan, streams, workers=1)  # no device named: the card


def test_kernel_libraries_are_built_in_the_front_and_required_in_a_worker(plan_streams, monkeypatch):
    """A plan bound ``pallas_fused`` on a card needs the fused kernels'
    library: the front builds it before spawning, a worker only checks it
    is there (it never runs nvcc) and fails without it. The CPU needs
    none."""
    from repro_torch.kernels.fused import kernel

    _, streams = plan_streams
    models, _, (gpu, dla) = _build_pix_yolo_models(img=32, base=8, n_pix=1, n_yolo=1)
    fused = tplan([m.graph for m in models], [dla, gpu], impl="pallas")
    xla = tplan([m.graph for m in models], [dla, gpu])
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    built = []
    monkeypatch.setattr(kernel, "build", lambda: built.append(1))
    monkeypatch.setattr(kernel, "built", lambda: False)
    for plan, device in ((xla, cuda), (fused, cpu)):
        multiproc._prebuild(plan, device)
        multiproc._require_built(plan, device)
    assert built == []
    multiproc._prebuild(fused, cuda)
    assert built == [1]
    with pytest.raises(RuntimeError, match="not built"):
        multiproc._require_built(fused, cuda)
    monkeypatch.setattr(kernel, "built", lambda: True)
    multiproc._require_built(fused, cuda)


# ---- 2-worker CPU fleet: bit-exactness, reports, failures --------------------

_PROC_KW = dict(img=32, base=8, n_pix=2, n_yolo=1, seed=0, max_queue=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The in-process references on one intra-op thread, as a CPU worker
    computes (the bits of torch's CPU convolutions depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def proc_fleet_outputs():
    """One 2-worker fleet session shared by the tests below (the spawn is
    paid once), against the in-process server fed the same frames."""
    ref = build_server(**_PROC_KW)
    fleet = build_server(**_PROC_KW, workers=2)
    frames = {s.name: [ref.frame_for(s.name, t) for t in range(3)] for s in ref.streams}
    for t in range(3):
        for s in ref.streams:
            ref.server.offer(s.name, frames[s.name][t])
            fleet.server.offer(s.name, frames[s.name][t])
    out_ref = ref.server.drain()
    out_fleet = fleet.server.drain()
    report = fleet.server.report()
    counters = fleet.server.counters()
    yield fleet, out_ref, out_fleet, report, counters
    fleet.close()


def test_proc_fleet_bit_exact_vs_in_process(proc_fleet_outputs):
    """Per-stream outputs of a 2-worker fleet are bit-exact against one
    in-process server fed the same arrivals: the workers rebuild the
    models from the same seeded generators on the same device and the plan
    from its JSON, routing is sticky per stream, and frames cross the
    shared-memory ring bit for bit."""
    _, out_ref, out_fleet, _, _ = proc_fleet_outputs
    assert set(out_ref) == set(out_fleet)
    for name in out_ref:
        assert len(out_fleet[name]) == len(out_ref[name]) == 3
        for a, b in zip(out_ref[name], out_fleet[name]):
            for la, lb in zip(tree_leaves(a), tree_leaves(b)):
                assert lb.device.type == "cpu" and torch.equal(la, lb)


def test_proc_fleet_report_merges_worker_ledgers(proc_fleet_outputs):
    fleet, _, _, rep, counters = proc_fleet_outputs
    assert rep["workers"] == 2 and rep["alive_workers"] == [0, 1]
    assert rep["frames"] == 9  # 3 streams x 3 frames
    assert rep["frames"] == sum(r["frames"] for r in rep["per_worker"])
    assert sum(rep["router"]["routed_frames"]) == 9 and rep["worker_failures"] == []
    assert set(fleet.server.router.assignments) == {s.name for s in fleet.streams}
    assert fleet.server.executor.captures_graphs is False and fleet.server.executor.pending == 0
    # the CPU launches no kernel; each worker ran the plan's spans, warm-up
    # frames included, and holds a runner of each
    assert rep["launches"] == {"outside": counters["launches"], "replayed": counters["graph_launches"]}
    assert all(r["launches"]["outside"] == counters["per_worker"][w]["launches"] for w, r in enumerate(rep["per_worker"]))
    assert set(counters["per_worker"]) == {0, 1}
    assert not any(counters["launches"].values()) and not any(counters["graph_launches"].values())
    spans = [sorted((s.lo, s.hi, s.impl) for s in segs) for segs in fleet.plan.segments]
    for c in counters["per_worker"].values():
        assert c["device"] == "cpu" and c["captured_graphs"] == [0, 0]
        assert [[tuple(k) for k in r] for r in c["graph_runners"]] == spans


def test_proc_fleet_evicts_killed_worker_and_reroutes():
    """A worker killed mid-session is detected on its next RPC, evicted
    from routing, its sticky streams migrate to the survivor and are
    served there, and the failure is ledgered in the fleet report."""
    fleet = build_server(**_PROC_KW, workers=2)
    try:
        server = fleet.server
        for s in fleet.streams:  # establish sticky assignments
            server.offer(s.name, fleet.frame_for(s.name, 0))
        server.drain()
        victim = 1
        victim_streams = sorted(n for n, w in server.router.assignments.items() if w == victim)
        assert victim_streams, "router left worker 1 idle; test premise broken"
        proc = server.handles[victim].process
        proc.kill()
        proc.join(timeout=10.0)
        assert not proc.is_alive()
        for t in range(1, 3):
            for s in fleet.streams:
                server.offer(s.name, fleet.frame_for(s.name, t))
        outs = server.drain()
        ref = build_server(**_PROC_KW)
        for name in victim_streams:
            assert len(outs[name]) == 2  # both frames after the kill, served by the survivor
            model = ref.models[next(s.model_index for s in ref.streams if s.name == name)]
            for t, got in enumerate(outs[name], start=1):
                want = model.run_all(ref.frame_for(name, t))
                assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        rep = server.report()
        assert rep["alive_workers"] == [0] and server.router.summary()["evicted"] == [victim]
        (failure,) = [f for f in rep["worker_failures"] if f["worker"] == victim]
        assert failure["migrated_streams"] == victim_streams and failure["reason"].startswith("offer")
        assert set(server.router.assignments.values()) == {0}
    finally:
        fleet.close()
    assert all(h.process is None for h in fleet.server.handles)  # every worker stopped


def test_worker_build_failure_makes_the_fleet_raise(plan_streams):
    """No fallback: a worker that cannot build its replica group fails its
    ready handshake with the error, and the fleet raises rather than serve
    with fewer workers."""
    plan, streams = plan_streams
    with pytest.raises(WorkerError, match="worker build failed: .*norm"):
        ProcFleetServer(plan, streams, workers=1, build={"img": 32, "base": 8, "n_pix": 1, "n_yolo": 1,
                                                         "norm": "no-such-norm", "device": "cpu"})


@pytest.mark.cuda
def test_card_workers_bit_exact_with_their_launches():
    """On the card: 2 worker processes, each capturing its graphs in its
    warm-up, serve every stream the in-process server's bits, and their
    summed launch counters equal the in-process server's, all replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels.fused import ops

    kw = dict(img=64, base=8, n_pix=2, n_yolo=1, impl="pallas", device="cuda", max_queue=8)
    ref = build_server(**kw)
    for s in ref.streams:
        ref.server.offer(s.name, ref.frame_for(s.name, 99))
    ref.server.drain()
    torch.cuda.synchronize()
    ops.reset_launches()
    kernels.reset_graph_launches()
    with build_server(**kw, workers=2) as fleet:
        fleet.server.reset_counters()
        for srv in (ref.server, fleet.server):
            for t in range(3):
                for s in ref.streams:
                    srv.offer(s.name, ref.frame_for(s.name, t))
                srv.tick()
        want, got = ref.server.drain(), fleet.server.drain()
        torch.cuda.synchronize()
        c = fleet.server.counters()
    assert c["graph_launches"] == dict(kernels.graph_launches) and not any(c["launches"].values())
    for name in want:
        assert len(got[name]) == 3
        for a, b in zip(want[name][-3:], got[name]):
            assert all(torch.equal(x.cpu(), y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
