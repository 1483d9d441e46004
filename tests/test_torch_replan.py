"""The port's online re-planner against the JAX package's.

The deterministic cases of ``tests/test_replan.py``: one drift sequence of
synthetic profiled ticks goes through the port's ``Replanner`` and the JAX
one, which must fire on the same ticks, swap to the same ``PlanIR`` JSON
and stay quiet on the same noise (host arithmetic: exact). On the port's
executor, a hot swap (by hand, by the re-planner in the foreground and in
a background thread) drops no frame, keeps per-stream FIFO order and keeps
the outputs bit-exact against an unswapped run.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core.api import plan as jplan  # noqa: E402
from repro.core.engine import EngineSpec as JEngine  # noqa: E402
from repro.core.graph import LayerGraph as JGraph, pointwise_meta as jmeta  # noqa: E402
from repro.core.pipeline import StagedModel as JStaged  # noqa: E402
from repro.serve import ReplanConfig as JConfig, Replanner as JReplanner  # noqa: E402
from repro.serve import StreamExecutor as JExecutor, StreamSpec as JSpec  # noqa: E402
from repro.serve.executor import SegmentObservation as JObs  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.engine import EngineSpec as TEngine  # noqa: E402
from repro_torch.core.graph import LayerGraph as TGraph, pointwise_meta as tmeta  # noqa: E402
from repro_torch.core.pipeline import StagedModel as TStaged  # noqa: E402
from repro_torch.core.plan_ir import make_plan_ir  # noqa: E402
from repro_torch.serve import ReplanConfig, Replanner, StreamExecutor, StreamSpec, build_server  # noqa: E402
from repro_torch.serve.executor import SegmentObservation  # noqa: E402

PORT = dict(Staged=TStaged, Graph=TGraph, meta=tmeta, Engine=TEngine, plan=tplan, Config=ReplanConfig,
            Replanner=Replanner, Executor=StreamExecutor, Spec=StreamSpec, Obs=SegmentObservation,
            step=lambda s: {"x": s["x"] * 1.5 + 0.5})
JAX = dict(Staged=JStaged, Graph=JGraph, meta=jmeta, Engine=JEngine, plan=jplan, Config=JConfig,
           Replanner=JReplanner, Executor=JExecutor, Spec=JSpec, Obs=JObs,
           step=lambda s: {"x": s["x"] * 1.5 + 0.5})


# the host cost per layer the end-to-end re-planning test reports for every
# profiled span, beside the stall it injects
HOST_S_PER_LAYER = 1e-4


def _toy(pkg, n_layers=8, name="toy", flops=1e9):
    ops = [(f"mul{i}", lambda p, s, f=pkg["step"]: f(s)) for i in range(n_layers)]
    graph = pkg["Graph"](
        name,
        [pkg["meta"](i, f"mul{i}", "act", (1, 64), flops_per_elem=flops / 64) for i in range(n_layers)],
    ).renumber()
    return pkg["Staged"](name=name, ops=ops, params=None, graph=graph, init_state=lambda x: {"x": x},
                         finalize=lambda s: s["x"])


def _engines(pkg):
    return [pkg["Engine"]("E0", 1, 1.0e12, 500e9, 50e9, ()), pkg["Engine"]("E1", 1, 1.0e12, 500e9, 50e9, ())]


def _serving(pkg, **cfg):
    sm = _toy(pkg)
    engines = _engines(pkg)
    ir = pkg["plan"]([sm.graph], engines)
    rp = pkg["Replanner"]([sm.graph], engines, pkg["Config"](**cfg))
    ex = pkg["Executor"]([sm], ir, [pkg["Spec"]("s0", 0)], max_queue=8)
    return ir, rp, ex


def _feed(pkg, rp, ex, walls):
    """One synthetic profiled tick ({engine: wall as a multiple of the
    span's expected base cost}), then the frame-boundary hook."""
    for eng, mult in walls.items():
        seg = ex.plan.route(0)[eng]
        wall = mult * rp._expected_base(0, seg.engine, seg.lo, seg.hi)
        rp.observe(pkg["Obs"](tick=ex.tick_count, model_index=0, stage=seg.stage, engine=seg.engine,
                              lo=seg.lo, hi=seg.hi, wall_s=wall, batch=1, revision=ex.plan_revision))
    return rp.maybe_replan(ex)


def _event(ev):
    return None if ev is None else (ev.tick, ev.drift, ev.old_partitions, ev.new_partitions, ev.old_cycle,
                                    ev.new_cycle, ev.swapped, ev.revision, ev.old_cuts, ev.new_cuts,
                                    ev.partial, ev.trigger)


SKEW = [{0: 100, 1: 100}] * 4 + [{0: 400, 1: 100}] * 4
NOISE = [{0: 100, 1: 100}] * 4 + ([{0: 400, 1: 100}] + [{0: 100, 1: 100}] * 3) * 5


@pytest.mark.parametrize(
    "sequence,cfg,fires",
    [
        (SKEW, dict(drift_threshold=0.5, hysteresis=3, cooldown_ticks=2, warmup_obs=2, min_improvement=0.01), 1),
        (NOISE, dict(drift_threshold=0.5, hysteresis=3, cooldown_ticks=2, warmup_obs=2, ema_alpha=0.5), 0),
        (SKEW + [{0: 100, 1: 400}] * 6,
         dict(drift_threshold=0.5, hysteresis=2, cooldown_ticks=1, warmup_obs=2, min_improvement=0.01), 2),
    ],
    ids=["sustained-skew", "transient-noise", "skew-then-reverse"],
)
def test_drift_sequence_matches_jax(sequence, cfg, fires):
    """Same ticks fed to both re-planners: the same events on the same
    ticks, the same swapped plan JSON and the same summary scales."""
    runs = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        ir, rp, ex = _serving(pkg, **cfg)
        evs = []
        for walls in sequence:
            evs.append(_event(_feed(pkg, rp, ex, walls)))
            ex.tick_count += 1  # the frame boundary the executor's tick would pass
        runs[name] = (ir, rp, ex, evs)
    (jir, jrp, jex, jevs), (tir, trp, tex, tevs) = runs["jax"], runs["port"]
    assert tir.to_json() == (jir.ir if hasattr(jir, "ir") else jir).to_json()
    assert tevs == jevs
    assert sum(e is not None and e[6] for e in tevs) == fires
    assert tex.plan.to_json() == jex.plan.to_json()
    assert trp.online.snapshot() == jrp.online.snapshot()
    assert trp.drift() == jrp.drift()
    if fires == 1:
        # the new plan puts less work on the slowed engine
        assert sum(s.hi - s.lo for s in tex.plan.engine_spans(0)) < sum(
            s.hi - s.lo for s in tir.engine_spans(0))


def _frames(streams, n=4):
    return {s.name: [torch.full((1, 64), float(3 * i + t)) for t in range(n)] for i, s in enumerate(streams)}


@pytest.mark.parametrize("jit_segments", [True, False])
def test_hot_swap_mid_stream_preserves_order_and_outputs(jit_segments):
    """Swap with frames in flight: zero drops, per-stream FIFO order,
    outputs bit-exact against the unswapped run, in-flight frames on the
    route they were admitted under."""
    sm = _toy(PORT, n_layers=6)
    ir_a = make_plan_ir((sm.name,), ("E0", "E1"), [[(0, 0, 3), (1, 3, 6)]])
    ir_b = make_plan_ir((sm.name,), ("E0", "E1"), [[(0, 0, 1), (1, 1, 6)]])
    streams = [StreamSpec("s0", 0), StreamSpec("s1", 0)]
    frames = _frames(streams)

    def run(swap_at=None):
        ex = StreamExecutor([sm], ir_a, streams, max_queue=8, jit_segments=jit_segments)
        for t in range(4):
            for i, s in enumerate(streams):
                assert ex.submit(i, frames[s.name][t])
        ticks = 0
        while ex.pending:
            if swap_at is not None and ticks == swap_at:
                assert ex.in_flight
                assert ex.prepare_plan(ir_b) == 2
                ex.swap_plan(ir_b)
            ex.tick()
            ticks += 1
        return ex

    plain, swapped = run(), run(swap_at=2)
    assert swapped.plan_revision == 1 and [e.revision for e in swapped.swap_events] == [1]
    for s in streams:
        assert len(swapped.outputs[s.name]) == 4
        for a, b in zip(plain.outputs[s.name], swapped.outputs[s.name]):
            assert torch.equal(a, b)
        fids = [c.frame_id for c in swapped.completions if c.stream == s.name]
        assert fids == sorted(fids)
    spans = [e.work.split("[")[1].split(")")[0] for e in swapped.log if "[" in e.work]
    assert "3:6" in spans and "1:6" in spans


@pytest.mark.parametrize("background", [False, True])
def test_replan_loop_end_to_end_recovers_partitions(background):
    """Real executor ticks: a sustained injected stall on one engine makes
    the re-planner swap layers off it (planned in a worker thread when
    ``background``), with zero dropped frames and FIFO order. The
    re-planner reads each profiled span as a fixed host cost per layer plus
    the stall injected there: what it reacts to is the stall, not the
    host's timing of near-empty spans, whose noise a loaded CPU makes as
    large as the stall (a swap before the stall, or one after it that
    answered noise, then moved layers onto the stalled engine)."""
    sm = _toy(PORT, n_layers=10, name="toy10")
    engines = _engines(PORT)
    ir = tplan([sm.graph], engines)
    pert = {"on": False}

    def stall(engine, lo, hi):
        return 5e-3 * (hi - lo) if pert["on"] and engine == 1 else 0.0

    def delay(seg):
        return stall(seg.engine, seg.lo, seg.hi)

    cfg = ReplanConfig(drift_threshold=1.0, hysteresis=2, cooldown_ticks=4, profile_every=1,
                       ema_alpha=0.5, min_improvement=0.01, background=background)
    rp = Replanner([sm.graph], engines, cfg)
    ex = StreamExecutor([sm], ir, [StreamSpec("s0", 0)], max_queue=8, segment_delay_fn=delay)
    rp.attach(ex)
    ex.on_segment = lambda obs: rp.observe(dataclasses.replace(
        obs, wall_s=HOST_S_PER_LAYER * (obs.hi - obs.lo) + stall(obs.engine, obs.lo, obs.hi)))
    assert not ex.captures_graphs  # on the CPU the worker also warms the plan
    swapped_to = []
    real_swap = ex.swap_plan
    ex.swap_plan = lambda new_ir: swapped_to.append((pert["on"], new_ir)) or real_swap(new_ir)
    submitted = 0

    def window(n, seed):
        nonlocal submitted
        for t in range(n):
            assert ex.submit(0, torch.ones((1, 64)) * (seed + t))
            ex.tick()
            submitted += 1
        ex.run_until_drained()

    window(10, 0)
    rp.calibrate()
    window(6, 100)
    pert["on"] = True
    window(30, 200)
    assert any(e.swapped for e in rp.events), rp.summary()
    # the first swap after the stall starts answers it: work moves off the
    # stalled engine
    first = next(new_ir for on, new_ir in swapped_to if on)
    assert sum(s.hi - s.lo for s in first.engine_spans(1)) < sum(s.hi - s.lo for s in ir.engine_spans(1))
    assert len(ex.completions) == submitted == len(ex.outputs["s0"])
    fids = [c.frame_id for c in ex.completions]
    assert fids == sorted(fids)
    stalls = rp.summary()["swap_stall"]
    assert stalls["swaps"] >= 1 and stalls["background_prepares"] == (stalls["swaps"] if background else 0)


def test_replanner_summary_and_config_validation():
    ir, rp, ex = _serving(PORT)
    rp.attach(ex)
    s = rp.summary()
    assert s["replans"] == 0 and s["swaps"] == 0 and not s["calibrated"]
    assert ex.profile_every == rp.config.profile_every and ex.on_tick == rp.maybe_replan
    with pytest.raises(ValueError):
        Replanner([_toy(PORT).graph], _engines(PORT)[:1]).attach(ex)  # engine count mismatch


def test_build_server_replan_reports_and_warm_starts(tmp_path):
    """``build_server(replan=...)`` wires the re-planner into the server's
    report; a calibration file warm-starts its drift baseline."""
    from repro_torch.core.cost_model import ANALYTIC, OnlineCost

    path = str(tmp_path / "calib.json")
    seed = OnlineCost(ANALYTIC)
    for e in ("DLA", "GPU"):
        seed.observe(e, 2e-3, 1e-3)
    seed.save_calibration(path)
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, device="cpu",
                          replan=ReplanConfig(profile_every=1), calibration_path=path)
    rp = bundle.replanner
    assert rp is bundle.server.replanner and rp.calibrated
    assert rp.online.snapshot() == {"DLA": 2.0, "GPU": 2.0}
    for t in range(2):
        for s in bundle.streams:
            bundle.server.submit(s.model_index, bundle.frame_for(s.name, t))
    bundle.server.drain()
    rep = bundle.report()
    assert rep["replan"]["observations"] > 0 and rep["segments"]
    assert rep["frames"] == 4


def test_build_server_foreign_calibration_warns_and_calibrates_live(tmp_path):
    """A calibration learned over another base provider is in other units:
    ``build_server`` warns, loads nothing and the re-planner calibrates
    live."""
    from repro_torch.core.cost_model import OnlineCost, make_cost_provider

    path = str(tmp_path / "calib.json")
    seed = OnlineCost(make_cost_provider("blended"))
    for e in ("DLA", "GPU"):
        seed.observe(e, 2e-3, 1e-3)
    seed.save_calibration(path)
    with pytest.warns(UserWarning, match="not applicable, re-calibrating"):
        bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, device="cpu",
                              replan=ReplanConfig(profile_every=1), calibration_path=path)
    assert bundle.replanner.online.snapshot() == {} and not bundle.replanner.calibrated
