"""The port's launchers (``repro_torch.launch``) on the CPU.

Pins: ``launch.serve.main`` in streams mode plans the same ``PlanIR`` JSON
as the JAX package's serving facade (``repro.serve.build_server``, which
``repro.launch.serve`` calls) for the same arguments — analytic, pallas,
auto and measured (over one timing cache) — and serves every stream's
frames; ``--cost online --replan`` persists and warm-starts its
calibration; open-loop traffic runs; ``--mode lm`` generates what
``greedy_generate`` does on the Hymba smoke config, and by default on
gemma2-2b's; ``--replicas`` and ``--workers`` serve through the fleets;
``launch.analytic.graph_cost_rows`` gives the JAX rows under the analytic
provider.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as JDLA  # noqa: E402
from repro.core.cost_model import MeasuredCost as JMeasured  # noqa: E402
from repro.core.engine import jetson_orin_engines as jengines  # noqa: E402
from repro.launch.analytic import graph_cost_rows as jrows  # noqa: E402
import repro.models as jm  # noqa: E402
from repro.core.api import plan as jplan  # noqa: E402
from repro_torch.configs import build_model, get_arch  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as TDLA  # noqa: E402
from repro_torch.core.engine import jetson_orin_engines as tengines  # noqa: E402
from repro_torch.launch import analytic, serve  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.train.steps import greedy_generate  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once on the
    machine's cores, and with as many threads as cores in each file too,
    this file's small ops ran many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = ["--mode", "streams", "--device", "cpu", "--img", "32", "--base", "8", "--streams", "2",
         "--yolo-streams", "1", "--frames", "2"]


def _jax_facade_plan(img, base, n_pix, n_yolo, norm, cost, impl, granularity, stride, max_cuts):
    """The plan ``repro.serve.build_server`` (and so ``repro.launch.serve``)
    makes for these arguments: its graphs (expanded at fine granularity,
    as its staged models are), its engine order and its planner call —
    without drawing the JAX parameters the plan does not read."""
    gpu, dla = jengines(constraints_dla=JDLA)
    graphs = [
        jm.Pix2PixGenerator(jm.Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping", norm=norm)).layer_graph(),
        jm.YOLOv8(jm.YOLOv8Config(img_size=img)).layer_graph(),
    ]
    if granularity == "fine":
        graphs = [g.expand() for g in graphs]
    return jplan(graphs, [dla, gpu], search="auto", stride=stride, max_cuts=max_cuts, cost=cost, impl=impl)


@pytest.mark.parametrize(
    "flags",
    [
        [],
        ["--impl", "pallas"],
        ["--impl", "auto", "--max-cuts", "2"],
        ["--impl", "auto", "--granularity", "fine", "--planner-stride", "2"],
        ["--cost", "measured", "--impl", "auto"],
        ["--no-jit-segments", "--dispatch", "serialized", "--norm", "instance", "--max-batch", "2"],
    ],
    ids=["analytic", "pallas", "auto-2cuts", "auto-fine", "measured", "eager-batched"],
)
def test_streams_main_plans_like_the_jax_facade_and_serves(tmp_path, capsys, flags):
    cache = str(tmp_path / "timings.json")
    kw = dict(img=32, base=8, n_pix=2, n_yolo=1)
    opt = dict(zip(flags[::2], flags[1::2])) if "--no-jit-segments" not in flags else {}
    jkw = dict(
        cost="analytic", impl=opt.get("--impl", "xla"), granularity=opt.get("--granularity", "coarse"),
        stride=int(opt.get("--planner-stride", 1)), max_cuts=int(opt.get("--max-cuts", 1)),
        norm="instance" if "--norm" in flags else "batch",
    )
    if "--cost" in flags:
        # one timing cache for both packages: the JAX planner counts and
        # writes it, the launcher plans from it without counting
        jkw["cost"] = JMeasured(cache_path=cache)
        flags = flags + ["--cost-cache", cache]
    want = _jax_facade_plan(**kw, **jkw)
    if "--cost" in flags:
        jkw["cost"].save()
    bundle = serve.main(SMALL + flags)
    assert bundle.plan.to_json() == want.to_json()
    out = capsys.readouterr().out
    assert "[serve] plan cuts=" in out
    rep = json.loads(out[out.index("{\n"):])
    assert rep["frames"] == 6
    assert {n: s["completed"] for n, s in rep["per_stream"].items()} == {"mri-0": 2, "mri-1": 2, "det-0": 2}
    ex = bundle.server.executor
    assert ex.jit_segments is ("--no-jit-segments" not in flags) and not ex.captures_graphs
    for name, outs in ex.outputs.items():
        assert len(outs) == 2
        for o in outs:
            for t in o.values() if isinstance(o, dict) else [o]:
                assert torch.isfinite(t).all()
    if "--cost" in flags:
        assert bundle.provider.measure_count == 0 and bundle.provider.hits > 0


def test_streams_online_replan_persists_calibration(tmp_path, capsys):
    calib = str(tmp_path / "calib.json")
    argv = SMALL + ["--frames", "6", "--cost", "online", "--replan", "--profile-every", "1",
                    "--calibration-cache", calib]
    bundle = serve.main(argv)
    assert bundle.replanner is not None and bundle.replanner.online is bundle.provider
    assert "[serve] saved calibration" in capsys.readouterr().out
    saved = json.load(open(calib))
    assert saved["base"] == "blended" and set(saved["engines"]) >= {"DLA", "GPU"}
    again = serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] warm-started calibration: online(blended;" in out
    assert again.replanner.calibrated  # the baseline came from the file
    assert json.loads(out[out.index("{\n"):])["replan"]["calibrated"]


@pytest.mark.parametrize("base", ["analytic", "blended"])
def test_streams_replan_warm_start_goes_through_build_server(tmp_path, capsys, base):
    """``--cost analytic --replan``: the re-planner's own ``OnlineCost`` is
    warm-started by ``build_server(calibration_path=)`` from a calibration
    learned over the same base provider; one learned over another base
    warns and the re-planner calibrates live."""
    from repro_torch.core.cost_model import OnlineCost, make_cost_provider

    calib = str(tmp_path / "calib.json")
    seed = OnlineCost(make_cost_provider(base))
    for e in ("DLA", "GPU"):
        seed.observe(e, 2e-3, 1e-3)
    seed.save_calibration(calib)
    argv = SMALL + ["--cost", "analytic", "--replan", "--calibration-cache", calib]
    if base == "analytic":
        bundle = serve.main(argv)
        assert "[serve] warm-started replanner calibration: online(analytic;" in capsys.readouterr().out
        assert bundle.replanner.calibrated
    else:
        with pytest.warns(UserWarning, match="not applicable, re-calibrating"):
            bundle = serve.main(argv)
        assert "warm-started" not in capsys.readouterr().out
    assert json.load(open(calib))["base"] == "analytic"  # the live scales are saved over it


def test_streams_open_loop_with_admission(capsys):
    bundle = serve.main(SMALL + ["--traffic", "poisson", "--rate", "30", "--duration", "0.3", "--admission"])
    out = capsys.readouterr().out
    assert "[serve] open loop: poisson arrivals at 30.0 Hz/stream" in out
    rep = json.loads(out[out.index("{\n"):])
    assert rep["admission"]["offered"] > 0 and rep["frames"] > 0 and bundle.admission is not None


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--workers", "1"]])
def test_fleet_flags_serve(flag, capsys):
    """``--replicas`` and ``--workers`` serve on the CPU: the launcher
    prints the JAX launcher's ``[serve] fleet:`` line and the fleet's
    merged report, every stream's frames served."""
    bundle = serve.main(SMALL + flag + ["--router-seed", "3"])
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{\n"):])
    n = int(flag[1])
    if flag[0] == "--replicas":
        assert "[serve] fleet: 2 replicas over 1 device(s), router seed 3" in out
        assert len(rep["per_replica"]) == 2 and bundle.replicas == 2
    else:
        line = next(ln for ln in out.splitlines() if ln.startswith("[serve] fleet:"))
        assert line.startswith("[serve] fleet: 1 worker processes (pids [") and line.endswith("router seed 3")
        assert rep["workers"] == n and rep["alive_workers"] == [0] and rep["worker_failures"] == []
        assert all(h.process is None for h in bundle.server.handles)  # closed by the launcher
    assert rep["router"]["seed"] == 3 and rep["frames"] == 3 * 2  # 3 streams x --frames 2
    assert sum(rep["router"]["routed_frames"]) == 6


def test_streams_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([a for a in SMALL if a not in ("--device", "cpu")])


def _greedy_of_smoke(arch):
    import dataclasses

    cfg = dataclasses.replace(get_arch(arch).smoke, act_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    return greedy_generate(model, params, prompt, steps=4, max_len=12, cache_dtype=torch.float32)


def test_lm_mode_generates_what_greedy_generate_does(capsys):
    gen = serve.main(["--arch", "hymba_1_5b", "--tokens", "4", "--batch", "2", "--prompt-len", "8", "--device", "cpu"])
    assert "[serve] arch=hymba_1_5b generated (2, 4)" in capsys.readouterr().out
    assert torch.equal(gen, _greedy_of_smoke("hymba_1_5b"))


def test_lm_mode_defaults_to_gemma2_2b_as_greedy_generate(capsys):
    """``--mode lm`` with no ``--arch`` serves gemma2-2b's smoke config, as
    the JAX launcher does, and generates what ``greedy_generate`` does."""
    gen = serve.main(["--tokens", "4", "--batch", "2", "--prompt-len", "8", "--device", "cpu"])
    assert "[serve] arch=gemma2_2b generated (2, 4)" in capsys.readouterr().out
    assert torch.equal(gen, _greedy_of_smoke("gemma2_2b"))


def test_graph_cost_rows_match_jax_under_analytic():
    (jg, jd), (tg, td) = jengines(constraints_dla=JDLA), tengines(constraints_dla=TDLA)
    for jgraph, tgraph in (
        (jm.Pix2PixGenerator(jm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping")).layer_graph(),
         tm.Pix2PixGenerator(tm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping")).layer_graph()),
        (jm.YOLOv8(jm.YOLOv8Config(img_size=32)).layer_graph(), tm.YOLOv8(tm.YOLOv8Config(img_size=32)).layer_graph()),
    ):
        assert analytic.graph_cost_rows(tgraph, (td, tg)) == jrows(jgraph, (jd, jg))


def test_analytic_main_prints_the_schedule(capsys):
    analytic.main(["--img", "32", "--impl", "auto", "--per-layer"])
    out = capsys.readouterr().out
    assert out.startswith("[analytic] cost=analytic") and "bindings=" in out and "# pix2pix" in out
