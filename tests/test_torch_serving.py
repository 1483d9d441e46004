"""The PyTorch port's planning and serving against the JAX package.

Pins: the port emits the same ``PlanIR`` JSON as the reference for the
serving pair; ``build_server(device="cpu", impl="pallas")`` serves every
stream within the reference's own server-vs-``run_all`` pin (atol 5e-3,
rtol 1e-2) of the JAX ``run_all``; overlapped and serialized dispatch are
bit-identical; the package imports neither ``jax`` nor ``repro``; and with
no device named, the entry point runs on the card or raises.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.api import plan as jplan  # noqa: E402
from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as JDLA  # noqa: E402
from repro.core.engine import jetson_orin_engines as jengines  # noqa: E402
import repro.models as jm  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as TDLA  # noqa: E402
from repro_torch.core.engine import jetson_orin_engines as tengines  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.fused import ops  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.nn import from_jax  # noqa: E402
from repro_torch.serve import MultiStreamServer, build_server  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


def _graphs(models, img, base):
    pix = models.Pix2PixGenerator(models.Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping"))
    return [pix.layer_graph(), models.YOLOv8(models.YOLOv8Config(img_size=img)).layer_graph()]


@pytest.mark.parametrize("img,base", [(32, 8), (256, 64)])
@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("granularity", ["coarse", "fine"])
def test_plan_ir_json_equals_reference(img, base, impl, granularity):
    jg, jd = jengines(constraints_dla=JDLA)
    tg, td = tengines(constraints_dla=TDLA)
    kw = dict(cost="analytic", impl=impl, granularity=granularity)
    want = jplan(_graphs(jm, img, base), [jd, jg], **kw).to_json()
    got = tplan(_graphs(tm, img, base), [td, tg], **kw).to_json()
    assert got == want


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
def served():
    """One reference (JAX staged models, run_all) and the port's
    pallas-planned server over the same weights, at img 32 / base 8 on the
    CPU — the serving pair of ``repro.serve.demo``."""
    pcfg = jm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping")
    ycfg = jm.YOLOv8Config(img_size=32)
    jmodels = [
        jpipe.pix2pix_staged(pcfg, {"generator": _jax_params(jm.Pix2PixGenerator(pcfg), 0)}),
        jpipe.yolo_staged(ycfg, _jax_params(jm.YOLOv8(ycfg), 1)),
    ]
    x = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    refs = [jax.jit(m.run_all)(jnp.asarray(x)) for m in jmodels]

    def server(dispatch):
        bundle = build_server(
            img=32, base=8, n_pix=1, n_yolo=1, impl="pallas", dispatch=dispatch, device="cpu"
        )
        for tm_, jm_ in zip(bundle.models, jmodels):
            tm_.params = from_jax(jax.tree.map(np.asarray, jm_.params))
        return bundle

    return x, refs, server


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _serve(bundle, x, frames=2):
    srv = bundle.server
    for _ in range(frames):
        for s in bundle.streams:
            srv.submit(s.model_index, torch.from_numpy(x))
    srv.pump()
    return srv.drain()


def test_server_pallas_plan_matches_reference_run_all(served):
    x, refs, server = served
    bundle = server("overlapped")
    assert any(i == "pallas_fused" for b in bundle.plan.impl_bindings() for i in b)
    ops.reset_launches()
    outs = _serve(bundle, x)
    assert ops.launches == {"conv_block": 0, "deconv_block": 0, "sppf_pyramid": 0}  # CPU: plain
    for s in bundle.streams:
        assert len(outs[s.name]) == 2
        for got in outs[s.name]:
            for a, b in zip(_leaves(got), _leaves(refs[s.model_index])):
                assert tuple(a.shape) == b.shape and torch.isfinite(a).all()
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, rtol=1e-2)
    rep = bundle.report()
    assert rep["dispatch"] == "overlapped"


def test_overlapped_and_serialized_dispatch_bit_identical(served):
    x, _, server = served
    a, b = _serve(server("overlapped"), x), _serve(server("serialized"), x)
    assert a.keys() == b.keys()
    for name in a:
        for oa, ob in zip(a[name], b[name]):
            for ta, tb in zip(_leaves(oa), _leaves(ob)):
                assert torch.equal(ta, tb)


def test_batched_instance_norm_pads_buckets_on_the_state_device():
    """The coalescer pads merged Pix2Pix frames to a bucket with zero lanes
    made on the state's device and dtype, and slices them away."""
    bundle = build_server(
        img=32, base=8, n_pix=3, n_yolo=1, norm="instance", batching=4, device="cpu"
    )
    x = torch.randn(1, 32, 32, 3)
    alone = bundle.models[0].run_all(x)
    outs = _serve(bundle, x.numpy(), frames=1)
    batches = {c.batch for c in bundle.server.executor.completions if c.stream.startswith("mri")}
    assert batches == {3}
    for i in range(3):
        torch.testing.assert_close(outs[f"mri-{i}"][0], alone, atol=1e-5, rtol=1e-5)


def test_profiled_ticks_and_plan_prepare_run_on_the_port():
    """The executor's live-cost hooks: profiled ticks stamp per-segment
    observations, and ``prepare_plan`` warms every segment of a plan on
    zeros of the seen state shapes (on the models' device)."""
    from repro_torch.serve import StreamExecutor

    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, impl="pallas", device="cpu")
    ex = StreamExecutor(bundle.models, bundle.plan, bundle.streams, profile_every=1)
    x = torch.randn(1, 32, 32, 3)
    for s in bundle.streams:
        ex.submit(s.model_index, x)
    ex.run_until_drained()
    assert {o.model_index for o in ex.segment_obs} == {0, 1}
    assert all(o.wall_s >= 0 and o.impl == "pallas_fused" for o in ex.segment_obs)
    assert ex.prepare_plan(bundle.plan) == sum(len(r) for r in bundle.plan.segments)


# modules of the training -> surgery -> evaluation slice, which the walk
# below must reach
NEW_MODULES = [
    "repro_torch.kernels._build", "repro_torch.kernels.deconv.kernel", "repro_torch.kernels.deconv.ops",
    "repro_torch.kernels.deconv.ref", "repro_torch.core.surgery", "repro_torch.data.synthetic",
    "repro_torch.train.losses", "repro_torch.train.metrics", "repro_torch.train.optimizer",
    "repro_torch.train.steps",
    # the Hymba-1.5B serving slice
    "repro_torch.kernels.attention.kernel", "repro_torch.kernels.attention.ops",
    "repro_torch.kernels.attention.ref", "repro_torch.kernels.ssd.kernel", "repro_torch.kernels.ssd.ops",
    "repro_torch.kernels.ssd.ref", "repro_torch.nn.linear", "repro_torch.nn.embed", "repro_torch.nn.rotary",
    "repro_torch.nn.mlp", "repro_torch.nn.attention", "repro_torch.nn.ssm", "repro_torch.models.hymba",
    "repro_torch.configs", "repro_torch.configs.hymba_1_5b", "repro_torch.configs.pix2pix_mri",
    "repro_torch.configs.yolov8_stroke",
    # the launcher slice: graph runners, measured costs, re-planner, loader
    "repro_torch.core.profiler", "repro_torch.serve.replanner", "repro_torch.data.loader",
    "repro_torch.launch", "repro_torch.launch.serve", "repro_torch.launch.analytic",
    # the fleets
    "repro_torch.serve.fleet", "repro_torch.serve.multiproc",
    # the LM/SSM zoo
    "repro_torch.nn.moe", "repro_torch.models.lm", "repro_torch.models.mamba2", "repro_torch.models.whisper",
    *(f"repro_torch.configs.{a}" for a in ("gemma_2b", "gemma2_2b", "gemma2_27b", "phi4_mini_3_8b", "deepseek_moe_16b",
                                            "deepseek_v2_lite_16b", "qwen2_vl_7b", "mamba2_2_7b", "whisper_small")),
    # LM training
    "repro_torch.train.checkpoint", "repro_torch.train.loop", "repro_torch.launch.train",
    "repro_torch.launch.supervisor",
    # the distributed stack
    "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.dist.compress", "repro_torch.launch.mesh",
    "repro_torch.launch.distributed",
]


def test_port_imports_neither_jax_nor_repro():
    """Every module of the package, the card scripts at the root
    (``chip_smoke.py``, ``served_trace.py``), the torch examples
    (``examples/torch_*.py``) and the hillclimb script
    (``experiments/torch_hillclimb.py``) import neither ``jax`` nor
    ``repro``: once imported, and in every import statement of the scripts
    (their work imports lazily, behind ``__main__``)."""
    import ast

    scripts = [SRC.parent / "chip_smoke.py", SRC.parent / "served_trace.py"]
    scripts += sorted((SRC.parent / "examples").glob("torch_*.py"))
    scripts += sorted((SRC.parent / "experiments").glob("torch_*.py"))
    names = set()
    for script in scripts:
        for node in ast.walk(ast.parse(script.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or "")
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}, names
    code = (
        "import importlib, importlib.util, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for path in {[str(p) for p in scripts]!r}:\n"
        "    spec = importlib.util.spec_from_file_location(path.rsplit('/', 1)[-1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        f"missing = sorted(set({NEW_MODULES!r}) - set(sys.modules))\n"
        "assert not missing, missing\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


def test_build_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(img=32, base=8, n_pix=1, n_yolo=1)


def test_build_server_attaches_the_replanner():
    """``replan=True`` attaches the re-planner to the executor, and a server
    built by hand over the bundle takes it too."""
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, device="cpu", replan=True)
    assert bundle.replanner is not None and bundle.server.executor.on_tick == bundle.replanner.maybe_replan
    server = MultiStreamServer(bundle.models, bundle.plan, bundle.streams, replanner=bundle.replanner)
    assert server.replanner is bundle.replanner


def test_frame_for_is_seeded_per_stream_and_frame():
    bundle = build_server(img=32, base=8, n_pix=2, n_yolo=1, device="cpu")
    a = bundle.frame_for("mri-1", 3)
    assert tuple(a.shape) == (1, 32, 32, 3) and a.device.type == "cpu"
    assert torch.equal(a, bundle.frame_for("mri-1", 3))
    assert not torch.equal(a, bundle.frame_for("mri-0", 3))


@pytest.mark.cuda
def test_card_serving_dispatch_modes_bit_identical_and_match_plain_ops():
    """On the card: the engine streams' event hand-offs give the same bits
    in overlapped and serialized dispatch, with merged instance-norm
    flights, and the served outputs match ``run_all`` on the plain ops
    (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, bundles = {}, {}
    for dispatch in ("overlapped", "serialized"):
        bundle = build_server(
            img=64, base=8, n_pix=3, n_yolo=1, norm="instance", batching=4, impl="pallas",
            dispatch=dispatch, device="cuda",
        )
        ops.reset_launches()
        kernels.reset_graph_launches()
        for t in range(3):
            for s in bundle.streams:
                bundle.server.submit(s.model_index, bundle.frame_for(s.name, t))
        bundle.server.pump()
        outs[dispatch] = bundle.server.drain()
        torch.cuda.synchronize()
        # the segments are CUDA graphs: every frame's launches are replays
        # (the wrappers count only each graph's warm-up, outside it)
        assert kernels.graph_launches["conv_block"] > 0 and kernels.graph_launches["sppf_pyramid"] == 3
        assert max(c.batch for c in bundle.server.executor.completions) > 1  # merged flights
        bundles[dispatch] = bundle
    a, b = outs["overlapped"], outs["serialized"]
    for name in a:
        for oa, ob in zip(a[name], b[name]):
            for ta, tb in zip(_leaves(oa), _leaves(ob)):
                assert torch.equal(ta, tb)
    bundle = bundles["overlapped"]
    for s in bundle.streams:
        model = bundle.models[s.model_index]
        for t, got in enumerate(a[s.name]):
            want = model.run_all(bundle.frame_for(s.name, t))
            for ta, tb in zip(_leaves(got), _leaves(want)):
                torch.testing.assert_close(ta, tb, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("name", ["measured", "blended", "online"])
def test_measured_costs_wait_for_the_profiler_port(name):
    """The measured providers, which waited for the ``core.profiler`` port,
    now plan the served pair (tests/test_torch_cost_model.py holds them
    against the JAX package)."""
    from repro_torch.core.cost_model import ANALYTIC, make_cost_provider

    assert make_cost_provider("analytic") is ANALYTIC
    assert make_cost_provider(name).name == name
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, device="cpu", cost=name, impl="auto")
    assert bundle.plan.cost_provider == name and bundle.provider.name == name
