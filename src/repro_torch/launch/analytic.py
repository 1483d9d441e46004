"""The planner's cost view of the paper's serving pair.

``graph_cost_rows`` tabulates a layer graph's per-layer times under a
``CostProvider``; ``main`` prints the graph totals and the N-model schedule
of Pix2Pix + YOLOv8 under the selected provider (``--cost measured``
counts each layer from the port's ops, ``core.profiler``). The JAX
package's arch-level executed-FLOP model (its ``analytic_flops`` and
friends) waits for the LM model zoo's configs (ROADMAP.md, module queue
item 3).
"""
from __future__ import annotations


def graph_cost_rows(graph, engines, provider=None) -> list[dict]:
    """Per-layer timing table for a layer graph under a ``CostProvider`` —
    the layer-graph analogue of the arch-level analytic model above, and
    the quickest way to see where measured costs diverge from analytic
    ones (``python -m repro_torch.launch.analytic --cost measured``)."""
    from ..core.cost_model import ANALYTIC

    provider = provider or ANALYTIC
    rows = []
    for l in graph:
        row = {"layer": l.name, "kind": l.kind, "flops": l.flops}
        for e in engines:
            row[f"t_{e.name}_us"] = provider.layer_time(l, e) * 1e6
        row["measured"] = provider.available(l)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    """Planner-view cost report for the paper's serving pair: graph totals
    and the N-model schedule under the selected provider.

      PYTHONPATH=src python -m repro_torch.launch.analytic --cost measured --per-layer
    """
    import argparse
    import json

    from ..core.constraints import DLA_ANALOGUE_CONSTRAINTS
    from ..core.cost_model import make_cost_provider
    from ..core.engine import jetson_orin_engines
    from ..core.scheduler import _nmodel_schedule_impl as nmodel_schedule
    from ..models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config

    ap = argparse.ArgumentParser()
    ap.add_argument("--cost", choices=("analytic", "measured", "blended"), default="analytic")
    ap.add_argument("--cost-cache", default=None, help="JSON cache for measured layer timings")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--per-layer", action="store_true", help="dump the per-layer table")
    ap.add_argument(
        "--granularity",
        choices=("coarse", "fine"),
        default="coarse",
        help="plan at composite-node or expanded (primitive) granularity",
    )
    ap.add_argument("--stride", type=int, default=1, help="keep every k-th legal cut point")
    ap.add_argument(
        "--max-cuts",
        type=int,
        default=1,
        help="per-model cut budget: k-segment routes ping-pong each model across engines",
    )
    ap.add_argument(
        "--impl",
        choices=("auto", "xla", "pallas"),
        default="xla",
        help="implementation planning: xla (the plain torch ops), pallas (the fused CUDA serving "
        "kernels), or auto (per-segment argmin over both)",
    )
    args = ap.parse_args(argv)

    provider = make_cost_provider(args.cost, cache_path=args.cost_cache)
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
    g_pix = Pix2PixGenerator(Pix2PixConfig(img_size=args.img, deconv_mode="cropping")).layer_graph()
    g_yolo = YOLOv8(YOLOv8Config(img_size=args.img)).layer_graph()
    if args.granularity == "fine":
        g_pix, g_yolo = g_pix.expand(), g_yolo.expand()
    plan = nmodel_schedule(
        [g_pix, g_yolo], [dla, gpu], provider=provider, stride=args.stride,
        max_cuts=args.max_cuts, impl=args.impl,
    )
    if args.cost_cache and hasattr(provider, "save"):
        provider.save()  # measured AND blended both persist their timings
    print(
        f"[analytic] cost={plan.cost_provider} search={plan.search} "
        f"cuts={plan.cuts} cycle={plan.cycle_time*1e3:.3f} ms "
        f"aggregate={plan.schedule.aggregate_fps:.1f} FPS"
    )
    if args.impl != "xla":
        print(f"[analytic] impl={args.impl} bindings={plan.ir.impl_bindings()}")
    print(plan.schedule.ascii_timeline())
    if args.per_layer:
        for graph in (g_pix, g_yolo):
            print(f"\n# {graph.model_name}")
            print(json.dumps(graph_cost_rows(graph, (dla, gpu), provider), indent=2))


if __name__ == "__main__":
    main()
