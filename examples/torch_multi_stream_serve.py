"""N-model multi-stream serving on the PyTorch port: 4 Pix2Pix
reconstruction streams + 1 YOLOv8 detection stream, planned by the unified
``repro_torch.core.plan`` scheduler and served through the
``repro_torch.serve.build_server`` facade (overlapped dispatch on one CUDA
stream per engine, each planned segment a replayed CUDA graph, double
buffering, bounded queues, micro-batched same-model frames).

This is the production generalization of the paper's two-instance swap
schedule: the planner balances the Pix2Pix/YOLO partition points across
the engines — under the analytic roofline or per-layer costs counted from
the port's ops (``--cost measured``) — and the server fans K frame queues
onto the planned routes. ``--norm instance`` builds the batch-independent
Pix2Pix variant so its streams are merge-micro-batched. ``--replan``
closes the online re-planning loop. ``--open-loop`` drives the same server
with Poisson arrivals under a deadline SLO. ``--replicas`` replicates the
pipeline in this process and ``--workers`` in worker processes, behind the
sticky load-aware fleet router (the paper's replicated pipelines).

  PYTHONPATH=src python examples/torch_multi_stream_serve.py
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --impl pallas --img 256 --base 64
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --cost measured --norm instance
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --replan
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --open-loop --rate 20 --deadline-ms 100
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --open-loop --replicas 2 --traffic-seed 7
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --open-loop --workers 2
  PYTHONPATH=src python examples/torch_multi_stream_serve.py --device cpu --img 32 --frames 2

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import core
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS
from repro_torch.core.cost_model import make_cost_provider
from repro_torch.core.engine import jetson_orin_engines
from repro_torch.models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config
from repro_torch.nn.module import tree_leaves
from repro_torch.serve import TrafficConfig, build_server
from repro_torch.serve.demo import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cost", choices=("analytic", "measured", "blended"), default="analytic")
    ap.add_argument("--cost-cache", default=None, help="JSON cache for measured layer timings")
    ap.add_argument("--dispatch", choices=("overlapped", "serialized"), default="overlapped")
    ap.add_argument("--norm", choices=("batch", "instance", "group"), default="batch")
    ap.add_argument("--streams", type=int, default=4, help="Pix2Pix stream count")
    ap.add_argument("--yolo-streams", type=int, default=1)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--base", type=int, default=8)
    ap.add_argument("--replan", action="store_true", help="online re-planning runtime")
    ap.add_argument(
        "--granularity",
        choices=("coarse", "fine"),
        default="coarse",
        help="plan at composite-node or expanded (primitive) granularity",
    )
    ap.add_argument(
        "--max-cuts",
        default="1",
        help="per-model cut budget (int), or 'auto' to escalate while the cycle improves",
    )
    ap.add_argument(
        "--impl",
        choices=("auto", "xla", "pallas"),
        default="xla",
        help="implementation planning: xla (the plain torch ops), pallas (the fused CUDA serving "
        "kernels), or auto (per-segment argmin over both)",
    )
    ap.add_argument("--open-loop", action="store_true", help="Poisson arrivals under an SLO")
    ap.add_argument("--rate", type=float, default=20.0, help="open-loop arrival rate (Hz/stream)")
    ap.add_argument("--duration", type=float, default=1.5, help="open-loop horizon (s)")
    ap.add_argument("--deadline-ms", type=float, default=100.0, help="open-loop SLO deadline")
    ap.add_argument(
        "--replicas", type=int, default=1,
        help="replicated serving pipelines behind the sticky load-aware fleet router",
    )
    ap.add_argument(
        "--workers", type=int, default=0,
        help="multi-process fleet: worker processes behind the IPC router "
        "(mutually exclusive with --replicas)",
    )
    ap.add_argument(
        "--traffic-seed", type=int, default=0,
        help="arrival-process seed (open-loop runs replay exactly, fleet included)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    max_cuts = "auto" if args.max_cuts == "auto" else int(args.max_cuts)
    device = resolve_device(args.device)
    # f32 on the card: TF32 off (the worker processes take the setting too),
    # so the plain ops are an f32 reference for the functional check
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    provider = make_cost_provider(args.cost, cache_path=args.cost_cache)
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)

    # planner view: full-size graphs (what deploys)
    g_pix = Pix2PixGenerator(Pix2PixConfig(deconv_mode="cropping", norm=args.norm)).layer_graph()
    g_yolo = YOLOv8(YOLOv8Config(img_size=256)).layer_graph()
    plan_full = core.plan(
        [g_pix, g_yolo], [dla, gpu], cost=provider,
        granularity=args.granularity, max_cuts=max_cuts, impl=args.impl,
    )
    print(f"== planner (full-size graphs, {plan_full.cost_provider} cost, {plan_full.search} search) ==")
    print(f"cuts: {plan_full.cuts}  cycle={plan_full.expected_cycle*1e3:.2f} ms  budget={plan_full.cut_budget}")
    if args.impl != "xla":
        print(f"impl={args.impl} bindings={plan_full.impl_bindings()}")

    # executable view: the served models, same machinery, one facade call
    with build_server(
        img=args.img,
        base=args.base,
        n_pix=args.streams,
        n_yolo=args.yolo_streams,
        norm=args.norm,
        # worker processes rebuild the provider by name from the JSON spec
        cost=args.cost if args.workers else provider,
        granularity=args.granularity,
        max_cuts=max_cuts,
        impl=args.impl,
        max_queue=4,
        microbatch=2,
        dispatch=args.dispatch,
        replan=args.replan,
        deadline_ms=args.deadline_ms if args.open_loop else None,
        traffic=TrafficConfig(process="poisson", rate_hz=args.rate, seed=args.traffic_seed)
        if args.open_loop
        else None,
        admission=args.open_loop,
        replicas=args.replicas,
        workers=args.workers,
        device=device,
    ) as bundle:
        if args.cost_cache and hasattr(provider, "save"):
            provider.save()  # measured AND blended both persist their timings
        server, streams, models = bundle.server, bundle.streams, bundle.models
        merge = server.executor.merge_batches

        frames = {
            s.name: [
                torch.randn(
                    (1, args.img, args.img, 3),
                    generator=torch.Generator(device).manual_seed(100 * si + t),
                    device=device,
                )
                for t in range(args.frames)
            ]
            for si, s in enumerate(streams)
        }
        for t in range(args.frames):
            for s in streams:
                server.submit(s.model_index, frames[s.name][t])
            server.pump()
        outs = server.drain()

        if args.open_loop:
            # the closed-loop pass above captured the segments' graphs; now
            # the open-loop phase measures service under Poisson arrivals + SLO
            bundle.run_open_loop(args.duration)

        rep = server.report()
        print(f"\n== serving report ({len(streams)} streams, {args.dispatch} dispatch, merge={merge}, "
              f"{device}) ==")
        print(
            f"frames={rep['frames']} wall={rep['wall_s']:.2f}s "
            f"aggregate={rep['aggregate_fps']:.1f} FPS "
            f"p50={rep['latency_p50_ms']:.1f} ms p99={rep['latency_p99_ms']:.1f} ms "
            f"overlap_eff={rep['overlap']['overlap_efficiency']:.3f}"
        )
        for name, m in rep["per_stream"].items():
            print(
                f"  {name:>7}: {m['completed']} frames  "
                f"p50={m['latency_p50_ms']:.1f} ms  p99={m['latency_p99_ms']:.1f} ms"
            )
        if args.open_loop:
            adm = rep["admission"]
            print(
                f"open loop: goodput={rep['goodput_fps']:.1f} FPS under {args.deadline_ms:.0f} ms SLO  "
                f"offered={adm['offered']} admitted={adm['admitted']} "
                f"shed={adm['shed_res'] + adm['shed_route']} dropped={adm['dropped']}"
            )
            for t, tm in rep["tiers"].items():
                print(
                    f"  tier {t}: offered={tm['offered']} goodput={tm['goodput_fps']:.1f} FPS "
                    f"attainment={tm['slo_attainment']:.2f}"
                )
        if args.workers:
            ro = rep["router"]
            total = max(1, sum(ro["routed_frames"]))
            shares = "  ".join(f"worker{w}={n} ({n / total:.0%})" for w, n in enumerate(ro["routed_frames"]))
            print(
                f"proc fleet: {args.workers} worker processes  {shares}  "
                f"imbalance={ro['imbalance']:.2f}  failures={len(rep['worker_failures'])}"
            )
        elif args.replicas > 1:
            ro = rep["router"]
            print(
                f"fleet: {args.replicas} replicas  routed={ro['routed_frames']} "
                f"imbalance={ro['imbalance']:.2f}  assignments={ro['assignments']}"
            )
        if args.replan:
            rp = rep["replan"]
            if isinstance(rp, list):  # fleet: one summary per replica/worker; show the first
                rp = rp[0]
            scales = {k: f"x{v:.3g}" for k, v in rp["scales"].items()}
            print(
                f"replan: calibrated={rp['calibrated']} observations={rp['observations']} "
                f"scales={scales} swaps={rp['swaps']} (plan rev {rep['plan_revision']})"
            )

        # functional check: every stream's closed-loop outputs match the
        # monolithic model (least-loaded assignment can permute frames
        # across same-model streams, so compare against the union of
        # reference outputs per model), on the plain ops: the reference's
        # served pin (atol 5e-3, rtol 1e-2) covers the fused kernels
        with torch.no_grad():
            refs = {
                s.name: [models[s.model_index].run_all(f) for f in frames[s.name]] for s in streams
            }

        def distance(out, ref):
            return max(float((a.to(b.device) - b).abs().max()) for a, b in zip(tree_leaves(out), tree_leaves(ref)))

        def matches(out, ref):
            return all(
                torch.allclose(a.to(b.device), b, atol=5e-3, rtol=1e-2)
                for a, b in zip(tree_leaves(out), tree_leaves(ref))
            )

        # every submitted frame served (a fleet may serve one stream's
        # model-index submissions on several replicas)
        ok = sum(len(v) for v in outs.values()) == args.frames * len(streams)
        worst = 0.0
        for s in streams:
            pool = [r for s2 in streams if s2.model_index == s.model_index for r in refs[s2.name]]
            for o in outs[s.name]:
                ok &= any(matches(o, r) for r in pool)
                worst = max(worst, min(distance(o, r) for r in pool))
    print(f"\nfunctional check vs monolithic run_all (max |delta| {worst:.2e}): {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
