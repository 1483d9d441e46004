"""Serving launchers.

``lm`` (default): greedy decode on an architecture's smoke config with the
KV-cache paths. ``streams``: the N-model multi-stream serving subsystem —
K frame streams over the planned engine routes, each planned segment a
captured CUDA graph on the card (``--no-jit-segments``: eager ops).
``--cost`` switches the planner between paper-mode analytic costs and
per-layer costs counted from the port's ops (``core.profiler``);
``--dispatch serialized`` restores the per-segment-synchronized executor
for comparison. Everything runs on the CUDA card unless ``--device``
names another device.

  PYTHONPATH=src python -m repro_torch.launch.serve --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --streams 4 --frames 6
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --impl pallas --img 256 --base 64
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --cost measured --norm instance
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --cost online --replan \\
      --calibration-cache calib.json   # scales persist across restarts
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
      --traffic poisson --rate 30 --deadline-ms 50 --duration 2 --admission
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --device cpu --img 32 --frames 2
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --replicas 2 \\
      --traffic poisson --rate 30 --duration 2 --admission   # replicated fleet
  PYTHONPATH=src python -m repro_torch.launch.serve --mode streams --workers 2 \\
      --traffic poisson --rate 30 --duration 2   # multi-process fleet (IPC router)

``--mode lm`` serves any architecture of ``configs.ARCH_IDS`` at its
smoke config (``--arch``, default ``gemma2_2b`` as in the JAX launcher):
the prompt fed token by token through ``decode_step``, then greedy tokens.
On the card the step is ``train.make_lm_decode_step``'s: captured into one
CUDA graph and replayed for every token, as the JAX launcher jits it once.
``main(argv)`` takes the arguments as a list, so a program can drive the
launcher in its own process: streams mode returns the (closed)
``ServerBundle``, lm mode the generated tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import build_model, get_arch


def run_streams(args):
    from ..core.cost_model import OnlineCost, make_cost_provider
    from ..serve import BatchConfig, ReplanConfig, TrafficConfig, build_server
    from ..serve.demo import resolve_device

    device = resolve_device(args.device)
    provider = make_cost_provider(
        args.cost, cache_path=args.cost_cache, calibration_path=args.calibration_cache
    )
    if isinstance(provider, OnlineCost) and provider.snapshot():
        print(f"[serve] warm-started calibration: {provider.describe()}")
    replan_cfg = None
    if args.replan:
        replan_cfg = ReplanConfig(
            drift_threshold=args.replan_threshold,
            hysteresis=args.replan_hysteresis,
            cooldown_ticks=args.replan_cooldown,
            profile_every=args.profile_every,
            stride=args.planner_stride,
            background=args.replan_background,
            escalate_after=args.replan_escalate,
            load_threshold=args.load_threshold,
            slo_miss_threshold=args.slo_miss_threshold,
        )
    open_loop = args.traffic is not None
    bundle = build_server(
        img=args.img,
        base=args.base,
        n_pix=args.streams,
        n_yolo=args.yolo_streams,
        norm=args.norm,
        # worker processes rebuild the provider from its name (the build
        # spec crosses the process boundary as JSON)
        cost=args.cost if args.workers else provider,
        granularity=args.granularity,
        stride=args.planner_stride,
        max_cuts="auto" if args.max_cuts == "auto" else int(args.max_cuts),
        impl=args.impl,
        max_queue=args.queue_depth,
        microbatch=args.microbatch,
        batching=BatchConfig(max_batch=args.max_batch, hold_ms=args.batch_hold_ms)
        if args.max_batch > 1
        else None,
        dispatch=args.dispatch,
        jit_segments=not args.no_jit_segments,
        deadline_ms=args.deadline_ms if open_loop or args.deadline_ms else None,
        traffic=TrafficConfig(
            process=args.traffic, rate_hz=args.rate, seed=args.traffic_seed
        )
        if open_loop
        else None,
        admission=args.admission,
        replan=replan_cfg if replan_cfg is not None else False,
        calibration_path=args.calibration_cache,
        replicas=args.replicas,
        router_seed=args.router_seed,
        workers=args.workers,
        device=device,
    )
    plan, replanner = bundle.plan, bundle.replanner
    if args.cost_cache and hasattr(provider, "save"):
        provider.save()  # measured AND blended both persist their timings
    print(
        f"[serve] plan cuts={plan.cuts} cycle={plan.expected_cycle*1e3:.2f} ms "
        f"search={plan.search} cost={plan.cost_provider} granularity={args.granularity} "
        f"max_cuts={args.max_cuts} (budget={plan.cut_budget})"
    )
    print(
        f"[serve] device={device} segments="
        f"{'captured CUDA graphs' if bundle.server.executor.captures_graphs else 'eager ops'}"
    )
    if args.max_batch > 1:
        print(
            f"[serve] continuous batching: max_batch={args.max_batch} "
            f"hold={args.batch_hold_ms}ms (norm={args.norm}; batch-norm models never coalesce)"
        )
    if args.workers:
        print(
            f"[serve] fleet: {args.workers} worker processes "
            f"(pids {[h.process.pid for h in bundle.server.handles]}), "
            f"router seed {args.router_seed}"
        )
    elif args.replicas > 1:
        print(
            f"[serve] fleet: {args.replicas} replicas over "
            f"{bundle.server.pool.n_devices} device(s), router seed {args.router_seed}"
        )
    if args.impl != "xla":
        print(f"[serve] impl={args.impl} bindings={plan.impl_bindings()}")
    if replanner is not None and replanner.online is not provider and replanner.online.snapshot():
        # a non-online --cost wraps a fresh OnlineCost in the re-planner,
        # which build_server warm-started from --calibration-cache
        print(f"[serve] warm-started replanner calibration: {replanner.online.describe()}")
    server, streams = bundle.server, bundle.streams
    if open_loop:
        # warm the captured segments with one closed-loop frame per stream
        # so the open-loop phase measures service, not captures
        for s in streams:
            server.submit(s.model_index, bundle.frame_for(s.name, 0))
        server.drain()
        print(
            f"[serve] open loop: {args.traffic} arrivals at {args.rate} Hz/stream "
            f"for {args.duration}s, deadline={args.deadline_ms}ms, "
            f"admission={'on' if bundle.admission else 'off'}"
        )
        bundle.run_open_loop(args.duration)
    else:
        for t in range(args.frames):
            frame = torch.randn(
                (1, args.img, args.img, 3),
                generator=torch.Generator(device).manual_seed(t),
                device=device,
            )
            for s in streams:
                server.submit(s.model_index, frame)
            server.pump()
        server.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.workers:
        # the multi-process fleet checkpoints its merged calibration itself
        # (sync_calibration writes --calibration-cache atomically)
        pass
    elif args.calibration_cache and replanner is not None and replanner.online.snapshot():
        # persist the learned per-engine scales so the next process
        # warm-starts its calibration instead of re-learning it
        replanner.online.save_calibration(args.calibration_cache)
        print(f"[serve] saved calibration -> {args.calibration_cache}")
    elif args.calibration_cache and isinstance(provider, OnlineCost) and provider.snapshot():
        provider.save_calibration(args.calibration_cache)
        print(f"[serve] saved calibration -> {args.calibration_cache}")
    print(json.dumps(server.report(), indent=2))
    bundle.close()
    return bundle


def run_lm(args):
    from ..serve.demo import resolve_device
    from ..train.steps import make_lm_decode_step

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = dataclasses.replace(spec.smoke, act_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    max_len = args.prompt_len + args.tokens

    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), device=device)

    decode = make_lm_decode_step(model)
    caches = model.init_caches(args.batch, max_len, dtype=torch.float32, device=device)
    tok = prompt[:, :1]
    t0 = time.perf_counter()
    outs = []
    for t in range(max_len - 1):
        logits, caches = decode(params, tok, caches, t)
        if t + 1 < args.prompt_len:
            tok = prompt[:, t + 1 : t + 2]
        else:
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            outs.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1)
    replays = [g.replays for g in decode.graphs.values()]
    graphs = f", the step {len(replays)} CUDA graph(s) replayed {sum(replays)} times" if replays else ""
    print(f"[serve] arch={args.arch} generated {tuple(gen.shape)} in {dt:.2f}s "
          f"({args.batch * gen.shape[1] / dt:.1f} tok/s on {device}{graphs})")
    print(gen[:2].cpu())
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "streams"), default="lm")
    ap.add_argument(
        "--arch",
        default="gemma2_2b",
        help="--mode lm architecture, one of configs.ARCH_IDS (served at its smoke config)",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    # streams mode
    ap.add_argument("--streams", type=int, default=4, help="Pix2Pix stream count")
    ap.add_argument("--yolo-streams", type=int, default=1)
    ap.add_argument("--frames", type=int, default=6, help="frames per stream")
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--base", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument(
        "--max-batch",
        type=int,
        default=1,
        help="continuous batching: coalesce frames across streams of a batch-independent "
        "model into power-of-two buckets up to this size (1 = off; batch-norm models "
        "never coalesce — use --norm instance)",
    )
    ap.add_argument(
        "--batch-hold-ms",
        type=float,
        default=0.0,
        help="longest a partial batch bucket may hold for co-riders; frames only wait "
        "when every member's SLO slack covers the batched service time plus this window",
    )
    ap.add_argument("--queue-depth", type=int, default=4)
    ap.add_argument(
        "--cost", choices=("analytic", "measured", "blended", "online"), default="analytic"
    )
    ap.add_argument("--cost-cache", default=None, help="JSON cache for measured layer timings")
    ap.add_argument(
        "--granularity",
        choices=("coarse", "fine"),
        default="coarse",
        help="plan at composite-node or expanded (primitive) granularity",
    )
    ap.add_argument(
        "--planner-stride",
        type=int,
        default=1,
        help="keep every k-th legal cut point (fine-granularity beam tractability knob)",
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
    ap.add_argument(
        "--calibration-cache",
        default=None,
        help="JSON file persisting OnlineCost per-engine scales across restarts",
    )
    ap.add_argument(
        "--replicas",
        type=int,
        default=1,
        help="replicated serving pipelines in this process, behind the sticky load-aware fleet router",
    )
    ap.add_argument(
        "--workers",
        type=int,
        default=0,
        help="multi-process fleet: this many worker processes behind the IPC router "
        "(mutually exclusive with --replicas)",
    )
    ap.add_argument("--router-seed", type=int, default=0, help="fleet router tie-break seed")
    ap.add_argument("--dispatch", choices=("overlapped", "serialized"), default="overlapped")
    ap.add_argument("--norm", choices=("batch", "instance", "group"), default="batch")
    ap.add_argument(
        "--no-jit-segments",
        action="store_true",
        help="eager per-op dispatch (default: each segment a captured CUDA graph on the card)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to serve on (default: the CUDA card, which must exist; 'cpu' runs on the CPU)",
    )
    # online re-planning runtime
    ap.add_argument(
        "--replan", action="store_true", help="watch live segment costs and hot-swap the plan"
    )
    ap.add_argument("--replan-threshold", type=float, default=0.5, help="relative drift to fire on")
    ap.add_argument("--replan-hysteresis", type=int, default=3, help="consecutive drifting ticks")
    ap.add_argument("--replan-cooldown", type=int, default=10, help="min ticks between swaps")
    ap.add_argument("--profile-every", type=int, default=2, help="segment-profiling cadence (ticks)")
    ap.add_argument(
        "--replan-background", action="store_true", help="run the planner in a worker thread"
    )
    ap.add_argument(
        "--replan-escalate",
        type=int,
        default=0,
        help="escalate re-planning to fine granularity after this many drift fires (0 = never)",
    )
    ap.add_argument(
        "--load-threshold",
        type=float,
        default=0.0,
        help="aggregate queue fill fraction that fires a load re-plan (0 = off)",
    )
    ap.add_argument(
        "--slo-miss-threshold",
        type=float,
        default=0.0,
        help="recent deadline-miss rate that fires a load re-plan (0 = off)",
    )
    # open-loop serving + SLOs
    ap.add_argument(
        "--traffic",
        choices=("poisson", "bursty", "diurnal"),
        default=None,
        help="drive the server open-loop with this arrival process (default: closed loop)",
    )
    ap.add_argument("--rate", type=float, default=10.0, help="mean arrival rate per stream (Hz)")
    ap.add_argument("--duration", type=float, default=2.0, help="open-loop horizon (seconds)")
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=None,
        help="per-frame SLO deadline (detection tier 0, reconstruction tier 1); default 100 in open loop",
    )
    ap.add_argument(
        "--admission",
        action="store_true",
        help="enable the graceful-degradation admission ladder (shed resolution -> shed staging -> drop)",
    )
    args = ap.parse_args(argv)
    if args.traffic is not None and args.deadline_ms is None:
        args.deadline_ms = 100.0

    if args.mode == "streams":
        return run_streams(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
