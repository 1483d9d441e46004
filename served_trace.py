"""Where the host time of the served main path goes, in a fresh process.

Builds ``chip_smoke.py``'s main path (``build_server(img=256, base=64,
n_pix=2, n_yolo=1, impl="pallas")`` on the card), serves one warm-up frame
per stream, then ``--runs`` runs of 4 frames per stream as that script's
served run does, with every segment a replayed CUDA graph (``--jit on``:
each flight's state in a slot, or with ``--runner parent`` the parent
tree's runner, ``chip_smoke.ParentSegment``, which copies every state leaf
in and clones every output out) or the eager ops (``--jit off``). For each
run it prints frames/s, each tick's
wall and host-issue time, each engine's host-issue share, the Python
garbage collections inside the run (generation, ms) and the caching
allocator's new device segments (``cudaMalloc`` calls). ``--profile K``
traces run K under ``torch.profiler`` (CPU and CUDA) and prints the host
operations with the most time of their own, and the host time of the
named operations (``NAMED_HOST_OPS``: copies, clones, ``cudaMalloc``,
``cudaGraphLaunch``). The last line is a JSON object of every run. Run it
from the root of a checkout, on a CUDA card:

    python3 served_trace.py --jit on --runs 5 --profile 4
    python3 served_trace.py --jit on --runner parent --runs 5 --profile 4
    python3 served_trace.py --jit off --runs 2 --profile 0

Without a CUDA card it exits 2.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
IMG, BASE, FRAMES = 256, 64, 4
# host operations whose time a traced run reports by name: the state's
# copies in and clones out, the allocator's device mallocs, graph replays
NAMED_HOST_OPS = ("aten::copy_", "aten::clone", "aten::cat", "aten::record_stream", "cudaMemcpyAsync",
                  "cudaMalloc", "cudaGraphLaunch")


class GcClock:
    """The Python garbage collections between ``start`` and ``stop``:
    (generation, ms, objects collected) each."""

    def __init__(self):
        self.events, self._t0, self.on = [], 0.0, False
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.events.append((info["generation"], (time.perf_counter() - self._t0) * 1e3, info["collected"]))

    def start(self):
        self.events, self.on = [], True

    def stop(self):
        self.on = False
        return self.events


def device_segments(torch):
    """The caching allocator's device segments allocated so far (one
    ``cudaMalloc`` each) and its retries."""
    st = torch.cuda.memory_stats()
    return st.get("segment.all.allocated", 0), st.get("num_alloc_retries", 0)


def top_host_ops(prof, n=20):
    """The profiled ops with the most host time of their own, and the
    device time of all CUDA kernels."""
    rows = []
    device_us = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        dev = getattr(e, "self_cuda_time_total", 0.0) if dev is None else dev
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            device_us += dev
        rows.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    return rows[:n], device_us


def named_host_ops(prof):
    """``{op: (calls, own host ms, total host ms)}`` of ``NAMED_HOST_OPS``."""
    out = {}
    for e in prof.key_averages():
        if e.key in NAMED_HOST_OPS:
            out[e.key] = (e.count, e.self_cpu_time_total / 1e3, e.cpu_time_total / 1e3)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--jit", choices=("on", "off"), default="on")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--profile", type=int, default=None, help="trace this run (0 = the first) under torch.profiler")
    p.add_argument("--runner", choices=("slots", "parent"), default="slots",
                   help="with --jit on: this tree's slots, or the parent tree's copying runner")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("served_trace: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as kernels_pkg
    from repro_torch.kernels.fused import kernel, ops
    from repro_torch.serve import build_server

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernel.build()
    kernel.library()
    clock = GcClock()
    jit = args.jit == "on"
    if args.runner == "parent":
        import contextlib

        from chip_smoke import parent_runner

        stack = contextlib.ExitStack()
        stack.enter_context(parent_runner())  # for the whole process
    bundle = build_server(img=IMG, base=BASE, n_pix=2, n_yolo=1, impl="pallas", device="cuda", jit_segments=jit)
    server = bundle.server
    print(f"runner: {args.runner if jit else 'eager'}, slots {server.executor._use_slots}")
    if server.executor.captures_graphs != jit:
        raise AssertionError(f"jit {args.jit} but captures_graphs {server.executor.captures_graphs}")
    for s in bundle.streams:  # warm-up frame per stream (allocator, first launches, graph captures)
        server.submit(s.model_index, bundle.frame_for(s.name, 99))
    server.drain()
    torch.cuda.synchronize()
    runs = []
    for r in range(args.runs):
        server.reset_metrics()
        frames_in = {s.name: [bundle.frame_for(s.name, t) for t in range(FRAMES)] for s in bundle.streams}
        torch.cuda.synchronize()
        ops.reset_launches()
        kernels_pkg.reset_graph_launches()
        seg0, retry0 = device_segments(torch)
        tick0 = len(server.executor.tick_stats)
        prof = None
        if r == args.profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        clock.start()
        for t in range(FRAMES):
            for s in bundle.streams:
                server.submit(s.model_index, frames_in[s.name][t])
        server.pump()
        server.drain()
        torch.cuda.synchronize()
        gcs = clock.stop()
        if prof is not None:
            prof.__exit__(None, None, None)
        seg1, retry1 = device_segments(torch)
        rep = server.report()
        launches = {n: ops.launches[n] + kernels_pkg.graph_launches[n] for n in ops.launches}
        if launches != {"conv_block": 316, "deconv_block": 64, "sppf_pyramid": 4}:
            raise AssertionError(f"run {r}: launches {launches}, want 316/64/4")
        ticks = [
            (round(ts.wall_s * 1e3, 3),
             round(sum(w[0] for w in (ts.engine_wait or {}).values()) * 1e3, 3))
            for ts in server.executor.tick_stats[tick0:]
        ]
        row = {"run": r, "jit": jit, "runner": args.runner if jit else "eager", "profiled": prof is not None,
               "frames": rep["frames"],
               "wall_ms": rep["wall_s"] * 1e3, "frames_per_s": rep["aggregate_fps"],
               "p50_ms": rep["latency_p50_ms"], "p99_ms": rep["latency_p99_ms"],
               "issue_share": {e: w["issue_frac"] for e, w in (rep.get("engines") or {}).items()},
               "tick_wall_and_issue_ms": ticks, "gc": gcs, "gc_ms": sum(g[1] for g in gcs),
               "new_device_segments": seg1 - seg0, "alloc_retries": retry1 - retry0}
        runs.append(row)
        print(f"run {r}{' (profiled)' if prof else ''}, {'graphs' if jit else 'eager'}: {rep['frames']} frames in "
              f"{row['wall_ms']:.2f} ms, {row['frames_per_s']:.2f} frames/s, p50 {row['p50_ms']:.2f} ms, p99 "
              f"{row['p99_ms']:.2f} ms, host-issue share {json.dumps(row['issue_share'])}; "
              f"{len(gcs)} collections ({row['gc_ms']:.2f} ms: {gcs}); {row['new_device_segments']} new device "
              f"segments, {row['alloc_retries']} retries | {smi}")
        print(f"  ticks (wall ms, host-issue ms): {ticks}")
        if prof is not None:
            top, device_us = top_host_ops(prof)
            row["device_ms"] = device_us / 1e3
            row["top_host_ops"] = [{"op": k, "self_host_ms": us / 1e3, "calls": c} for us, c, k in top]
            print(f"  device time of the CUDA kernels {device_us / 1e3:.3f} ms in a {row['wall_ms']:.2f} ms run")
            for us, c, k in top:
                print(f"  {us / 1e3:9.3f} ms host  x{c:<5d} {k[:90]}")
            row["named_host_ops"] = named_host_ops(prof)
            for k, (c, own, total) in row["named_host_ops"].items():
                print(f"  named: {k:22s} x{c:<5d} {own:9.3f} ms own, {total:9.3f} ms with its children")
    print(json.dumps({"smi": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
