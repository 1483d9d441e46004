"""The paper's client-server scheme (§VI.D.1) on the PyTorch port: TWO
Pix2Pix instances reconstructing independent MRI streams, swap-scheduled
across the engines. Compares the original (fallback-ridden) model against
the hardware-aware variants — the paper's headline 'double the DLA
throughput' result — under the cost model, then runs the 2-stream
pipeline (``TwoModelPipeline``) as an executable check.

  PYTHONPATH=src python examples/torch_multi_stream_recon.py
  PYTHONPATH=src python examples/torch_multi_stream_recon.py --device cpu --img 32

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import core
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS, check_graph
from repro_torch.core.engine import jetson_orin_engines
from repro_torch.core.scheduler import _haxconn_schedule_impl
from repro_torch.models import Pix2PixConfig, Pix2PixGenerator
from repro_torch.serve.demo import resolve_device

GPU, DLA = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=64, help="image size of the executable check")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== 2x Pix2Pix multi-stream reconstruction (256x256, cost model) ==\n")
    results = {}
    for mode in ("padded", "cropping", "conv"):
        g = Pix2PixGenerator(Pix2PixConfig(deconv_mode=mode)).layer_graph()
        ill, _ = check_graph(g, DLA)
        r = _haxconn_schedule_impl(g, g, DLA, GPU)
        s = r.schedule
        results[mode] = s
        print(f"--- {mode} ({len(ill)} DLA-illegal layers) ---")
        print(f"  partitions: instance A DLA[0:{r.p_a}) GPU[{r.p_a}:); instance B GPU[0:{r.p_b}) DLA[{r.p_b}:)")
        print(f"  per-stream {s.aggregate_fps/2:.1f} FPS, aggregate {s.aggregate_fps:.1f} FPS")
        print(s.ascii_timeline())
        print()
    gain = results["cropping"].aggregate_fps / results["padded"].aggregate_fps
    print(f"hardware-aware (cropping) vs original aggregate gain: {gain:.2f}x")
    print("(paper Table IV: DLA throughput 86.94 -> 147.66 FPS = 1.70x on Jetson)")

    # small-scale EXECUTABLE check: the two streams produce exact outputs
    img = args.img
    cfg = Pix2PixConfig(img_size=img, base=8, deconv_mode="cropping")
    gen = Pix2PixGenerator(cfg)
    params = {"generator": gen.init(torch.Generator(device).manual_seed(0))}
    sm_a = core.pix2pix_staged(cfg, params)
    sm_b = core.pix2pix_staged(cfg, params)
    plan = core.plan([sm_a.graph, sm_b.graph], [DLA, GPU], kind="haxconn")
    pipe = core.TwoModelPipeline(sm_a, sm_b, plan)
    frames = [
        torch.randn((1, img, img, 3), generator=torch.Generator(device).manual_seed(i), device=device)
        for i in range(3)
    ]
    with torch.no_grad():
        outs_a, outs_b = pipe.run_stream(frames, list(reversed(frames)))
        ok = all(torch.allclose(sm_a.run_all(f), o, atol=1e-5) for f, o in zip(frames, outs_a))
        ok &= all(torch.allclose(sm_b.run_all(f), o, atol=1e-5) for f, o in zip(reversed(frames), outs_b))
    print(f"\nexecutable 2-stream pipeline functional check on {device}: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
