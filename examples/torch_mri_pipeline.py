"""The paper's standalone scheme on the PyTorch port, end to end:
simultaneous MRI reconstruction (Pix2Pix) + stroke detection (YOLOv8) on a
CT stream, scheduled HaX-CoNN-style across two engines and executed as a
double-buffered pipeline (``TwoModelPipeline``; on the card each engine is
one CUDA stream).

  PYTHONPATH=src python examples/torch_mri_pipeline.py [--train-steps 60]
  PYTHONPATH=src python examples/torch_mri_pipeline.py --device cpu --train-steps 1 --img 32 --frames 2

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import core
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS
from repro_torch.core.engine import jetson_orin_engines
from repro_torch.core.scheduler import _haxconn_schedule_impl
from repro_torch.data import PhantomConfig, detection_batches, phantom_batches
from repro_torch.models import Pix2Pix, Pix2PixConfig, YOLOv8, YOLOv8Config
from repro_torch.nn.module import tree_map
from repro_torch.serve.demo import resolve_device
from repro_torch.train import Adam, AdamW, make_pix2pix_train_step, make_yolo_train_step, ssim, to_uint8_range


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    img = args.img
    device = resolve_device(args.device)
    # f32 on the card: TF32 off, so the plain ops are an f32 reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def on_device(batch):
        return tree_map(lambda a: torch.from_numpy(a).to(device), batch)

    # --- 1. train the two models briefly on synthetic phantoms ---
    print("== training Pix2Pix (cropping variant: DLA-legal, zero fallback) ==")
    cfg = Pix2PixConfig(img_size=img, base=16, deconv_mode="cropping")
    gan = Pix2Pix(cfg)
    params = gan.init(torch.Generator(device).manual_seed(0))
    g_opt, d_opt = Adam(lr=2e-4, b1=0.5), Adam(lr=2e-4, b1=0.5)
    ost = {"g": g_opt.init(params["generator"]), "d": d_opt.init(params["discriminator"])}
    gstep = make_pix2pix_train_step(gan, g_opt, d_opt)
    gdata = phantom_batches(4, PhantomConfig(img_size=img), seed=0)
    dropout = torch.Generator(device).manual_seed(0)
    for _ in range(args.train_steps):
        b = next(gdata)
        params, ost, gm = gstep(params, ost, on_device({"src": b["src"], "dst": b["dst"]}), dropout)

    print("== training YOLOv8 stroke detector ==")
    ycfg = YOLOv8Config(img_size=img, n_classes=2)
    yolo = YOLOv8(ycfg)
    yparams = yolo.init(torch.Generator(device).manual_seed(1))
    yopt = AdamW(lr=1e-3)
    yst = yopt.init(yparams)
    ystep = make_yolo_train_step(yolo, yopt)
    ydata = detection_batches(4, PhantomConfig(img_size=img, lesion_p=1.0), seed=2)
    for _ in range(args.train_steps):
        yparams, yst, ym = ystep(yparams, yst, on_device(next(ydata)))
    print(f"   gan l1={float(gm['g_l1']):.4f}  yolo loss={float(ym['loss']):.3f}")

    # --- 2. schedule the two models across the engines ---
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
    gsm = core.pix2pix_staged(cfg, params)
    ysm = core.yolo_staged(ycfg, yparams)
    plan = _haxconn_schedule_impl(gsm.graph, ysm.graph, dla, gpu)
    s = plan.schedule
    print("\n== HaX-CoNN schedule (cost model @ Jetson Orin constants) ==")
    for n in s.notes:
        print("  ", n)
    print(s.ascii_timeline())
    print(f"  predicted aggregate throughput: {s.aggregate_fps:.1f} FPS")

    # --- 3. execute the pipeline over a CT stream ---
    print("\n== executing the double-buffered pipeline ==")
    stream = phantom_batches(1, PhantomConfig(img_size=img, lesion_p=1.0), seed=42)
    frames = [torch.from_numpy(next(stream)["src"]).to(device) for _ in range(args.frames)]
    pipe = core.TwoModelPipeline(gsm, ysm, plan)
    t0 = time.perf_counter()
    with torch.no_grad():
        recons, detections = pipe.run_stream(frames, frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"  processed {len(frames)} CT frames in {dt:.2f}s on {device}")
    b = next(phantom_batches(args.frames, PhantomConfig(img_size=img), seed=42))
    mri_ref = torch.from_numpy(b["dst"]).to(device)
    rec = torch.cat(recons, dim=0)
    print(f"  reconstruction SSIM vs ground-truth MRI: "
          f"{float(ssim(to_uint8_range(mri_ref), to_uint8_range(rec)).mean())*100:.1f}")
    cls_logits = detections[0]["p3"][..., 4 * ycfg.reg_max :]
    print(f"  detector max lesion score (p3): {float(torch.sigmoid(cls_logits).max()):.3f}")
    print("\npipeline tick log (first 8):")
    for e in pipe.log[:8]:
        print(f"   tick {e.tick} [{e.engine:>4}] {e.work}")
    # the pipeline is a re-orchestration of each model's own op sequence:
    # bit-exact on the CPU; on the card its engines are two CUDA streams,
    # held to the reference's served pin (atol 5e-3, rtol 1e-2)
    with torch.no_grad():
        pairs = [(r, gsm.run_all(f)) for r, f in zip(recons, frames)]
        pairs += [(d[k], ysm.run_all(f)[k]) for d, f in zip(detections, frames) for k in ("p3", "p4", "p5")]
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    ok = all(torch.allclose(a, b, atol=5e-3, rtol=1e-2) for a, b in pairs)
    if device.type == "cpu":
        ok &= worst == 0.0
    print(f"\npipeline outputs vs each model's run_all (max |delta| {worst:.2e}): {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
