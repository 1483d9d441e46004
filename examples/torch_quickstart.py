"""Quickstart on the PyTorch port: train a small Pix2Pix CT->MRI
reconstructor on synthetic brain phantoms, apply the hardware-aware
surgery, and verify it is free.

  PYTHONPATH=src python examples/torch_quickstart.py [--steps 200] [--img 64]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 2 --img 32 --base 8

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import substitute_pix2pix
from repro_torch.data import PhantomConfig, phantom_batches
from repro_torch.models import Pix2Pix, Pix2PixConfig
from repro_torch.nn.module import tree_map
from repro_torch.serve.demo import resolve_device
from repro_torch.train import Adam, make_pix2pix_train_step, psnr, ssim, to_uint8_range


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--base", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def on_device(batch):
        return tree_map(lambda a: torch.from_numpy(a).to(device), batch)

    cfg = Pix2PixConfig(img_size=args.img, base=args.base, deconv_mode="padded")
    model = Pix2Pix(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    g_opt, d_opt = Adam(lr=2e-4, b1=0.5), Adam(lr=2e-4, b1=0.5)
    opt_state = {"g": g_opt.init(params["generator"]), "d": d_opt.init(params["discriminator"])}
    step = make_pix2pix_train_step(model, g_opt, d_opt)
    data = phantom_batches(args.batch, PhantomConfig(img_size=args.img), seed=0)
    dropout = torch.Generator(device).manual_seed(0)

    for i in range(args.steps):
        b = next(data)
        params, opt_state, m = step(params, opt_state, on_device({"src": b["src"], "dst": b["dst"]}), dropout)
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            print(f"step {i+1}: g_loss={float(m['g_loss']):.3f} l1={float(m['g_l1']):.4f} d_loss={float(m['d_loss']):.3f}")

    # evaluate
    b = on_device(next(phantom_batches(8, PhantomConfig(img_size=args.img), seed=99)))
    src, dst = b["src"], b["dst"]
    with torch.no_grad():
        fake = model.generate(params, src)
        print(f"\neval SSIM={float(ssim(to_uint8_range(dst), to_uint8_range(fake)).mean())*100:.2f} "
              f"PSNR={float(psnr(to_uint8_range(dst), to_uint8_range(fake)).mean()):.2f} on {device}")

        # hardware-aware surgery is free: same weights, same outputs, DLA-legal
        fake_c = Pix2Pix(substitute_pix2pix(cfg, "cropping")).generate(params, src)
    delta = float((fake - fake_c).abs().max())
    print(f"surgery max|delta| = {delta:.2e} (exact by construction; a card may pick other conv algorithms)")
    ok = bool(torch.isfinite(fake).all()) and delta <= 1e-4
    print(f"functional check: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
