"""End-to-end LM training on the PyTorch port: train a reduced config of an
assigned architecture on the synthetic token stream with checkpointing,
then restore the last checkpoint and check it against the trained state.

  PYTHONPATH=src python examples/torch_lm_train.py --arch gemma2_2b --steps 200
  PYTHONPATH=src python examples/torch_lm_train.py --arch gemma2_2b --full   # ~100M params
  PYTHONPATH=src python examples/torch_lm_train.py --device cpu --steps 30 --seq 32

Runs on the CUDA card unless ``--device`` names another device; there the
step is one CUDA graph, replayed at every step after the second
(``make_lm_train_step(..., donate=True)``). ``--full``
builds a ~100M-parameter variant of the same family. The checkpoints go to
``--ckpt-dir``, or to a temporary directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile

import torch

from repro_torch.configs import build_model, get_arch
from repro_torch.data import Prefetcher, to_device, token_batches
from repro_torch.models import LMConfig
from repro_torch.nn.module import param_count, tree_leaves
from repro_torch.serve.demo import resolve_device
from repro_torch.train import LoopConfig, latest_step, make_lm_train_step, restore_checkpoint, run_train_loop
from repro_torch.train.optimizer import AdamW, warmup_cosine


def build_cfg(arch: str, full: bool):
    cfg = get_arch(arch).smoke
    if full:
        if not isinstance(cfg, LMConfig):
            raise SystemExit("--full supports the LM-family archs in this example")
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=768, n_q=12, n_kv=4, head_dim=64, d_ff=2048, vocab=32768
        )  # ~100M params
    return dataclasses.replace(cfg, act_dtype=torch.float32)


def train(args, ckpt_dir: str) -> int:
    device = resolve_device(args.device)
    cfg = build_cfg(args.arch, args.full)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    print(f"arch={args.arch} params={param_count(params) / 1e6:.1f}M vocab={cfg.vocab} on {device}")

    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01)
    step = make_lm_train_step(model, opt, loss_chunk=64, donate=True)
    data = Prefetcher(token_batches(args.batch, args.seq, cfg.vocab, seed=0), depth=2,
                      transform=lambda b: to_device(b, device))
    try:
        out = run_train_loop(
            step, params, opt.init(params), data,
            LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=100, log_every=args.log_every),
        )
    finally:
        data.close()
    first, last = out.history[0]["ce"], out.history[-1]["ce"]
    print(f"\nce: {first:.3f} -> {last:.3f} over {out.step} steps ({len(out.straggler_events)} straggler events)")

    trained = {"params": out.params, "opt_state": out.opt_state}
    restored, at, _ = restore_checkpoint(ckpt_dir, trained, device=device)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(trained), tree_leaves(restored)))
    ok = math.isfinite(last) and last < first and latest_step(ckpt_dir) == out.step == at and same
    print(f"checkpoint at step {at} restores the trained state bit for bit: {same}")
    print(f"lm_train: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        return train(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory() as d:
        return train(args, d)


if __name__ == "__main__":
    raise SystemExit(main())
