"""Training launcher (the counterpart of ``repro.launch.train``): an
architecture of ``configs.ARCH_IDS`` trained on the synthetic token stream
by ``make_lm_train_step`` in the fault-tolerant loop, on the CUDA card
unless ``--device`` names another device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --batch 4 --seq 1024 --n-micro 2

Activations are fp32 under ``--smoke`` and bf16 otherwise; parameters and
the optimizer state stay fp32, and the step writes its update into their
buffers (``AdamW.update_``, as the JAX launcher donates them to its jitted
step). The mesh and multi-host flags wait for the port of the distributed
stack (``dist/``, ``launch/mesh.py``, ``launch/distributed.py``) and raise.
``main(argv)`` returns the loop's ``LoopState``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import build_model, get_arch
from ..data import Prefetcher, to_device, token_batches
from ..serve.demo import resolve_device
from ..train import LoopConfig, run_train_loop
from ..train.optimizer import AdamW, warmup_cosine
from ..train.steps import make_lm_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train an LM architecture on synthetic tokens")
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=20, help="record and print every N-th step's metrics")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _refuse_distributed(args):
    used = [flag for flag, on in (
        ("--model-parallel", args.model_parallel > 1),
        ("--production-mesh", args.production_mesh),
        ("--multipod", args.multipod),
        ("--coordinator", args.coordinator is not None),
        ("--num-processes", args.num_processes is not None),
        ("--process-id", args.process_id is not None),
    ) if on]
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: meshes and multi-host training wait for the port of the distributed "
            "stack (dist/, launch/mesh.py, launch/distributed.py)"
        )


def main(argv=None):
    args = parse_args(argv)
    _refuse_distributed(args)
    dev = resolve_device(args.device)

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    cfg = dataclasses.replace(cfg, act_dtype=torch.float32 if args.smoke else torch.bfloat16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    opt = AdamW(lr=warmup_cosine(args.lr, 50, args.steps), weight_decay=0.01)
    opt_state = opt.init(params)
    step = make_lm_train_step(model, opt, n_micro=args.n_micro, donate=True)

    data = Prefetcher(token_batches(args.batch, args.seq, cfg.vocab, seed=0),
                      transform=lambda b: to_device(b, dev))
    try:
        out = run_train_loop(
            step,
            params,
            opt_state,
            data,
            LoopConfig(args.steps, args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=args.log_every),
        )
    finally:
        data.close()
    print(f"[train] finished at step {out.step}; stragglers={len(out.straggler_events)}")
    return out


if __name__ == "__main__":
    main()
