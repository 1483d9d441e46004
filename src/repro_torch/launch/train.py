"""Training launcher (the counterpart of ``repro.launch.train``): an
architecture of ``configs.ARCH_IDS`` trained on the synthetic token stream
by ``make_lm_train_step`` in the fault-tolerant loop, over a ``DeviceMesh``
of the process group's ranks, on the CUDA card unless ``--device`` names
another device.

Single process (a one-rank mesh):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b --batch 4 --seq 1024 --n-micro 2

Multi-process (one invocation per rank; see launch/distributed.py):
  python -m repro_torch.launch.train --arch gemma2_27b --coordinator $ADDR \
      --num-processes $N --process-id $I --model-parallel 4

Activations are fp32 under ``--smoke`` and bf16 otherwise; parameters and
the optimizer state stay fp32, are placed by ``dist.train_shardings`` as
DTensors, and the step writes its update into their buffers
(``AdamW.update_``, as the JAX launcher donates them to its jitted step).
On the card the step is one CUDA graph, captured at the second step and
replayed at every step after (``make_lm_train_step(..., donate=True)``);
on the CPU it runs eagerly.
Each rank draws its batches from the stream seeded by its index along the
mesh's data-like dims and keeps its own rows of them (``shard_batch``).
``main(argv)`` returns the loop's ``LoopState``, and destroys the process
group if it made it. ``reference_steps`` runs in one process what a
``--smoke`` launch over several computes, to hold the launch against.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import build_model, get_arch
from ..data import Prefetcher, shard_batch, token_batches
from ..dist.sharding import device_put, mesh_index, on_mesh, train_shardings
from ..serve.demo import resolve_device
from ..train import LoopConfig, run_train_loop
from ..train.optimizer import AdamW, warmup_cosine
from ..train.steps import make_lm_train_step
from .distributed import maybe_initialize_distributed
from .mesh import make_host_mesh, make_production_mesh


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


def main(argv=None):
    import torch.distributed as dist

    args = parse_args(argv)
    owns_group = not dist.is_initialized()
    try:
        return _main(args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _main(args):
    dev = resolve_device(args.device)
    maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=dev)

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    cfg = dataclasses.replace(cfg, act_dtype=torch.float32 if args.smoke else torch.bfloat16)
    model = build_model(cfg)
    mesh = (
        make_production_mesh(multi_pod=args.multipod, device=dev)
        if args.production_mesh
        else make_host_mesh(args.model_parallel, device=dev)
    )

    params = model.init(torch.Generator().manual_seed(0), device=dev)
    opt = AdamW(lr=warmup_cosine(args.lr, 50, args.steps), weight_decay=0.01)
    opt_state = opt.init(params)
    step = make_lm_train_step(model, opt, n_micro=args.n_micro, donate=True)

    # all sharding plumbing in one call: fitted param shardings, optimizer
    # state derived structurally, batch over the data-like axes
    abstract = model.abstract()
    sh = train_shardings(mesh, model.axes(), abstract, opt_state, args.batch)
    params = device_put(params, sh.params)
    opt_state = device_put(opt_state, sh.opt_state)
    jstep = on_mesh(step)

    # each rank's stream is seeded by its index along the dims the batch
    # shards over: ranks that differ only along the others hold equal rows
    data = Prefetcher(
        token_batches(args.batch, args.seq, cfg.vocab, seed=mesh_index(mesh, sh.batch.spec[0])[0]),
        transform=lambda b: shard_batch(b, sh.batch),
    )
    try:
        out = run_train_loop(
            jstep,
            params,
            opt_state,
            data,
            LoopConfig(args.steps, args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=args.log_every),
            shardings={"params": sh.params, "opt_state": sh.opt_state},
        )
    finally:
        data.close()
    print(f"[train] finished at step {out.step}; stragglers={len(out.straggler_events)}")
    return out


def reference_steps(arch: str, steps: int, batch: int, seq: int, n_micro: int = 1, world: int = 1, lr: float = 1e-3):
    """One process's run, on plain CPU tensors, of what ``main`` with
    ``--arch arch --smoke --steps steps --batch batch --seq seq --n-micro
    n_micro --lr lr`` computes over ``world`` processes on a (world, 1)
    mesh: rank r draws the stream seeded r and keeps rows r * batch / world
    up to the next rank's of each batch; this steps on the batches
    assembled from those rows. Returns each step's metrics (floats) and
    the parameters after the last."""
    cfg = dataclasses.replace(get_arch(arch).smoke, act_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=warmup_cosine(lr, 50, steps), weight_decay=0.01)
    state, step = opt.init(params), make_lm_train_step(model, opt, n_micro=n_micro, donate=True)
    streams = [token_batches(batch, seq, cfg.vocab, seed=r) for r in range(world)]
    rows = batch // world
    history = []
    for _ in range(steps):
        own = [next(s) for s in streams]
        assembled = {k: torch.from_numpy(np.concatenate([o[k][r * rows : (r + 1) * rows] for r, o in enumerate(own)]))
                     for k in own[0]}
        params, state, m = step(params, state, assembled)
        history.append({k: float(v) for k, v in m.items()})
    return history, params


if __name__ == "__main__":
    main()
