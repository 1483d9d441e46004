"""Generic fault-tolerant training loop (the counterpart of ``repro.train.loop``).

* auto-resume from the newest intact checkpoint (atomic manifest),
* async checkpointing off the critical path,
* straggler watchdog: per-step wall time against an EMA; slow steps are
  logged and counted (the signal a restart supervisor,
  ``launch.supervisor``, acts on),
* crash recovery: any exception flushes a rescue checkpoint before
  re-raising, so the supervisor restarts from the last good step. Saving
  issues no collective, so a rank whose step or data failed saves alone
  while the others wait in a collective or have left.

Each step is timed to its end: the loop waits for the first metric's value
(``.item()``), which waits for the device's work on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..nn.module import tree_leaves
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # step slower than factor*EMA => straggler event
    ema_decay: float = 0.9


@dataclasses.dataclass
class LoopState:
    params: Any
    opt_state: Any
    step: int = 0
    history: list[dict] = dataclasses.field(default_factory=list)
    straggler_events: list[tuple[int, float, float]] = dataclasses.field(default_factory=list)


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed`` (the JAX
    loop's ``fold_in(rng, step)``): a function of the two alone, so a
    resumed run draws what an unbroken one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state) & (2**63 - 1))


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist

    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def _device(tree):
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def run_train_loop(
    train_step: Callable,
    params: Any,
    opt_state: Any,
    data_iter: Iterator,
    cfg: LoopConfig,
    seed: int | None = None,
    resume: bool = True,
    log_fn: Callable[[str], None] = print,
    device=None,
    shardings: Any = None,
) -> LoopState:
    """Run ``train_step(params, opt_state, batch[, generator]) -> (params,
    opt_state, metrics)`` to ``cfg.total_steps``. With ``seed`` each step
    also gets ``_step_generator(seed, step, device)`` (``device`` defaults to
    the parameters'). A resumed state is restored leaf by leaf onto the
    devices of ``params`` and ``opt_state`` as given, or placed by
    ``shardings`` (``{"params": ..., "opt_state": ...}`` of
    ``dist.NamedSharding``). Over a process group each rank writes its own
    checkpoint shard."""
    device = _device(params) if device is None else torch.device(device)
    state = LoopState(params=params, opt_state=opt_state)
    ckptr = None
    if cfg.ckpt_dir:
        rank, world = _rank_and_world()
        ckptr = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep, process_index=rank, n_processes=world)
        if resume and latest_step(cfg.ckpt_dir) is not None:
            tree, step, _ = restore_checkpoint(cfg.ckpt_dir, {"params": params, "opt_state": opt_state},
                                               shardings=shardings)
            state.params, state.opt_state = tree["params"], tree["opt_state"]
            state.step = step
            log_fn(f"[loop] resumed from step {step}")

    ema = None
    try:
        while state.step < cfg.total_steps:
            batch = next(data_iter)
            t0 = time.perf_counter()
            if seed is not None:
                out = train_step(state.params, state.opt_state, batch, _step_generator(seed, state.step, device))
            else:
                out = train_step(state.params, state.opt_state, batch)
            state.params, state.opt_state, metrics = out
            first = tree_leaves(metrics)[0]
            if isinstance(first, torch.Tensor):
                first.item()  # waits for the step's device work
            dt = time.perf_counter() - t0
            state.step += 1

            if ema is None:
                ema = dt
            else:
                if dt > cfg.straggler_factor * ema:
                    state.straggler_events.append((state.step, dt, ema))
                    log_fn(f"[loop] STRAGGLER step {state.step}: {dt*1e3:.1f}ms vs EMA {ema*1e3:.1f}ms")
                ema = cfg.ema_decay * ema + (1 - cfg.ema_decay) * dt

            if state.step % cfg.log_every == 0 or state.step == cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                state.history.append({"step": state.step, "time": dt, **m})
                log_fn(f"[loop] step {state.step}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items()))

            if ckptr and state.step % cfg.ckpt_every == 0:
                ckptr.save(state.step, {"params": state.params, "opt_state": state.opt_state})
    except Exception:
        if ckptr:  # flush a rescue checkpoint so the supervisor can resume
            try:
                ckptr.save(state.step, {"params": state.params, "opt_state": state.opt_state})
                ckptr.wait()
            except Exception as e:  # the original failure is the one to raise
                log_fn(f"[loop] rescue checkpoint failed: {e!r}")
        raise
    finally:
        if ckptr:
            ckptr.save(state.step, {"params": state.params, "opt_state": state.opt_state})
            ckptr.close()
    return state
