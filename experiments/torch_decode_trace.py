"""Where an LM decode step's time and memory traffic go, on one CUDA card.

  python experiments/torch_decode_trace.py [--src DIR] [--archs gemma2_2b,hymba_1_5b]

For each arch at full width and depth (random weights of seed 0 cast to
bf16, bf16 activations and caches of ``chip_smoke.DECODE_AB_LEN`` slots,
``chip_smoke.DECODE_AB_B[arch]`` sequences) this prints:

- one eager ``decode_step`` under ``chip_smoke.cache_copies``: every op that
  makes a new tensor of one layer's KV cache size or more, with the
  ``repro_torch`` lines that called it;
- the eager step and, where the tree has it (``make_lm_decode_step`` with
  ``graphs``), the captured step: ms a step on the host clock over 15 steps
  after the first (the capture), then 4 steps under ``torch.profiler``
  (``chip_smoke.time_split``): device busy a step and the top ops.

``--src`` runs another tree's ``repro_torch`` (a parent commit unpacked with
``git archive`` into a git-ignored directory), so one call compares two
trees on the same card. Prints the card's name and power limit beside every
number.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"), help="the tree whose repro_torch runs")
    ap.add_argument("--archs", default="gemma2_2b,hymba_1_5b")
    args = ap.parse_args(argv)
    sys.path[:0] = [args.src, ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import build_model, get_arch
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import make_lm_decode_step

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"tree {args.src}, torch {torch.__version__} | {smi}")
    for arch in args.archs.split(","):
        B, S = cs.DECODE_AB_B[arch], cs.DECODE_AB_LEN
        model = build_model(dataclasses.replace(get_arch(arch).config, act_dtype=torch.bfloat16))
        params = tree_map(lambda t: t.to(torch.bfloat16), model.init(torch.Generator(dev).manual_seed(0)))
        prompt = torch.from_numpy(np.random.default_rng(5).integers(0, model.cfg.vocab, (B, 8)).astype(np.int32))
        prompt = prompt.to(dev)
        steps = {"eager": torch.no_grad()(model.decode_step)}
        captured = make_lm_decode_step(model)
        if hasattr(captured, "graphs"):
            steps["captured"] = captured

        def loop(step, caches, count):
            tok = prompt[:, :1]
            for t in range(count):
                logits, caches = step(params, tok, caches, t)
                tok = prompt[:, t + 1 : t + 2] if t + 1 < 8 else torch.argmax(logits[:, -1:], -1).to(tok.dtype)

        with torch.no_grad():
            caches = model.init_caches(B, S, dtype=torch.bfloat16, device=dev)
            limit = min(a.nbytes // a.shape[0] for a in tree_leaves(caches) if S in a.shape)
            with cs.cache_copies(torch, limit) as copies:
                steps["eager"](params, prompt[:, :1], caches, 0)
            print(f"{arch} batch {B}, one eager step: new tensors of a layer's KV cache ({limit / 2**20:.0f} MiB) "
                  "or more: " + ("; ".join(f"x{n} {k}" for k, n in copies.rows.items()) or "none") + f" | {smi}")
            for name, step in steps.items():
                loop(step, caches, 1)  # the capture, for the captured step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop(step, caches, 15)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / 15
                split = cs.time_split(torch, lambda p, c: loop(step, c, 4), params, caches)
                print(f"{arch} batch {B} {name}: {ms:.2f} ms a step (host clock), device busy "
                      f"{split['busy_ms'] / 4:.2f} ms a step under torch.profiler; top ops "
                      + "; ".join(f"{k} {v / 4:.3f}" for k, v in split["top_ops"][:5]) + f" | {smi}")
            del caches
        del params, model, steps, captured
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
