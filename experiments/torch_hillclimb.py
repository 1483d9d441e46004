"""Perf hillclimb script for the PyTorch port (the counterpart of
``experiments/hillclimb.py``): run a dry-run cell under variant knobs and
report the three roofline terms + memory, for the hypothesis->change->measure
loop.

  PYTHONPATH=src python experiments/torch_hillclimb.py --arch mamba2_2_7b --shape train_4k \
      --variant fsdp=False n_micro=2

The cell takes ``launch.dryrun.run_cell``'s path on the 16 x 16 production
mesh: ``launch.specs.build_cell`` with the variant's knobs, on ``meta``
DTensors over a fake group of 256 ranks, counted by ``roofline.count_run``
for rank 0 and analysed by ``roofline.analyze`` (predictions for the H100
SXM's peaks). Nothing is allocated, and no CUDA context is made.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.analytic import analytic_bytes, analytic_flops  # noqa: E402
from repro_torch.launch.dryrun import dry_run  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import analyze, count_run  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402

PRODUCTION_RANKS = 256  # the 16 x 16 mesh


def run(arch, shape, set_cfg=None, **kw):
    spec = get_arch(arch)
    if set_cfg:
        spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, **set_cfg))
    t0 = time.time()
    with dry_run(PRODUCTION_RANKS):
        mesh = make_production_mesh(device="cpu")
        cell = build_cell(spec, shape, mesh, **kw)
        _, counts = count_run(cell.fn, cell.args)
    rf = analyze(spec.name, shape, "16x16", cell.n_chips, counts, cell.model_flops, analytic_flops(spec, shape),
                 analytic_bytes(spec, shape, cell.n_chips))
    mem = rf.memory_per_device["total"] / 2**30
    print(
        f"[{arch}|{shape}|{kw}] comp={rf.t_compute*1e3:.1f}ms mem={rf.t_memory*1e3:.1f}ms "
        f"coll={rf.t_collective*1e3:.1f}ms bneck={rf.bottleneck} frac={rf.roofline_fraction:.4f} "
        f"mem/dev={mem:.2f}GiB corr={rf.loop_correction:.1f} (host {time.time()-t0:.0f}s)",
        flush=True,
    )
    return rf.row()


def parse_kw(items):
    out = {}
    for it in items:
        k, v = it.split("=")
        if v in ("True", "False"):
            out[k] = v == "True"
        elif v.isdigit():
            out[k] = int(v)
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--set", nargs="*", default=[], help="config overrides, e.g. remat=False attn_chunk=512")
    a = ap.parse_args()
    run(a.arch, a.shape, set_cfg=parse_kw(a.set) or None, **parse_kw(a.variant))
