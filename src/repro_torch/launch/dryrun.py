"""Production-mesh dry run (the counterpart of ``repro.launch.dryrun``):
every (architecture x input shape) cell run once on the production meshes,
on ``meta`` tensors, and its roofline terms extracted.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod | --both-meshes]

Where the JAX module forces 512 host devices and compiles, this one makes a
fake process group of 256 or 512 ranks (``torch.distributed``'s "fake"
backend: collectives complete without a peer), this process its rank 0,
builds the mesh with ``launch.mesh.make_production_mesh(device="cpu")``,
places the cell's inputs as ``meta`` DTensors and runs its step eagerly
while ``launch.roofline.RankCounter`` counts rank 0's local ops and
collectives. Nothing is allocated on any device, here or on a machine with
a GPU. ``t_lower_s`` and ``t_compile_s`` are the cell's build and counted-run
seconds on the host.

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json (the
JAX package's artifacts stay in experiments/dryrun/). A failing cell
(a sharding DTensor cannot run, an op without a meta kernel) is a fault of
the port and is reported as such; the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_arch
from .analytic import analytic_bytes, analytic_flops
from .mesh import make_production_mesh
from .roofline import analyze, count_run
from .specs import build_cell

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


@contextlib.contextmanager
def dry_run(world: int):
    """A fake process group of ``world`` ranks (this process rank 0) for
    the meshes of a dry run, destroyed on exit; raises if a process group
    exists already. Inside it, ``aten::equal`` has a meta kernel that
    answers True for tensors of one shape and dtype: DTensor's vocab-sharded
    gather (the cross-entropy's gold logit) checks its mask against itself
    with it, and a meta tensor has no values to compare."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg): the dry run needs it") from e
    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own process group; one exists already")
    lib = None
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::equal", "Meta"):
        lib = torch.library.Library("aten", "IMPL")
        lib.impl("equal", lambda a, b: a.shape == b.shape and a.dtype == b.dtype, "Meta")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if lib is not None:
            lib._destroy()


# small cells of each kind at smoke widths; "long" is the batch-1 decode
# (sequence-sharded caches)
SMOKE_SHAPES = {
    "train": {"kind": "train", "seq_len": 32, "global_batch": 8},
    "prefill": {"kind": "prefill", "seq_len": 32, "global_batch": 4},
    "decode": {"kind": "decode", "seq_len": 32, "global_batch": 8},
    "long": {"kind": "decode", "seq_len": 64, "global_batch": 1},
}


def check_cell(mesh, arch_name: str, shape_name: str, shapes: dict = SMOKE_SHAPES):
    """Build and run one cell of ``arch_name``'s smoke config on ``mesh``
    (two micro-batches) and check it: its outputs have the global shapes of
    the same step on plain meta tensors, the counts are positive, and a
    train cell (FSDP weights, batch-sharded activations) counts
    collectives. Raises ``AssertionError`` naming what failed; returns the
    counts."""
    from torch.distributed.tensor import DTensor

    from ..nn.module import tree_leaves, tree_map

    def plain(x):
        return torch.empty(x.shape, dtype=x.dtype, device="meta") if isinstance(x, DTensor) else x

    def leaf_shapes(tree):
        return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    spec = get_arch(arch_name)
    spec = dataclasses.replace(spec, config=spec.smoke)
    cell = build_cell(spec, shape_name, mesh, n_micro=2, shapes=shapes)
    out, counts = count_run(cell.fn, cell.args)
    kind = shapes[shape_name]["kind"]
    same = leaf_shapes(tree_map(plain, out)) == leaf_shapes(cell.fn(*tree_map(plain, cell.args)))
    coll = counts.collective_bytes
    checks = {
        "kind and ranks": cell.kind == kind and cell.n_chips == mesh.size(),
        "global shapes": same,
        "positive counts": counts.flops > 0 and counts.bytes_accessed > 0,
        "memory": counts.memory["arguments"] > 0 and counts.memory["total"] >= counts.memory["arguments"],
        "collectives": kind != "train" or (sum(counts.collective_counts.values()) > 0
                                           and (coll["all-gather"] > 0 or coll["all-reduce"] > 0)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cell {arch_name} {shape_name} on {tuple(mesh.shape)}: {', '.join(failed)} wrong")
    return counts


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    spec = get_arch(arch_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if shape_name in spec.skip_shapes:
        reason = (spec.skip_reasons or {}).get(shape_name, "skipped per assignment")
        return {"arch": spec.name, "shape": shape_name, "mesh": mesh_name, "status": "skip", "reason": reason}
    t0 = time.time()
    try:
        with dry_run(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            cell = build_cell(spec, shape_name, mesh)
            t_lower = time.time() - t0
            _, counts = count_run(cell.fn, cell.args)
            t_compile = time.time() - t0 - t_lower
        rf = analyze(
            spec.name,
            shape_name,
            mesh_name,
            cell.n_chips,
            counts,
            cell.model_flops,
            analytic_flops(spec, shape_name),
            analytic_bytes(spec, shape_name, cell.n_chips),
        )
        row = rf.row()
        row.update(
            {
                "status": "ok",
                "kind": cell.kind,
                "t_lower_s": round(t_lower, 2),
                "t_compile_s": round(t_compile, 2),
            }
        )
        if verbose:
            mem = row["memory_per_device"]["total"] / 2**30
            print(
                f"[dryrun] {spec.name:>22} {shape_name:<12} {mesh_name:<8} OK "
                f"comp={rf.t_compute*1e3:.2f}ms mem={rf.t_memory*1e3:.2f}ms "
                f"coll={rf.t_collective*1e3:.2f}ms bneck={rf.bottleneck:<10} "
                f"useful={rf.useful_flops_ratio:.2f} mem/dev={mem:.2f}GiB "
                f"(build {t_lower:.0f}s run {t_compile:.0f}s)",
                flush=True,
            )
        return row
    except Exception as e:
        if verbose:
            print(f"[dryrun] {spec.name:>22} {shape_name:<12} {mesh_name:<8} FAIL {e}", flush=True)
        return {
            "arch": spec.name,
            "shape": shape_name,
            "mesh": mesh_name,
            "status": "fail",
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-4000:],
        }


def save_row(row: dict):
    os.makedirs(ART_DIR, exist_ok=True)
    path = os.path.join(ART_DIR, f"{row['arch']}__{row['shape']}__{row['mesh']}.json")
    with open(path, "w") as f:
        json.dump(row, f, indent=1, default=str)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh (512 ranks)")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multipod,)

    rows = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                row = run_cell(a, s, mp)
                save_row(row)
                rows.append(row)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    n_fail = sum(r["status"] == "fail" for r in rows)
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail / {len(rows)} cells")
    if n_fail:
        for r in rows:
            if r["status"] == "fail":
                print(f"  FAIL {r['arch']} {r['shape']} {r['mesh']}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
