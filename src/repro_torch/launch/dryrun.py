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


# the dry run's cells on ranks with data: the seven families at smoke width
# in f32 (prefill B 4 x S 16; batch-8 decode and batch-1 decode on
# sequence-split caches of DATA_CACHE_LEN slots, DATA_STEPS steps so that
# the ring buffer wraps and MLA's write clamps; the train step where no
# other check holds it on a split mesh), each held to one process's
DATA_ARCHS = ("deepseek_moe_16b", "deepseek_v2_lite_16b", "gemma2_2b", "hymba_1_5b", "mamba2_2_7b",
              "qwen2_vl_7b", "whisper_small")
DATA_CASES = tuple((a, k) for k in ("prefill", "decode", "long") for a in DATA_ARCHS) + tuple(
    (a, "train") for a in ("whisper_small", "qwen2_vl_7b"))
DATA_B, DATA_S, DATA_DECODE_B, DATA_CACHE_LEN, DATA_STEPS, DATA_N_IMG = 4, 16, 8, 8, 10, 4
DATA_TOL = 1e-5  # of each reference leaf's largest magnitude


class _GradRecorder:
    """An optimizer that keeps the gradients it is given and updates
    nothing."""

    grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


def _data_inputs(arch, kind, model):
    """The case's inputs as numpy arrays, drawn from one seed."""
    import numpy as np

    from ..nn.module import tree_map

    cfg = model.cfg
    rng = np.random.default_rng(11)
    if kind in ("decode", "long"):
        batch = DATA_DECODE_B if kind == "decode" else 1
        caches = model.init_caches(batch, DATA_CACHE_LEN, dtype=torch.float32)
        return {"tokens": rng.integers(0, cfg.vocab, (DATA_STEPS, batch, 1)).astype(np.int32),
                "caches": tree_map(lambda c: rng.standard_normal(tuple(c.shape)).astype(np.float32), caches)}
    B, S = DATA_B, DATA_S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if arch == "whisper_small":
        out["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if kind == "train" and getattr(cfg, "mrope_sections", None):
        out["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
        out["extra_embeds"] = rng.standard_normal((B, DATA_N_IMG, cfg.d_model)).astype(np.float32)
        out["embed_positions"] = np.stack([rng.permutation(S)[:DATA_N_IMG] for _ in range(B)]).astype(
            np.int32)
    return out


def data_outputs(arch: str, kind: str, mesh=None) -> list:
    """One case of ``DATA_CASES``: ``arch``'s smoke config in f32 (f32
    caches), the parameters of seed 0, its ``kind`` step on the inputs of
    one numpy seed, and every output as a whole tensor (the logits of each
    step and each cache leaf; the loss and each gradient). On plain
    tensors without ``mesh``; on ``mesh`` placed as the cells are: a
    serving step's parameters by ``default_rules(False, ...)``, its batch
    over the data-like dims, its caches by ``cache_shardings`` (on the
    sequence at batch 1); a train step's by ``train_shardings`` and
    ``shard_batch``, without ``act_spec``. Each decode step takes its
    position as a 0-d int32 tensor (replicated on ``mesh``) and writes into
    the caches it is given, as the dry run's decode cell does, and must
    return them (it raises otherwise)."""
    from ..configs import build_model
    from ..data import shard_batch
    from ..dist.sharding import (NamedSharding, P, batch_sharding, cache_shardings, default_rules, device_put,
                                 mesh_ops, on_mesh, to_global, train_shardings, tree_shardings_shaped)
    from ..nn.module import tree_leaves, tree_map
    from ..train.optimizer import AdamW
    from ..train.steps import make_lm_train_step

    model = build_model(dataclasses.replace(get_arch(arch).smoke, act_dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    host = _data_inputs(arch, kind, model)
    if kind == "train":
        rec = _GradRecorder()
        batch, step = tree_map(torch.from_numpy, host), make_lm_train_step(model, rec)
        if mesh is not None:
            sh = train_shardings(mesh, model.axes(), model.abstract(), AdamW(lr=1e-3).init(params), DATA_B)
            params, batch, step = device_put(params, sh.params), shard_batch(host, sh.batch), on_mesh(step)
        _, _, m = step(params, {}, batch)
        return [to_global(m["loss"])] + [to_global(g) for g in tree_leaves(rec.grads)]

    def put(x, sharding):
        return x if mesh is None else device_put(x, sharding)

    caches = tree_map(torch.from_numpy, host.get("caches", {}))
    bsh = psh = csh = None
    if mesh is not None:
        rules = default_rules(False, mesh.mesh_dim_names)
        bsh = batch_sharding(mesh, host["tokens"].shape[-2] if kind != "prefill" else DATA_B, rules)
        psh = tree_shardings_shaped(mesh, model.axes(), params, rules)
        csh = cache_shardings(mesh, caches, rules, seq_sharded=kind == "long") if caches else None
    params = put(params, psh)
    with torch.no_grad(), mesh_ops():
        if kind == "prefill":
            logits, caches = model.prefill(params, *(put(torch.from_numpy(host[k]), bsh)
                                                     for k in ("frames", "tokens") if k in host))
            outs = [logits]
        else:
            caches, outs = put(caches, csh), []
            given = tree_leaves(caches)
            rep = None if mesh is None else NamedSharding(mesh, P())
            for t in range(DATA_STEPS):
                token = put(torch.from_numpy(host["tokens"][t]), bsh)
                # the position a replicated int32 scalar, as the dry run's decode cell passes it
                position = put(torch.tensor(t, dtype=torch.int32), rep)
                logits, caches = model.decode_step(params, token, caches, position)
                if any(a is not b for a, b in zip(tree_leaves(caches), given, strict=True)):
                    raise AssertionError(f"{arch} {kind} step {t}: the decode returned other caches than its own")
                outs.append(logits)
        return [to_global(x) for x in outs + tree_leaves(caches)]


def data_error(got: list, want: list) -> float:
    """The largest of the leaves' max |got - want| over max |want| (inf
    where the leaves' count, a shape or a dtype differs, or a zero leaf
    is not matched exactly)."""
    worst = 0.0
    if len(got) != len(want):
        return float("inf")
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if not a.numel():
            continue
        err, top = float((a - b).abs().max()), float(b.abs().max())
        worst = max(worst, err / top if top else (0.0 if err == 0 else float("inf")))
    return worst


def data_rank(kind: str, mesh) -> dict:
    """Every ``DATA_CASES`` case of ``kind`` on this rank's ``mesh``:
    ``{arch: outputs}``, or the traceback a case raised (the ranks raise
    alike, before the op's collectives, and go on together)."""
    got = {}
    for arch, k in DATA_CASES:
        if k == kind:
            try:
                got[arch] = data_outputs(arch, kind, mesh)
            except Exception:
                got[arch] = traceback.format_exc()
    return got


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
