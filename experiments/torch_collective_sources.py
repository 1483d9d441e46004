"""One dry-run cell's collectives, grouped by the port's source line that
issued each one.

  PYTHONPATH=src python experiments/torch_collective_sources.py --arch mamba2_2_7b --shape decode_32k
  PYTHONPATH=src python experiments/torch_collective_sources.py --arch gemma2_2b --shape train_4k \
      --multipod --json sources.json
  python experiments/torch_collective_sources.py --compare a.json b.json

The cell takes ``launch.dryrun.run_cell``'s path (``launch.specs.build_cell``
on ``meta`` DTensors over a fake group of 256 ranks, or 512 with
``--multipod``) and runs under a ``launch.roofline.RankCounter`` that also
reads the Python stack at every collective rank 0 issues. Each collective
is charged to two lines of ``repro_torch`` and an op: ``source``, the
innermost frame outside ``dist/`` and ``launch/``; ``model``, the innermost
frame in ``models/`` (the layer loop's line that reached it); and the aten
op whose operands DTensor's dispatcher redistributed ("redistribute" where
the port redistributed itself). A collective of the backward is charged to
the line that started the backward, with the autograd node that issued it
(``[MmBackward0]``); one of remat's recompute, to its forward line and that
node. Prints one row per (kind, source, model, op): count and result bytes
a rank, largest first, then the totals by kind and ``torch.__version__``;
``--json`` writes the same rows, and ``--compare`` prints where two such
files differ, line by line (two torch versions, or two trees). ``--carry
split`` runs the layer loops with the residual carried split on its hidden
dim over "model" instead of whole (``dist.carry_placements``), the
alternative the port measured and did not take. Nothing is allocated, and
no CUDA context is made.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import dry_run  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.nn.module import tree_leaves  # noqa: E402

PKG = os.path.dirname(os.path.dirname(os.path.abspath(roofline.__file__))) + os.sep
_SKIP = (os.sep + "dist" + os.sep, os.sep + "launch" + os.sep)
_DISPATCH_FILE = os.path.join("distributed", "tensor", "_dispatch.py")


def _where(frame):
    """(source, model, op): the innermost ``repro_torch`` frame outside
    ``dist/`` and ``launch/``, and the innermost one in ``models/``, each
    as ``path:line`` relative to the package (None where there is none),
    and the aten op whose operands DTensor's dispatcher was redistributing
    ("redistribute" where the port called ``redistribute`` itself)."""
    source = model = op = None
    while frame is not None and (source is None or model is None):
        path = os.path.abspath(frame.f_code.co_filename)
        if op is None and path.endswith(_DISPATCH_FILE) and "op_call" in frame.f_locals:
            op = str(frame.f_locals["op_call"])
        if path.startswith(PKG):
            rel = os.path.relpath(path, PKG)
            if source is None and not any(s in os.sep + rel for s in _SKIP):
                source = f"{rel}:{frame.f_lineno}"
            if model is None and rel.startswith("models" + os.sep):
                model = f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return source, model, op or "redistribute"


class SourceCounter(roofline.RankCounter):
    """A ``RankCounter`` that also keeps, for every collective it counts,
    the lines and op ``_where`` names: ``rows[(kind, source, model, op)] =
    [count, bytes]``."""

    def __init__(self):
        super().__init__()
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.collective_counts)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or before == self.collective_counts:
            return out
        kind = next(k for k, n in self.collective_counts.items() if n != before.get(k, 0))
        nbytes = sum(roofline.tensor_bytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        source, model, op = _where(sys._getframe(1))
        node = torch._C._current_autograd_node()
        if node is not None:  # a backward: the autograd node that issued it
            source = f"{source} [{node.name()}]"
        row = self.rows.setdefault((kind, source, model, op), [0, 0])
        row[0] += 1
        row[1] += nbytes
        return out


def split_carry_placements(x):
    """``dist.carry_placements`` with the hidden dim split over the
    tensor-parallel mesh dims (a layer's partial sum reduce-scattered):
    the carry the port does not take, for ``--carry split``."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import carry_placements

    pl = carry_placements(x)
    if pl is None:
        return None
    mesh = x.device_mesh
    return tuple(Shard(x.ndim - 1) if name in ("model", "tensor") and mesh.size(m) > 1 else p
                 for m, (name, p) in enumerate(zip(mesh.mesh_dim_names, pl)))


def sources(arch: str, shape: str, multi_pod: bool = False, carry: str = "replicated") -> dict:
    """The cell's collectives: ``{"rows": [...], "totals": {kind: [count,
    bytes]}, "torch": version, "host_s": seconds}``; ``carry="split"``
    runs the layer loops with ``split_carry_placements``."""
    if carry == "split":
        from repro_torch.models import hymba, lm, mamba2, whisper

        for m in (hymba, lm, mamba2, whisper):
            m.carry_placements = split_carry_placements
    spec = get_arch(arch)
    t0 = time.time()
    with dry_run(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        cell = build_cell(spec, shape, mesh)
        counter = SourceCounter()
        counter.hold(roofline._tensors(cell.args))
        with counter:
            cell.fn(*cell.args)
    rows = sorted(({"kind": k, "source": s, "model": m, "op": o, "count": c, "bytes": b}
                   for (k, s, m, o), (c, b) in counter.rows.items()), key=lambda r: (-r["bytes"], -r["count"]))
    totals = {k: [n, counter.collective_bytes[k]] for k, n in counter.collective_counts.items() if n}
    return {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16", "carry": carry, "rows": rows,
            "totals": totals, "torch": torch.__version__, "host_s": round(time.time() - t0, 1)}


def report(res: dict) -> str:
    lines = [f"{res['arch']} {res['shape']} {res['mesh']}, {res['carry']} carry, torch {res['torch']} "
             f"({res['host_s']} s on the host)"]
    for r in res["rows"]:
        lines.append(f"  {r['kind']:<15} {r['count']:>6} {r['bytes'] / 1e6:>12.4f} MB  {r['source']}"
                     f"  via {r['model']}  ({r['op']})")
    tot = ", ".join(f"{k} {n} ({b / 1e6:.4f} MB)" for k, (n, b) in res["totals"].items()) or "none"
    lines.append(f"  totals: {tot}")
    return "\n".join(lines)


def compare(a: dict, b: dict) -> str:
    """Two ``sources`` results of one cell (two torch versions, two trees)
    line by line: every (source, op, kind) whose count or bytes differ,
    largest bytes first, with each side's count and MB."""
    def totals(res):
        out = {}
        for r in res["rows"]:
            c = out.setdefault((r["source"], r["op"], r["kind"]), [0, 0.0])
            c[0] += r["count"]
            c[1] += r["bytes"] / 1e6
        return out

    ta, tb = totals(a), totals(b)
    diff = [(max(x[1], y[1]), k, x, y) for k in set(ta) | set(tb)
            for x, y in [(ta.get(k, [0, 0.0]), tb.get(k, [0, 0.0]))] if x != y]
    lines = [f"{a['arch']} {a['shape']} {a['mesh']}: torch {a['torch']} | torch {b['torch']} (count, MB a rank)"]
    for _, (source, op, kind), x, y in sorted(diff, key=lambda d: (-d[0], d[1])):
        lines.append(f"  {source:<48} {op:<28} {kind:<15} {x[0]:>6} {x[1]:>14.2f} | {y[0]:>6} {y[1]:>14.2f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", nargs=2, metavar="JSON", help="print where two --json results differ, and exit")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh (512 ranks)")
    ap.add_argument("--carry", choices=("replicated", "split"), default="replicated",
                    help="the layer loops' carry: the port's (replicated over 'model') or the hidden dim split")
    ap.add_argument("--json", default=None, help="write the rows here too")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.load(open(f)) for f in args.compare)
        print(compare(a, b))
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required")
    res = sources(args.arch, args.shape, args.multipod, args.carry)
    print(report(res), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
