"""Roofline terms of a dry-run cell (the counterpart of
``repro.launch.roofline``), from what one rank runs.

Terms per (arch x shape x mesh), all in seconds, predicted for one NVIDIA
H100 SXM at its published peaks (NVIDIA's H100 data sheet, SXM part, dense
rates, 700 W):

  compute    = per-rank flops / (989 TFLOP/s bf16 dense)
  memory     = per-rank bytes / (3.35 TB/s HBM3)
  collective = per-rank collective bytes / (50 GB/s: one 400 Gb/s NDR
               InfiniBand port, the one inter-node link of a GPU; the
               single-link divisor is as conservative as the JAX module's)

There is no compiled program to ask. A dry run (``launch.dryrun``) runs the
cell's step eagerly on ``meta`` DTensors over a fake process group, and
``RankCounter`` counts what the rank runs: it is a dispatch mode that hands
every DTensor op back to DTensor, so what reaches it are the ops DTensor
issues on this rank's local blocks (and the collectives it issues between
them). So its flops are per rank, as XLA's ``cost_analysis`` is per
partitioned device; a counter that saw the DTensor ops would count the
whole mesh's. Collective bytes are the result shape of every
``_c10d_functional`` collective the rank issues (the convention of the JAX
module's HLO parse: per-device shard shapes, the bytes that hit this rank's
links). The eager run executes every micro-batch and layer, so nothing
needs the JAX module's loop-trip weighting (``loop_correction`` comes out
about 1).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.engine import H100_BF16_FLOPS, H100_HBM_BW, H100_LINK_BW
from ..nn.module import tree_leaves

DTYPE_BYTES = {
    "pred": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "bf16": 2,
    "f16": 2,
    "s32": 4,
    "u32": 4,
    "f32": 4,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "c64": 8,
    "c128": 16,
}
# torch's dtypes under the JAX module's (XLA's) names
DTYPE_NAMES = {
    torch.bool: "pred",
    torch.int8: "s8",
    torch.uint8: "u8",
    torch.int16: "s16",
    torch.bfloat16: "bf16",
    torch.float16: "f16",
    torch.int32: "s32",
    torch.float32: "f32",
    torch.int64: "s64",
    torch.float64: "f64",
    torch.complex64: "c64",
    torch.complex128: "c128",
}

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# ``_c10d_functional`` ops (less ``_coalesced`` and a trailing ``_``) by kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
_C10D_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_PROPAGATOR_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES[DTYPE_NAMES[t.dtype]]


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in map(_local, tree_leaves(tree)) if isinstance(t, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the Python stack: the
    ops it runs (a decomposition on placeholder tensors of global shape, the
    device mesh it makes for them) derive a placement, and no rank runs
    them."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATOR_FILE):
            return True
        f = f.f_back
    return False


def _storage_key(t):
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class RankCounts:
    """What one rank ran: flops of its local ops, their input plus output
    bytes, collective result bytes and op counts by kind, and memory in
    ``memory_analysis``' terms (bytes)."""

    flops: float
    bytes_accessed: float
    collective_bytes: dict
    collective_counts: dict
    memory: dict


class RankCounter(TorchDispatchMode):
    """Counts one rank's work while it is entered (see the module docstring).

    An op with a tensor subclass among its arguments (a DTensor, a
    collective's async result) returns ``NotImplemented``, so the subclass
    runs it and its ops on plain tensors come back here. DTensor's sharding
    propagation runs ops of global shape under a ``FakeTensorMode``, which
    sits below every other mode: while one is active an op passes
    through uncounted. Where it derives a strategy from an op's
    decomposition, it runs the decomposition on ``meta`` tensors of global
    shape it makes for the purpose: an op called from the sharding
    propagator passes through uncounted too. Per local op:
    flops by ``torch.utils.flop_counter``'s formulas, the bytes of its
    tensor inputs and outputs (view ops move none), and the bytes of every
    storage it creates, live until the storage is freed, for the peak."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collective_bytes = {k: 0.0 for k in COLLECTIVE_OPS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages as live (a run's arguments); their bytes."""
        return sum(self._track(t) for t in tensors)

    def _track(self, t) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key):
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        fake_mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        if fake_mode is not None or any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return NotImplemented
        if _in_sharding_propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if func.namespace in _C10D_NAMESPACES:
            if name not in _NOT_COLLECTIVES:
                kind = _COLLECTIVE_KIND.get(name.removesuffix("_").removesuffix("_coalesced"), name)
                self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) + sum(map(tensor_bytes, outs))
                self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
        elif not getattr(func, "is_view", False):
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t)
        return out


def count_run(fn, args) -> tuple[object, RankCounts]:
    """``fn(*args)`` under a ``RankCounter``: its result and this rank's counts.

    Memory, as XLA's ``memory_analysis``: ``arguments`` the local blocks of
    ``args``; ``outputs`` those of the result not in an argument's storage
    (a donated buffer written in place is counted once, as an argument);
    ``temps`` the peak of live local bytes during the run above the
    arguments and outputs (what XLA's temp buffers hold); ``code`` 0."""
    counter = RankCounter()
    arg_tensors = _tensors(args)
    arguments = counter.hold(arg_tensors)
    with counter:
        out = fn(*args)
    arg_keys = {_storage_key(t) for t in arg_tensors}
    out_keys = {}
    for t in _tensors(out):
        if _storage_key(t) not in arg_keys:
            out_keys[_storage_key(t)] = t.untyped_storage().nbytes()
    outputs = sum(out_keys.values())
    temps = max(0, counter.peak - arguments - outputs)
    memory = {"arguments": arguments, "outputs": outputs, "temps": temps, "code": 0,
              "total": arguments + temps + outputs}
    return out, RankCounts(counter.flops, counter.bytes_accessed, dict(counter.collective_bytes),
                           dict(counter.collective_counts), memory)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_counts: dict
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float  # 6ND (train) / 2·N_active·tokens (decode), global
    hlo_flops_global: float
    memory_per_device: dict
    loop_correction: float = 1.0
    hlo_flops_raw: float = 0.0
    bytes_upper_bound: float = 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops_global if self.hlo_flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term floor that is useful model compute:
        (model_flops / chips / peak) / t_total."""
        ideal = self.model_flops / self.n_chips / H100_BF16_FLOPS
        return ideal / self.t_total if self.t_total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collective_counts,
            "memory_per_device": self.memory_per_device,
            "loop_correction": self.loop_correction,
            "hlo_flops_raw_per_device": self.hlo_flops_raw,
            "t_memory_upper_s": self.bytes_upper_bound / H100_HBM_BW,
        }


def analyze(arch, shape, mesh_name, n_chips, counts: RankCounts, model_flops, analytic_total=None,
            analytic_bytes_dev=None) -> Roofline:
    """The JAX module's ``analyze`` on the port's counts. ``analytic_total``
    (global executed flops from ``launch.analytic``) powers the compute
    term and ``analytic_bytes_dev`` the memory term; the counted flops
    calibrate the loop correction that scales the counted bytes (the
    unfused ``bytes_upper_bound``)."""
    hlo_flops = float(counts.flops)
    if analytic_total is None:
        analytic_total = hlo_flops * n_chips
    correction = max(1.0, (analytic_total / n_chips) / hlo_flops) if hlo_flops else 1.0
    flops = analytic_total / n_chips
    bytes_counted = float(counts.bytes_accessed) * correction
    bytes_ = analytic_bytes_dev if analytic_bytes_dev is not None else bytes_counted
    coll = dict(counts.collective_bytes)
    coll_bytes = sum(coll.values())
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        collective_bytes_per_device=coll_bytes,
        collective_counts={**counts.collective_counts, "bytes_by_kind": coll},
        t_compute=flops / H100_BF16_FLOPS,
        t_memory=bytes_ / H100_HBM_BW,
        t_collective=coll_bytes / H100_LINK_BW,
        model_flops=model_flops,
        hlo_flops_global=analytic_total,
        memory_per_device=dict(counts.memory),
        loop_correction=correction,
        hlo_flops_raw=hlo_flops,
        bytes_upper_bound=bytes_counted,
    )
