"""Multi-process serving fleet: R worker processes behind the IPC router.

``FleetServer`` replicates *within* one Python process, where the GIL and
one host thread issuing every replica's segments cap how far
``--replicas`` can scale. This module moves the replicas out of process:
``ProcFleetServer`` spawns R worker processes, each hosting one
``(PlanIR, MultiStreamServer)`` replica group rebuilt from the same
serialized plan, with the sticky deadline-aware ``FleetRouter`` running in
the front process. On one card every worker serves on that card, with its
own CUDA context, streams and graph pools.

Transport
    Control flows over duplex pipes as ``(method, kwargs)`` RPCs with
    per-call timeouts; frame payloads cross in
    ``multiprocessing.shared_memory`` ring buffers sized from the plan's
    input shapes (``ShmRing``), so arrays never pickle through the pipe
    on the hot path (oversized frames fall back to inline transfer).
    Nothing on the card crosses a pipe: a CUDA frame is copied to the host
    once in the front (``_encode_frame``) and uploaded by the worker to its
    own device; a worker ships its drained outputs as host copies in a
    shared-memory block (``_ship_outputs``), and its reports carry no
    tensors. Workers are spawned with the ``spawn``
    start method only — CUDA cannot be used in a forked child.

Determinism
    The plan crosses as its pinned ``PlanIR`` JSON and models re-stage
    from the same seeded build parameters on the same device (the spec
    carries ``device``: a CUDA generator draws other numbers than a CPU
    one), with the front's TF32 settings, so a worker's replica group is
    bit-identical to one built in-process. Routing is sticky per stream
    (frame order is preserved per stream), so per-stream outputs from a
    2-worker fleet are bit-exact vs a single executor fed the same
    arrivals — the ``workers=0`` in-process fleet stays the fast path
    and the oracle for that pin.

Kernels
    The front builds every kernel library the plan's implementations need
    before it spawns (``_prebuild``), so no worker runs ``nvcc``; a worker
    that still finds no library, or whose CUDA-graph capture fails in its
    warm-up, fails its ``ready`` with the error, and ``ProcFleetServer``
    raises rather than serve with fewer workers. Kernel launch counters
    are per process: each worker returns its own in ``counters``.

Calibration
    Workers' replanners each hold a process-local ``OnlineCost``. The
    front periodically pulls every worker's raw EMA sums, merges them
    magnitude-weighted (``merge_calibration`` — the same weighted-ratio
    idiom ``OnlineCost.observe`` applies per sample), broadcasts the
    merged state back, and mirrors it into a front-process ``OnlineCost``
    whose atomic ``save_calibration`` keeps ``--calibration-cache`` as
    the restart path (workers warm-start from it on spawn).

Failure
    A worker that dies or misses a heartbeat (any RPC error/timeout) is
    evicted: the router unpins its sticky streams so they re-route to
    survivors, and the event is recorded under ``worker_failures`` in
    the fleet report.
"""
from __future__ import annotations

import atexit
import dataclasses
import math
import os
import time
import traceback
import warnings
from multiprocessing import get_context, shared_memory
from typing import Any

import numpy as np
import torch

from ..core.cost_model import OnlineCost, make_cost_provider
from ..nn.module import tree_leaves, tree_map, tree_unflatten
from .fleet import FleetRouter
from .metrics import fleet_report, metrics_from_payload

_COST_NAMES = ("analytic", "measured", "blended", "online")
# intra-op threads of a CPU worker: R workers on torch's default count each
# would oversubscribe the host. The bits of torch's CPU convolutions depend
# on the count, so a bit-exact comparison on the CPU runs its reference on
# as many threads.
_CPU_WORKER_THREADS = 1


class WorkerError(RuntimeError):
    """A worker RPC failed (remote exception or transport fault)."""


class WorkerTimeout(WorkerError):
    """No reply within the per-call deadline — a missed heartbeat."""


class WorkerDied(WorkerError):
    """The worker process is gone (EOF / broken pipe / not started)."""


# ---------------------------------------------------------------------------
# Shared-memory frame transport
# ---------------------------------------------------------------------------


class ShmRing:
    """Fixed-slot shared-memory ring buffer for frame payloads.

    The front process creates one ring per worker, sized from the plan's
    input shapes (``slot_bytes`` covers the largest expected frame);
    ``put`` copies an array into the next slot round-robin and returns a
    JSON-able descriptor the worker resolves with ``read``. Slot reuse
    is safe without per-slot locks because every offer is a synchronous
    RPC: the worker copies the payload out before replying, so by the
    time the ring wraps the earlier slots are free again.
    """

    def __init__(self, slot_bytes: int, slots: int = 8, name: str | None = None):
        if slot_bytes < 1 or slots < 1:
            raise ValueError(f"need positive slot_bytes/slots, got {slot_bytes}/{slots}")
        self.slot_bytes = int(slot_bytes)
        self.slots = int(slots)
        if name is None:
            self.shm = shared_memory.SharedMemory(create=True, size=self.slot_bytes * self.slots)
            self._owner = True
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self._next = 0

    @property
    def name(self) -> str:
        return self.shm.name

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.slot_bytes

    def put(self, arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        if not self.fits(arr.nbytes):
            raise ValueError(f"frame of {arr.nbytes} B exceeds slot size {self.slot_bytes} B")
        slot = self._next
        self._next = (self._next + 1) % self.slots
        off = slot * self.slot_bytes
        self.shm.buf[off : off + arr.nbytes] = arr.tobytes()
        return {"slot": slot, "shape": list(arr.shape), "dtype": str(arr.dtype)}

    def read(self, desc: dict) -> np.ndarray:
        shape = tuple(int(d) for d in desc["shape"])
        dtype = np.dtype(desc["dtype"])
        count = math.prod(shape) if shape else 1
        off = int(desc["slot"]) * self.slot_bytes
        out = np.frombuffer(self.shm.buf, dtype=dtype, count=count, offset=off)
        return out.reshape(shape).copy()

    def close(self):
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self):
        if self._owner:
            try:
                self.shm.unlink()
            except (OSError, FileNotFoundError):
                pass


def _encode_frame(frame: Any, ring: ShmRing | None) -> dict:
    """Frame -> wire descriptor: shared-memory slot when it fits, inline
    array (pipe pickle) as the fallback for oversized payloads. A tensor (on
    the card or the CPU) is copied to the host once, bit for bit."""
    arr = frame.detach().cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
    if ring is not None and ring.fits(arr.nbytes):
        desc = ring.put(arr)
        desc["via"] = "shm"
        return desc
    return {"via": "pipe", "array": arr}


def _decode_frame(desc: dict, ring: ShmRing | None) -> np.ndarray:
    if desc.get("via") == "shm":
        if ring is None:
            raise WorkerError("shm frame descriptor but no ring attached")
        return ring.read(desc)
    return desc["array"]


def _ship_outputs(outs: dict) -> dict:
    """Drained outputs (per stream, trees of tensors) -> wire payload. The
    arrays cross as host copies in one new shared-memory block, which the
    front copies out and unlinks (``_receive_outputs``): a CUDA tensor
    would cross a pipe as an IPC handle whose storage this process must
    keep alive, and a pipe is slow for bulk data where the kernel
    interposes on every read (``chip_smoke.py``'s fleet phase prints the
    host's pipe rate). The pipe carries each tree's structure and its
    leaves' offsets, shapes and dtypes."""
    host = {name: [tree_map(lambda t: t.detach().cpu().numpy(), o) for o in vals] for name, vals in outs.items()}
    total = sum(a.nbytes for vals in host.values() for o in vals for a in tree_leaves(o))
    shm = shared_memory.SharedMemory(create=True, size=total) if total else None
    off, payload = 0, {}
    try:
        for name, vals in host.items():
            entries = []
            for o in vals:
                leaves = []
                for a in tree_leaves(o):
                    a = np.ascontiguousarray(a)
                    if a.nbytes:
                        shm.buf[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
                    leaves.append((off, a.shape, a.dtype.str))
                    off += a.nbytes
                entries.append((tree_map(lambda a: 0, o), leaves))
            payload[name] = entries
    finally:
        if shm is not None:
            shm.close()
    return {"shm": shm.name if shm is not None else None, "streams": payload}


def _receive_outputs(payload: dict) -> dict:
    """Wire payload of ``_ship_outputs`` -> per-stream lists of trees of CPU
    tensors, bit for bit; unlinks the shared-memory block."""
    shm = shared_memory.SharedMemory(name=payload["shm"]) if payload["shm"] else None
    try:
        return {
            name: [
                tree_unflatten(template, [
                    torch.from_numpy(
                        np.frombuffer(shm.buf if shm is not None else b"", dtype=np.dtype(dt),
                                      count=math.prod(shape), offset=off)
                        .reshape(shape).copy()
                    )
                    for off, shape, dt in leaves
                ])
                for template, leaves in entries
            ]
            for name, entries in payload["streams"].items()
        }
    finally:
        if shm is not None:
            shm.close()
            shm.unlink()


# ---------------------------------------------------------------------------
# Calibration merge
# ---------------------------------------------------------------------------


def merge_calibration(states: list[dict]) -> dict:
    """Magnitude-weighted merge of per-worker ``OnlineCost.state()`` dicts.

    Per key, the merged (num, den) are the *means* of the contributing
    workers' decayed sums, so the fleet-wide scale is
    ``sum(num_w) / sum(den_w)`` — each worker's vote weighted by its
    decayed expected magnitude, exactly the weighted-ratio idiom
    ``OnlineCost.observe`` applies to individual samples: a worker that
    has only seen near-empty spans cannot swing the fleet calibration
    away from the workers carrying heavyweight segments."""
    merged: dict = {}
    for key in sorted({k for s in states for k in s}):
        pairs = [
            (float(s[key]["num"]), float(s[key]["den"]))
            for s in states
            if key in s and float(s[key]["num"]) > 0.0 and float(s[key]["den"]) > 0.0
        ]
        if not pairs:
            continue
        merged[key] = {
            "num": sum(n for n, _ in pairs) / len(pairs),
            "den": sum(d for _, d in pairs) / len(pairs),
        }
    return merged


# ---------------------------------------------------------------------------
# Kernel libraries
# ---------------------------------------------------------------------------


def _uses_fused_kernels(plan, device: torch.device) -> bool:
    """Whether serving ``plan`` on ``device`` launches the fused serving
    kernels (``kernels/fused``): a segment bound ``pallas_fused`` on a card."""
    return device.type == "cuda" and any(i == "pallas_fused" for b in plan.impl_bindings() for i in b)


def _prebuild(plan, device: torch.device) -> None:
    """Build, in this process, every kernel library serving ``plan`` on
    ``device`` needs, so that no worker runs nvcc."""
    if _uses_fused_kernels(plan, device):
        from ..kernels.fused import kernel

        kernel.build()


def _require_built(plan, device: torch.device) -> None:
    """Raise unless every kernel library serving ``plan`` on ``device``
    needs is already built (a worker never builds one)."""
    if _uses_fused_kernels(plan, device):
        from ..kernels.fused import kernel

        if not kernel.built():
            raise RuntimeError(
                "the fused kernels' library is not built (the front builds it before it spawns workers)"
            )


def _reset_counters(device: torch.device) -> None:
    from .. import kernels

    for c in kernels.launch_counters().values():
        for k in c:
            c[k] = 0
    kernels.reset_graph_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _worker_main(spec: dict, conn) -> None:
    """Entry point of one worker process (``spawn`` target).

    Builds the replica group from the serialized spec — models re-staged
    deterministically from the seeded build params on the spec's device,
    plan rebuilt from its ``PlanIR`` JSON — warms every stream (each
    planned segment's CUDA graph is captured here), then serves RPCs from
    the front-process router. Between RPCs the worker *self-ticks*
    whenever frames are outstanding, so R workers genuinely service their
    streams in parallel; the front's ``poll``/``tick`` RPCs sample load
    and pending counts, they are not what drives service."""
    ring: ShmRing | None = None
    try:
        from .. import kernels
        from ..core.constraints import DLA_ANALOGUE_CONSTRAINTS
        from ..core.engine import DevicePool, jetson_orin_engines
        from ..core.plan_ir import PlanIR
        from .admission import AdmissionConfig
        from .batching import BatchConfig
        from .demo import _build_pix_yolo_models
        from .replanner import ReplanConfig, Replanner
        from .server import MultiStreamServer
        from .streams import StreamSpec
        from .traffic import SLOPolicy

        build = dict(spec["build"])
        base_device = torch.device(build.pop("device"))
        if base_device.type == "cuda" and base_device.index is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [base_device]
        if base_device.type == "cpu":
            torch.set_num_threads(_CPU_WORKER_THREADS)
        torch.backends.cudnn.allow_tf32 = spec["tf32"]["cudnn"]
        torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]["matmul"]
        gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
        pool = DevicePool((dla, gpu), devices=devices).worker_pool(spec["worker"], spec["n_workers"])
        device = pool.devices[0]
        plan = PlanIR.from_json(spec["plan_json"])
        models, _, (gpu, dla) = _build_pix_yolo_models(**build, device=device)
        _require_built(plan, device)
        streams = [
            StreamSpec(
                s["name"],
                s["model_index"],
                slo=SLOPolicy(**s["slo"]) if s.get("slo") else None,
            )
            for s in spec["streams"]
        ]

        online: OnlineCost | None = None
        replanner = None
        if spec.get("replan") is not None:
            provider = make_cost_provider(spec.get("cost", "analytic"))
            online = provider if isinstance(provider, OnlineCost) else OnlineCost(base=provider)
            calib = spec.get("calibration_path")
            if calib and os.path.exists(calib):
                try:
                    online.load_calibration(calib)
                except ValueError as e:
                    # scales learned over another base provider: calibrate live
                    warnings.warn(f"calibration {calib} not applicable, re-calibrating: {e}")
            cfg = spec["replan"]
            replanner = Replanner(
                [m.graph for m in models],
                [dla, gpu],
                config=ReplanConfig(**cfg) if cfg else None,
                base_provider=online,
            )
            online = replanner.online  # the instance the executor actually feeds

        skw = spec["server"]
        adm = skw.get("admission")
        server = MultiStreamServer(
            models,
            plan,
            streams,
            max_queue=skw["max_queue"],
            microbatch=skw["microbatch"],
            merge_batches=skw["merge_batches"],
            batching=BatchConfig.from_dict(skw.get("batching")),
            place_fns=pool.place_fns(0, 1),
            dispatch=skw["dispatch"],
            jit_segments=skw["jit_segments"],
            replanner=replanner,
            admission=AdmissionConfig(**adm) if adm else None,
            resolution_flexible=skw["resolution_flexible"],
        )

        if spec.get("warm", True):
            # capture/warm every stream's service path before declaring
            # ready, then wipe the traces: warm frames must pollute
            # neither the metrics window nor the drained outputs
            img = build.get("img", 64)
            z = torch.zeros((1, img, img, 3), device=device)
            for s in streams:
                server.offer(s.name, z)
            server.executor.run_until_drained()
            server.finish()
            server.reset_metrics()
            for frames_out in server.executor.outputs.values():
                frames_out.clear()  # keep the per-stream keys, drop warm frames
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        _reset_counters(device)

        if spec.get("shm"):
            ring = ShmRing(spec["shm"]["slot_bytes"], spec["shm"]["slots"], name=spec["shm"]["name"])
    except Exception as e:  # build failure: tell the front, then exit
        try:
            conn.send(("err", f"worker build failed: {type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}"))
        except (OSError, ValueError, BrokenPipeError):
            pass
        return

    shipped: dict[str, int] = {}  # outputs per stream already sent to the front

    def load_info() -> dict:
        return {
            "load": server.executor.pending + len(server._backlog),
            "pending": server.executor.pending,
        }

    def frame(kw) -> torch.Tensor:
        return torch.from_numpy(_decode_frame(kw["frame"], ring)).to(device)

    def counters() -> dict:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        outside: dict[str, int] = {}
        for c in kernels.launch_counters().values():
            outside.update(c)
        return {
            "launches": outside,
            "graph_launches": dict(kernels.graph_launches),
            "captured_graphs": [len(m.captured_graphs()) for m in models],
            "graph_runners": [sorted(m.__dict__.get("_graph_runners", {})) for m in models],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
            "mem_bytes": torch.cuda.memory_allocated(device) if device.type == "cuda" else 0,
            # the allocator's reservations, the CUDA-graph pools among them
            "reserved_bytes": torch.cuda.memory_reserved(device) if device.type == "cuda" else 0,
            "device": str(device),
        }

    def handle(method: str, kw: dict) -> dict:
        if method == "poll":
            return load_info()
        if method == "offer":
            decision = server.offer(kw["target"], frame(kw))
            return {"decision": decision, **load_info()}
        if method == "submit":
            server.submit(kw["model_index"], frame(kw))
            return load_info()
        if method == "tick":
            if server.executor.pending:
                server.tick()
            return load_info()
        if method == "pump":
            server.pump()
            return load_info()
        if method == "drain":
            outs = server.drain()
            # only the outputs not shipped yet (the front keeps the lists)
            new = {name: vals[shipped.get(name, 0):] for name, vals in outs.items()}
            shipped.update((name, len(vals)) for name, vals in outs.items())
            return {"outputs": _ship_outputs(new), **load_info()}
        if method == "finish":
            server.finish()
            return load_info()
        if method == "reset_metrics":
            server.reset_metrics()
            return load_info()
        if method == "report":
            c = counters()
            # kernel launch counters are per process: the front sums them
            rep = {**server.report(), "launches": {"outside": c["launches"], "replayed": c["graph_launches"]}}
            return {"report": rep, "metrics": server.metrics.to_payload(), **load_info()}
        if method == "counters":
            return {"counters": counters(), **load_info()}
        if method == "reset_counters":
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            _reset_counters(device)
            return load_info()
        if method == "calib_pull":
            return {"state": online.state() if online is not None else {}}
        if method == "calib_push":
            if online is not None:
                online.load_state(kw["state"])
            return {}
        raise ValueError(f"unknown worker RPC {method!r}")

    try:
        conn.send(("ready", {"worker": spec["worker"], "pid": os.getpid()}))
        while True:
            # serve an RPC when one is queued; otherwise self-tick any
            # outstanding work (poll with 0 timeout while busy so service
            # never waits on the front, 50 ms while idle to stay cheap)
            if conn.poll(0 if server.executor.pending else 0.05):
                try:
                    method, kw = conn.recv()
                except (EOFError, OSError):
                    return
                if method == "shutdown":
                    try:
                        conn.send(("ok", {}))
                    except (OSError, ValueError, BrokenPipeError):
                        pass
                    return
                try:
                    conn.send(("ok", handle(method, kw)))
                except (OSError, ValueError, BrokenPipeError):
                    return
                except Exception as e:
                    try:
                        conn.send(("err", f"{type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}"))
                    except (OSError, ValueError, BrokenPipeError):
                        return
            elif server.executor.pending:
                server.tick()
    finally:
        if ring is not None:
            ring.close()
        try:
            conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Front-process worker handle
# ---------------------------------------------------------------------------


class RemoteReplica:
    """Front-process handle to one worker: the ``fleet.LocalReplica``
    surface over the RPC pipe, so the router and the fleet server are
    transport-agnostic. ``load``/``pending`` are caches folded from every
    reply (each RPC reply carries them), so the router's pick metric
    costs no extra round-trips."""

    def __init__(
        self,
        index: int,
        spec: dict,
        ring: ShmRing,
        *,
        ctx,
        rpc_timeout_s: float = 300.0,
        heartbeat_timeout_s: float = 60.0,
    ):
        self.index = index
        self.ring = ring
        self.rpc_timeout_s = rpc_timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.alive = False
        self.load = 0
        self.pending = 0
        self._outputs: dict[str, list] = {}  # every output the worker has shipped, per stream
        self._slos = {
            s["name"]: (s["slo"]["deadline_ms"] / 1e3 if s.get("slo") else None)
            for s in spec["streams"]
        }
        self.conn, child = ctx.Pipe(duplex=True)
        self.process = ctx.Process(
            target=_worker_main, args=(spec, child), name=f"repro-torch-worker-{index}", daemon=True
        )
        self.process.start()
        child.close()

    def wait_ready(self, timeout_s: float):
        """Block until the worker finishes building and warming (ready
        handshake). Split from the constructor so a fleet can spawn all
        workers first and let their builds overlap."""
        tag, payload = self._recv(timeout_s, "start")
        if tag != "ready":
            raise WorkerError(f"worker {self.index} failed to start: {payload}")
        self.alive = True

    # -- transport ----------------------------------------------------------

    def _recv(self, timeout_s: float, method: str):
        try:
            if not self.conn.poll(timeout_s):
                raise WorkerTimeout(f"worker {self.index}: no reply to {method!r} within {timeout_s:.1f}s")
            return self.conn.recv()
        except (EOFError, OSError, BrokenPipeError) as e:
            raise WorkerDied(f"worker {self.index} died during {method!r}: {e!r}") from e

    def call(self, method: str, *, timeout: float | None = None, **kw) -> dict:
        if not self.alive:
            raise WorkerDied(f"worker {self.index} is not alive")
        try:
            self.conn.send((method, kw))
        except (OSError, ValueError, BrokenPipeError) as e:
            raise WorkerDied(f"worker {self.index}: send {method!r} failed: {e!r}") from e
        tag, payload = self._recv(timeout if timeout is not None else self.rpc_timeout_s, method)
        if tag == "err":
            raise WorkerError(f"worker {self.index} {method}: {payload}")
        return payload

    def _fold(self, out: dict) -> dict:
        self.load = int(out.get("load", self.load))
        self.pending = int(out.get("pending", self.pending))
        return out

    # -- LocalReplica surface -----------------------------------------------

    def offer(self, target: int | str, frame: Any) -> str:
        out = self._fold(self.call("offer", target=target, frame=_encode_frame(frame, self.ring)))
        return out["decision"]

    def submit(self, model_index: int, frame: Any):
        self._fold(self.call("submit", model_index=model_index, frame=_encode_frame(frame, self.ring)))

    def tick(self):
        if self.load or self.pending:
            self._fold(self.call("tick"))
        else:
            self.poll_load()

    def poll_load(self) -> int:
        """Heartbeat + load refresh (cheap; tighter timeout than service
        RPCs — a worker that can't answer this has missed its heartbeat)."""
        self._fold(self.call("poll", timeout=self.heartbeat_timeout_s))
        return self.load

    def pump(self):
        self._fold(self.call("pump"))

    def drain(self) -> dict:
        """Every output the worker has served, per stream, as CPU tensors
        (the worker's host arrays, bit for bit). Each drain ships only the
        outputs served since the last one."""
        out = self._fold(self.call("drain", timeout=max(self.rpc_timeout_s, 600.0)))
        for name, vals in _receive_outputs(out["outputs"]).items():
            self._outputs.setdefault(name, []).extend(vals)
        return {name: list(vals) for name, vals in self._outputs.items()}

    def finish(self):
        self._fold(self.call("finish"))

    def reset_metrics(self):
        self._fold(self.call("reset_metrics"))

    def deadline_of(self, stream: str) -> float | None:
        return self._slos.get(stream)

    def report(self) -> dict:
        """Raw worker report RPC: ``{"report", "metrics", ...}`` — the
        fleet server merges the serialized metrics payloads itself."""
        return self._fold(self.call("report"))

    def metrics(self):
        return metrics_from_payload(self.call("report")["metrics"])

    def counters(self) -> dict:
        """The worker's kernel launch counters (outside a graph, and
        replayed), its captured graphs and graph runners per model, and
        its device memory (allocated, reserved, and the peak allocated
        since the last reset)."""
        return self._fold(self.call("counters"))["counters"]

    def reset_counters(self):
        self._fold(self.call("reset_counters"))

    def calib_pull(self) -> dict:
        return self.call("calib_pull")["state"]

    def calib_push(self, state: dict):
        self.call("calib_push", state=state)

    def close(self, graceful: bool = True):
        if self.process is None:
            return
        if graceful and self.alive:
            try:
                self.conn.send(("shutdown", {}))
                if self.conn.poll(5.0):
                    self.conn.recv()
            except (OSError, ValueError, EOFError, BrokenPipeError):
                pass
        self.alive = False
        try:
            self.conn.close()
        except OSError:
            pass
        p, self.process = self.process, None
        p.join(timeout=5.0)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)
        if self.ring is not None:
            self.ring.close()
            self.ring.unlink()
            self.ring = None


# ---------------------------------------------------------------------------
# Front-process fleet server
# ---------------------------------------------------------------------------


class _ProcExecutorView:
    """Duck-typed ``server.executor`` stand-in for open-loop drivers:
    ``pending`` totals the cached outstanding counts across alive
    workers (refreshed from every RPC reply)."""

    def __init__(self, fleet: "ProcFleetServer"):
        self._fleet = fleet

    @property
    def pending(self) -> int:
        return sum(h.pending for h in self._fleet.handles if h.alive)

    @property
    def merge_batches(self) -> list:
        return list(self._fleet.merge_batches)

    @property
    def dispatch(self) -> str:
        return self._fleet.dispatch

    @property
    def captures_graphs(self) -> bool:
        """Whether the workers run their segments as captured CUDA graphs."""
        return self._fleet.captures_graphs


_DEFAULT_BUILD = {
    "img": 64, "base": 8, "n_pix": 4, "n_yolo": 1,
    "seed": 0, "norm": "batch", "granularity": "coarse", "device": None,
}


class ProcFleetServer:
    """R worker *processes* behind the sticky deadline-aware router.

    Mirrors the ``MultiStreamServer``/``FleetServer`` surface (``offer``/
    ``submit``/``tick``/``pump``/``drain``/``finish``/``reset_metrics``/
    ``report``) so the open-loop traffic driver and the benches run
    unchanged. ``close()`` shuts the workers down (also registered with
    ``atexit`` as a safety net); the server is a context manager.

    ``build["device"]`` is where the workers serve: None is the CUDA card
    (and raises without one), ``"cpu"`` the CPU; with several cards and no
    index, worker w takes its slice of them (``DevicePool.worker_pool``).
    ``cost`` must be a provider *name* (the spec crosses a process
    boundary as JSON); ``replan`` is None (off), ``{}`` (default
    ``ReplanConfig``) or a ``ReplanConfig``-field dict. When replanning
    is on, worker calibrations sync fleet-wide every
    ``calib_sync_every`` front ticks (see ``merge_calibration``) and the
    merged state checkpoints atomically to ``calibration_path``.
    ``start_timeout_s`` bounds each worker's build, warm-up and graph
    captures. A CPU worker computes on one intra-op thread
    (``_CPU_WORKER_THREADS``)."""

    def __init__(
        self,
        plan,
        streams,
        *,
        workers: int = 2,
        build: dict | None = None,
        router_seed: int = 0,
        max_queue: int = 4,
        microbatch: int = 1,
        merge_batches: bool | list = False,
        batching=None,
        dispatch: str = "overlapped",
        jit_segments: bool = True,
        admission=None,
        resolution_flexible: bool | list = False,
        cost: str = "analytic",
        replan: dict | None = None,
        calibration_path: str | None = None,
        calib_sync_every: int = 16,
        warm_start: bool = True,
        rpc_timeout_s: float = 300.0,
        start_timeout_s: float = 600.0,
        heartbeat_timeout_s: float = 60.0,
        shm_slots: int = 8,
    ):
        from .demo import resolve_device

        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if cost not in _COST_NAMES:
            raise ValueError(
                f"multi-process fleet needs a serializable cost provider name "
                f"{_COST_NAMES}, got {cost!r}"
            )
        if admission is not None and getattr(admission, "degrade_frame", None) is not None:
            raise ValueError("custom degrade_frame callables cannot cross process boundaries")
        self.plan = plan
        self.streams = list(streams)
        self.n_workers = workers
        self.merge_batches = (
            list(merge_batches) if isinstance(merge_batches, (list, tuple)) else [merge_batches]
        )
        self.dispatch = dispatch
        self.calibration_path = calibration_path
        self.calib_sync_every = calib_sync_every
        self._replan_enabled = replan is not None
        self.worker_failures: list[dict] = []
        self._slos = {s.name: (s.slo.deadline_s if s.slo is not None else None) for s in self.streams}
        self._t0: float | None = None
        self._ticks = 0
        self._closed = False

        build = dict(_DEFAULT_BUILD, **(build or {}))
        device = resolve_device(build["device"])
        build["device"] = str(device)
        self.captures_graphs = jit_segments and device.type == "cuda"
        adm_payload = None
        if admission is not None:
            adm_payload = dataclasses.asdict(admission)
            adm_payload.pop("degrade_frame", None)
        # front-process mirror of the fleet calibration: holds the merged
        # EMA state and owns the atomic --calibration-cache checkpoints
        # (base matches the workers' OnlineCost base so the file round-trips)
        mirror_base = "blended" if cost == "online" else cost
        self._calib = OnlineCost(base=make_cost_provider(mirror_base))
        _prebuild(plan, device)

        img = build.get("img", 64)
        slot_bytes = 4 * img * img * 3  # f32 NHWC frame, batch 1 — the plan's input shape
        ctx = get_context("spawn")  # CUDA cannot be used in a forked child
        self.handles: list[RemoteReplica] = []
        try:
            for w in range(workers):
                ring = ShmRing(slot_bytes, shm_slots)
                spec = {
                    "worker": w,
                    "n_workers": workers,
                    "plan_json": plan.to_json(),
                    "build": build,
                    "tf32": {
                        "cudnn": torch.backends.cudnn.allow_tf32,
                        "matmul": torch.backends.cuda.matmul.allow_tf32,
                    },
                    "streams": [
                        {
                            "name": s.name,
                            "model_index": s.model_index,
                            "slo": (
                                {"deadline_ms": s.slo.deadline_ms, "tier": s.slo.tier, "name": s.slo.name}
                                if s.slo is not None
                                else None
                            ),
                        }
                        for s in self.streams
                    ],
                    "server": {
                        "max_queue": max_queue,
                        "microbatch": microbatch,
                        "merge_batches": merge_batches
                        if isinstance(merge_batches, bool)
                        else list(merge_batches),
                        "batching": batching.to_dict() if batching is not None else None,
                        "dispatch": dispatch,
                        "jit_segments": jit_segments,
                        "admission": adm_payload,
                        "resolution_flexible": resolution_flexible
                        if isinstance(resolution_flexible, bool)
                        else list(resolution_flexible),
                    },
                    "cost": cost,
                    "replan": replan,
                    "calibration_path": calibration_path,
                    "warm": warm_start,
                    "shm": {"name": ring.name, "slots": shm_slots, "slot_bytes": slot_bytes},
                }
                self.handles.append(
                    RemoteReplica(
                        w, spec, ring, ctx=ctx,
                        rpc_timeout_s=rpc_timeout_s,
                        heartbeat_timeout_s=heartbeat_timeout_s,
                    )
                )
            # handshake after spawning everything: worker builds overlap
            for h in self.handles:
                h.wait_ready(start_timeout_s)
        except BaseException:
            for h in self.handles:
                try:
                    h.close(graceful=False)
                except Exception:
                    pass
            raise
        self.router = FleetRouter(workers, seed=router_seed)
        self.executor = _ProcExecutorView(self)
        atexit.register(self.close)

    # -- failure handling ----------------------------------------------------

    def _evict(self, worker: int, reason: str):
        h = self.handles[worker]
        if not h.alive:
            return
        h.alive = False
        migrated = self.router.evict(worker)
        self.worker_failures.append(
            {
                "worker": worker,
                "reason": str(reason),
                "migrated_streams": migrated,
                "lost_in_flight": int(h.pending),
            }
        )
        h.pending = 0
        h.load = 0
        try:
            h.close(graceful=False)
        except Exception:
            pass

    def _alive(self):
        return [(w, h) for w, h in enumerate(self.handles) if h.alive]

    def _loads(self) -> list[int]:
        return [h.load for h in self.handles]

    # -- open-loop intake ----------------------------------------------------

    def offer(self, target: int | str, frame: Any) -> str:
        """Route one arriving frame to a worker, then run that worker's
        admission ladder remotely. A worker that fails mid-offer is
        evicted and the frame re-routes to a survivor."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        for _ in range(self.n_workers):
            if isinstance(target, str):
                w = self.router.route_arrival(target, self._loads(), self._slos.get(target))
            else:
                w = self.router.pick(self._loads())
                self.router.routed_frames[w] += 1
            try:
                return self.handles[w].offer(target, frame)
            except WorkerError as e:
                self._evict(w, f"offer: {e}")
        raise RuntimeError("no alive workers to route to")

    def tick(self):
        """One service pass: tick every busy worker (idle ones get a
        heartbeat poll), plus the periodic fleet-wide calibration sync."""
        self._ticks += 1
        for w, h in self._alive():
            try:
                h.tick()
            except WorkerError as e:
                self._evict(w, f"tick: {e}")
        if self._replan_enabled and self.calib_sync_every and self._ticks % self.calib_sync_every == 0:
            self.sync_calibration()

    def finish(self):
        for w, h in self._alive():
            try:
                h.finish()
            except WorkerError as e:
                self._evict(w, f"finish: {e}")
        if self._replan_enabled:
            self.sync_calibration()

    def reset_metrics(self):
        for w, h in self._alive():
            try:
                h.reset_metrics()
            except WorkerError as e:
                self._evict(w, f"reset_metrics: {e}")
        self.router.reset_counts()
        self._t0 = None

    # -- closed-loop intake --------------------------------------------------

    def submit(self, model_index: int, frame: Any):
        if self._t0 is None:
            self._t0 = time.perf_counter()
        for _ in range(self.n_workers):
            w = self.router.pick(self._loads())
            self.router.routed_frames[w] += 1
            try:
                return self.handles[w].submit(model_index, frame)
            except WorkerError as e:
                self._evict(w, f"submit: {e}")
        raise RuntimeError("no alive workers to route to")

    def pump(self):
        for w, h in self._alive():
            try:
                h.pump()
            except WorkerError as e:
                self._evict(w, f"pump: {e}")

    def drain(self) -> dict:
        outs: dict = {}
        for w, h in self._alive():
            try:
                for name, vals in h.drain().items():
                    outs.setdefault(name, []).extend(vals)
            except WorkerError as e:
                self._evict(w, f"drain: {e}")
        return outs

    # -- kernel counters -----------------------------------------------------

    def counters(self) -> dict:
        """Each alive worker's ``counters()`` by worker index, and the
        fleet's kernel launches summed over them (``launches`` outside a
        graph, ``graph_launches`` replayed)."""
        per = {}
        for w, h in self._alive():
            try:
                per[w] = h.counters()
            except WorkerError as e:
                self._evict(w, f"counters: {e}")
        total: dict[str, dict[str, int]] = {"launches": {}, "graph_launches": {}}
        for c in per.values():
            for kind in total:
                for k, v in c[kind].items():
                    total[kind][k] = total[kind].get(k, 0) + v
        return {"per_worker": per, **total}

    def reset_counters(self):
        """Zero every worker's kernel launch counters and peak memory."""
        for w, h in self._alive():
            try:
                h.reset_counters()
            except WorkerError as e:
                self._evict(w, f"reset_counters: {e}")

    # -- calibration sync ----------------------------------------------------

    def sync_calibration(self) -> dict:
        """Pull every worker's raw EMA sums, merge magnitude-weighted,
        broadcast the merged state back, mirror it into the front-process
        ``OnlineCost`` and checkpoint ``calibration_path`` atomically.
        Returns the merged state (empty when nothing is calibrated)."""
        states = []
        for w, h in self._alive():
            try:
                st = h.calib_pull()
                if st:
                    states.append(st)
            except WorkerError as e:
                self._evict(w, f"calib_pull: {e}")
        merged = merge_calibration(states)
        if not merged:
            return {}
        self._calib.load_state(merged)
        for w, h in self._alive():
            try:
                h.calib_push(merged)
            except WorkerError as e:
                self._evict(w, f"calib_push: {e}")
        if self.calibration_path:
            try:
                self._calib.save_calibration(self.calibration_path)
            except OSError:
                pass
        return merged

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """Fleet-merged serving report over the front wall clock: worker
        metrics ledgers cross as serialized payloads and merge through
        the same ``fleet_report`` the in-process fleet uses, plus router
        state, per-worker reports, the failure log, and the kernel
        launches summed over the alive workers (``launches``: outside a
        graph and replayed, since each worker's last counter reset)."""
        wall = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        payloads, reps, alive_workers = [], [], []
        for w, h in self._alive():
            try:
                out = h.report()
                payloads.append(out["metrics"])
                reps.append(out["report"])
                alive_workers.append(w)
            except WorkerError as e:
                self._evict(w, f"report: {e}")
        if not payloads:
            raise RuntimeError("no alive workers to report")
        rep = fleet_report(
            [metrics_from_payload(p) for p in payloads],
            wall,
            routed_counts=self.router.routed_frames,
        )
        rep["workers"] = self.n_workers
        rep["alive_workers"] = alive_workers
        rep["dispatch"] = self.dispatch
        rep["plan_revision"] = max((r.get("plan_revision", 0) for r in reps), default=0)
        rep["router"] = self.router.summary()
        rep["worker_failures"] = list(self.worker_failures)
        rep["launches"] = {
            kind: {
                k: sum(r["launches"][kind].get(k, 0) for r in reps)
                for k in sorted({k for r in reps for k in r["launches"][kind]})
            }
            for kind in ("outside", "replayed")
        }
        rep["per_worker"] = reps
        if self._replan_enabled:
            rep["replan"] = [r.get("replan") for r in reps]
            rep["fleet_calibration"] = self._calib.snapshot()
        return rep

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Shut every worker down (graceful RPC, then terminate) and
        release the shared-memory rings. Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            atexit.unregister(self.close)
        except Exception:
            pass
        for h in self.handles:
            try:
                h.close()
            except Exception:
                pass

    def __enter__(self) -> "ProcFleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
