"""Cost providers + roofline cost model over layer graphs and engine specs.

Per-layer time on an engine is the roofline max(flops/peak, bytes/bw);
"inefficient" (but legal) layers pay a derate. Transfers between engines
cost boundary_bytes / link_bw plus a fixed switch overhead — this is what
makes fallback expensive and what the HaX-CoNN balance search trades off.

Where the flop/byte numbers come from is pluggable (the ``CostProvider``
protocol): ``AnalyticCost`` uses the LayerMeta estimates as-built,
``MeasuredCost`` re-derives them per layer by counting the ops the port
runs on meta tensors (``core.profiler``) and caches the resulting
per-(layer, engine, dtype) timings to a JSON file so repeated planning runs
do not re-count, ``BlendedCost`` takes measured numbers where a measurement
exists and falls back to analytic elsewhere, and ``OnlineCost`` scales a
base provider by live-calibrated per-engine EMAs of observed wall time.
The timing cache and the calibration file keep the JAX package's wire
formats, so either package loads what the other wrote. The scheduler and
the partition heuristics consume only the provider interface, so one flag
switches the whole plan->execute pipeline from paper-mode analytic
planning to measured planning.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading

from .graph import LayerGraph, LayerMeta


SWITCH_OVERHEAD = 25e-6  # s; engine handoff latency (DeepStream/TensorRT-like)
INEFFICIENT_DERATE = 0.5  # achieved fraction of engine flops on mis-aligned layers
BATCH_FIXED_FRAC = 0.25  # fraction of per-frame time that is batch-amortizable


def batch_amortization(batch: int) -> float:
    """Per-frame time multiplier at effective batch ``batch``.

    Models the fixed per-dispatch cost (kernel launch, weight traffic,
    host sync) that a batched executable pays once instead of per frame:
    ``amort(1) == 1.0`` exactly — batch-1 plans are bit-identical to the
    pre-batching planner — and the curve decays toward
    ``1 - BATCH_FIXED_FRAC`` as the bucket grows. ``MeasuredCost``
    replaces this analytic curve with per-bucket counts; this is the
    fallback shape for analytic planning and unmeasured layers."""
    b = max(int(batch), 1)
    return 1.0 - BATCH_FIXED_FRAC * (1.0 - 1.0 / b)


def _effective_flops(l: LayerMeta, engine) -> float:
    """Engine flops achievable on this layer: derated once when any
    'inefficient' violation applies. The derate is deliberately NOT
    compounded per violation — hierarchical metas report one violation
    per mis-aligned primitive, and compounding would derate a composite
    by 0.5^k instead of the 0.5 a mis-aligned block actually costs."""
    if any(v.severity == "inefficient" for v in engine.supports(l)):
        return engine.flops * INEFFICIENT_DERATE
    return engine.flops


def _roofline(flops: float, bytes_accessed: float, l: LayerMeta, engine) -> float:
    eff = _effective_flops(l, engine)
    t_c = flops / eff if eff else 0.0
    t_m = bytes_accessed / engine.hbm_bw
    return max(t_c, t_m)


def layer_time(l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
    """Analytic roofline layer time (the historical default path).

    ``impl="pallas_fused"`` costs marked fused blocks (``attrs["fuse"]``
    on the lead layer) with their fused analytic totals — one HBM round
    trip for the whole block — and their folded members at zero; layers
    without a variant keep the per-layer roofline. ``batch`` > 1 returns
    the *per-frame* time at that effective batch (see
    ``batch_amortization``); batch=1 is the historical value exactly."""
    amort = batch_amortization(batch)
    if impl != "xla":
        fu = l.attrs.get("fuse")
        if fu is not None:
            return _roofline(fu["flops"], fu["bytes"], l, engine) * amort
        if "fused_into" in l.attrs:
            return 0.0
        if l.sublayers:
            return sum(layer_time(p, engine, impl, batch) for p in l.sublayers)
    return _roofline(l.flops, l.bytes_accessed, l, engine) * amort


def transfer_time(nbytes: float, engine) -> float:
    return nbytes / engine.link_bw + SWITCH_OVERHEAD


def is_illegal(l: LayerMeta, engine) -> bool:
    return any(v.severity == "illegal" for v in engine.supports(l))


# ---------------------------------------------------------------------------
# Cost providers
# ---------------------------------------------------------------------------


class CostProvider:
    """Source of per-layer timings for the planner.

    Subclasses override ``layer_time``; ``available`` reports whether the
    provider has a *measured* (non-analytic) number for a layer, which is
    what ``BlendedCost`` keys its fallback on.
    """

    name = "base"

    def layer_time(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
        raise NotImplementedError

    def available(self, l: LayerMeta, impl: str = "xla") -> bool:
        return False

    def describe(self) -> str:
        return self.name


class AnalyticCost(CostProvider):
    """Roofline over the LayerMeta's analytic flop/byte estimates."""

    name = "analytic"

    def layer_time(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
        return layer_time(l, engine, impl, batch)


ANALYTIC = AnalyticCost()


class MeasuredCost(CostProvider):
    """Roofline over counted flop/byte numbers per layer.

    Conv/deconv layers run individually on meta tensors and their counted
    flops and bytes (``core.profiler``) replace the analytic estimates;
    pointwise/norm/concat-style kinds go through a generic elementwise
    stand-in (``profiler._elementwise_cost``), so every segment of the
    serving graphs is covered by a measurement. Composite graph-level
    kinds (c2f, sppf, head, ...) are costed by *expansion*: when the meta
    carries a primitive decomposition (``LayerMeta.sublayers``), its time
    is the sum of the measured primitive times — ``coverage()`` reaches
    1.0 on the YOLO graph. Composites without a decomposition keep the
    analytic numbers; ``available`` reports which. The derived
    per-(layer, engine, dtype) timing is cached in memory and, when
    ``cache_path`` is given, persisted as JSON so later runs (and other
    processes, and the JAX package, whose keys and file format these are)
    skip the counting entirely.
    """

    name = "measured"
    _MEASURABLE = ("conv", "deconv")
    # elementwise kinds measured via the generic stand-ins in core.profiler
    # (kept as a literal so importing cost_model does not import the profiler)
    _ELEMENTWISE = ("act", "tanh", "bn", "norm", "concat", "crop", "pad", "pool", "dropout", "add")

    def __init__(self, cache_path: str | None = None, dtype: str = "bfloat16"):
        self.cache_path = cache_path
        self.dtype = dtype
        self._cache: dict[str, float] = {}
        self.measure_count = 0  # counts performed by this instance
        self.hits = 0
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                payload = json.load(f)
            if payload.get("dtype", dtype) != dtype:
                raise ValueError(
                    f"{cache_path}: cached dtype {payload.get('dtype')!r} != requested {dtype!r}"
                )
            self._cache = dict(payload.get("entries", {}))

    def available(self, l: LayerMeta, impl: str = "xla") -> bool:
        if l.sublayers:
            # composite graph-level kinds (c2f/sppf/head/...) are costed by
            # expansion: measurable iff every primitive in their
            # decomposition is
            return all(self.available(p, impl) for p in l.sublayers)
        if impl != "xla":
            if "fused_into" in l.attrs:
                return True  # cost folds into the group's lead layer
            if "fuse" in l.attrs:
                return l.attrs.get("groups", 1) == 1
        if l.kind in self._MEASURABLE:
            return l.attrs.get("groups", 1) == 1
        return l.kind in self._ELEMENTWISE

    def coverage(self, graph: LayerGraph, impl: str = "xla") -> float:
        """Fraction of a graph's layers served by a measurement (composites
        count as covered when their whole decomposition is)."""
        return sum(self.available(l, impl) for l in graph) / max(len(graph), 1)

    def coverage_report(self, graph: LayerGraph, impls=("xla", "pallas_fused")) -> dict:
        """Per-implementation coverage with the uncovered layer names —
        the gaps a calibration run must fill before ``--impl auto``
        planning is fully measured on this graph."""
        report = {}
        for impl in impls:
            missing = [l.name for l in graph if not self.available(l, impl)]
            report[impl] = {
                "coverage": self.coverage(graph, impl),
                "missing": missing,
            }
        return report

    def _key(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> str:
        shape = "x".join(str(d) for d in l.in_shape)
        a = l.attrs
        sig = f"k{a.get('kernel', 1)}s{a.get('stride', 1)}p{a.get('padding', 0)}"
        base = f"{l.kind}|{shape}|{sig}|c{l.out_shape[-1]}|{engine.name}|{self.dtype}"
        if impl != "xla":
            base = f"{base}|{impl}"
        # per-bucket entries form the amortization curve in the JSON cache;
        # batch=1 keys stay byte-identical to the pre-batching format
        return base if batch == 1 else f"{base}|b{batch}"

    @staticmethod
    def _batched_shape(in_shape, batch: int) -> tuple:
        shape = tuple(in_shape)
        if batch == 1 or not shape:
            return shape
        return (shape[0] * batch,) + shape[1:]

    def _measure(self, l: LayerMeta, batch: int = 1) -> tuple[float, float]:
        from .profiler import _conv_cost, _elementwise_cost

        self.measure_count += 1
        shape = self._batched_shape(l.in_shape, batch)
        if l.kind in self._MEASURABLE:
            flops, bytes_ = _conv_cost(
                shape,
                l.attrs.get("kernel", 1),
                l.attrs.get("stride", 1),
                l.attrs.get("padding", 0),
                l.out_shape[-1],
                l.kind == "deconv",
                self.dtype,
            )
        else:
            flops, bytes_ = _elementwise_cost(l.kind, shape, self.dtype)
        # per-frame numbers at this bucket: weight traffic is counted once
        # by the profiler, so dividing by batch yields a real (sub-linear)
        # amortization curve rather than the analytic approximation
        return flops / batch, bytes_ / batch

    def _measure_fused(self, l: LayerMeta, fu: dict, batch: int = 1) -> tuple[float, float]:
        from .profiler import _fused_cost, _sppf_cost

        self.measure_count += 1
        shape = self._batched_shape(l.in_shape, batch)
        if fu.get("kind") == "pool":
            # SPPF pool pyramid + concat fused into one region
            flops, bytes_ = _sppf_cost(shape, fu.get("window", 5), fu.get("span", 3), self.dtype)
        else:
            flops, bytes_ = _fused_cost(
                shape,
                l.attrs.get("kernel", 1),
                l.attrs.get("stride", 1),
                l.attrs.get("padding", 0),
                l.out_shape[-1],
                fu.get("kind", l.kind) == "deconv",
                fu.get("norm", "none"),
                fu.get("act", "none"),
                self.dtype,
            )
        return flops / batch, bytes_ / batch

    def layer_time(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
        batch = max(int(batch), 1)
        if not self.available(l, impl):
            return layer_time(l, engine, impl, batch)
        if l.sublayers:
            return sum(self.layer_time(p, engine, impl, batch) for p in l.sublayers)
        if impl != "xla":
            if "fused_into" in l.attrs:
                return 0.0
            fu = l.attrs.get("fuse")
            if fu is not None:
                key = self._key(l, engine, impl, batch)
                if key in self._cache:
                    self.hits += 1
                    return self._cache[key]
                flops, bytes_ = self._measure_fused(l, fu, batch)
                t = _roofline(flops or fu["flops"], bytes_ or fu["bytes"], l, engine)
                self._cache[key] = t
                return t
        key = self._key(l, engine, batch=batch)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        flops, bytes_ = self._measure(l, batch)
        t = _roofline(flops or l.flops, bytes_ or l.bytes_accessed, l, engine)
        self._cache[key] = t
        return t

    def save(self, path: str | None = None) -> str:
        path = path or self.cache_path
        if not path:
            raise ValueError("MeasuredCost has no cache_path to save to")
        payload = {"version": 1, "dtype": self.dtype, "entries": self._cache}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @property
    def cache_size(self) -> int:
        return len(self._cache)


class BlendedCost(CostProvider):
    """Measured where a measurement exists, analytic everywhere else."""

    name = "blended"

    def __init__(self, measured: MeasuredCost | None = None, analytic: CostProvider | None = None):
        self.measured = measured or MeasuredCost()
        self.analytic = analytic or ANALYTIC

    def available(self, l: LayerMeta, impl: str = "xla") -> bool:
        return self.measured.available(l, impl)

    def layer_time(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
        if self.measured.available(l, impl):
            return self.measured.layer_time(l, engine, impl, batch)
        return self.analytic.layer_time(l, engine, impl, batch)

    def save(self, path: str | None = None) -> str:
        return self.measured.save(path)


class OnlineCost(CostProvider):
    """Live-calibrated costs: a base provider scaled by a decayed weighted
    ratio of observed vs expected per-segment wall time, one per engine.

    The serving executor reports ``(engine, observed_wall_s, expected_s)``
    per profiled segment (``expected_s`` always in *base-provider* units,
    re-derived from the graphs — never from a previously-scaled plan, so
    the calibration is a fixed base->wall mapping that survives plan
    hot-swaps). The scale is ``EMA(observed) / EMA(expected)`` rather
    than ``EMA(observed/expected)``: numerator and denominator decay
    together, so a sample's influence is proportional to its expected
    magnitude — near-empty spans whose wall is pure host overhead (ratios
    in the thousands) cannot swing the calibration, while heavyweight
    segments dominate it. ``layer_time`` then returns ``base *
    scale(engine)``: the planner ranks engines by what they actually
    deliver right now, which is exactly the signal the re-planner needs
    when thermal state or co-located load skews one engine. The scales
    double as the analytic-units -> wall-clock calibration (the engine
    specs are the Jetson pair's, not the card's).

    One instance may be shared by every replica of a serving fleet: the
    drain is thread-safe (an ``RLock`` guards the EMA state), so all
    replicas' ``SegmentObservation``s fold into a single fleet-wide
    calibration store keyed per (engine, impl).
    """

    name = "online"

    def __init__(self, base: CostProvider | None = None, alpha: float = 0.35):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EMA alpha must be in (0, 1], got {alpha}")
        self.base = base or ANALYTIC
        self.alpha = alpha
        self._num: dict[str, float] = {}  # decayed observed-wall sum
        self._den: dict[str, float] = {}  # decayed expected sum
        self._lock = threading.RLock()  # fleet replicas drain concurrently
        self.observations = 0

    def observe(self, engine_name: str, observed_s: float, expected_s: float):
        """Fold one (observed wall, expected base-units) sample."""
        if observed_s <= 0.0 or expected_s <= 0.0:
            return
        a = self.alpha
        with self._lock:
            if engine_name not in self._num:
                self._num[engine_name] = observed_s
                self._den[engine_name] = expected_s
            else:
                self._num[engine_name] = (1.0 - a) * self._num[engine_name] + a * observed_s
                self._den[engine_name] = (1.0 - a) * self._den[engine_name] + a * expected_s
            self.observations += 1

    def scale(self, engine_name: str) -> float:
        with self._lock:
            den = self._den.get(engine_name, 0.0)
            return self._num[engine_name] / den if den > 0 else 1.0

    def scale_for(self, engine_name: str, impl: str = "xla", batch: int = 1) -> float:
        """Per-(engine, impl, bucket) calibration: non-xla implementations
        get their own drift channel (``"engine|impl"`` keys, fed by the
        executor when a segment ran that variant), and batched segments get
        per-bucket channels (``"...|b{bucket}"``) — the observed-vs-expected
        ratio at each bucket is its own calibration, so a mis-modelled
        amortization curve surfaces as bucket-channel drift. Fallback
        ladder: exact (impl, bucket) -> (engine, bucket) -> impl -> plain
        engine scale."""
        base = f"{engine_name}|{impl}" if impl != "xla" else engine_name
        if batch > 1:
            for key in (f"{base}|b{batch}", f"{engine_name}|b{batch}"):
                if key in self._num:
                    return self.scale(key)
        if impl != "xla" and base in self._num:
            return self.scale(base)
        return self.scale(engine_name)

    def calibrated(self, engine_names) -> bool:
        return all(e in self._num for e in engine_names)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {name: self.scale(name) for name in list(self._num)}

    # -- fleet-wide calibration sync (see serve.multiproc) -------------------

    def state(self) -> dict[str, dict[str, float]]:
        """The raw per-key EMA sums, JSON-able: ``{key: {num, den}}``.
        The sums — not the ratios — are the sync currency: merging them
        keeps each contributor's weight proportional to its decayed
        expected magnitude (the same weighted-ratio idiom ``observe``
        applies to individual samples)."""
        with self._lock:
            return {k: {"num": self._num[k], "den": self._den[k]} for k in self._num}

    def load_state(self, state: dict) -> "OnlineCost":
        """Replace the per-key EMA sums with a (merged) ``state()`` dict.
        Non-positive entries are skipped — a broadcast can never wipe a
        key into an invalid scale. Returns self."""
        with self._lock:
            for name, st in state.items():
                num, den = float(st["num"]), float(st["den"])
                if num <= 0.0 or den <= 0.0:
                    continue
                self._num[name] = num
                self._den[name] = den
        return self

    def layer_time(self, l: LayerMeta, engine, impl: str = "xla", batch: int = 1) -> float:
        return self.base.layer_time(l, engine, impl, batch) * self.scale_for(
            engine.name, impl, batch
        )

    def available(self, l: LayerMeta, impl: str = "xla") -> bool:
        return self.base.available(l, impl)

    def describe(self) -> str:
        scales = ", ".join(f"{k}x{v:.3g}" for k, v in sorted(self.snapshot().items()))
        return f"online({self.base.name}; {scales or 'uncalibrated'})"

    def save(self, path: str | None = None) -> str:
        """Persist the wrapped provider's timing cache (measured/blended
        bases feed the JSON cache; analytic has nothing to save)."""
        if hasattr(self.base, "save"):
            return self.base.save(path)
        raise ValueError(f"OnlineCost over {self.base.name!r} has no timing cache to save")

    # -- calibration persistence (warm-start across process restarts) -------

    def save_calibration(self, path: str) -> str:
        """Write the learned per-engine EMA state to JSON. The decayed
        (observed, expected) sums are stored — not just their ratio — so a
        restarted process resumes the EMA with the same sample weighting
        it shut down with.

        The write is atomic for *concurrent* writers: each write goes to
        a uniquely-named temp file in the target directory, then
        ``os.replace``s into place. A fixed ``path + ".tmp"`` would let
        two fleet workers checkpointing at once interleave writes into
        the same temp file and publish a corrupt mix; with unique temps
        the last replace wins and every published file is complete."""
        payload = {
            "version": 1,
            "alpha": self.alpha,
            "base": self.base.name,
            "engines": self.state(),
        }
        target = os.path.abspath(path)
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(target) + ".", suffix=".tmp", dir=os.path.dirname(target)
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def load_calibration(self, path: str) -> "OnlineCost":
        """Warm-start the per-engine scales from a ``save_calibration``
        JSON. Returns self; raises on version/shape mismatch and when the
        calibration was learned over a *different base provider* — scales
        are EMA(wall)/EMA(base-units), so analytic-base scales are
        meaningless to a measured-base calibrator and vice versa."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != 1:
            raise ValueError(f"{path}: unsupported calibration version {payload.get('version')!r}")
        saved_base = payload.get("base", self.base.name)
        if saved_base != self.base.name:
            raise ValueError(
                f"{path}: calibration was learned over base provider {saved_base!r} "
                f"but this OnlineCost wraps {self.base.name!r} — the scales are in "
                "different units; re-calibrate instead of warm-starting"
            )
        with self._lock:
            for name, st in payload.get("engines", {}).items():
                num, den = float(st["num"]), float(st["den"])
                if num <= 0 or den <= 0:
                    raise ValueError(f"{path}: non-positive EMA state for engine {name!r}")
                self._num[name] = num
                self._den[name] = den
        return self


def make_cost_provider(
    name: str,
    cache_path: str | None = None,
    dtype: str = "bfloat16",
    calibration_path: str | None = None,
) -> CostProvider:
    """Factory behind every ``--cost {analytic,measured,blended,online}``
    flag. ``online`` wraps the blended (measured-with-analytic-fallback)
    provider in the live EMA calibrator the re-planning runtime feeds;
    ``calibration_path`` (when the file exists) warm-starts its per-engine
    scales from a previous process's ``save_calibration`` JSON."""
    if name == "analytic":
        return ANALYTIC
    if name == "measured":
        return MeasuredCost(cache_path=cache_path, dtype=dtype)
    if name == "blended":
        return BlendedCost(MeasuredCost(cache_path=cache_path, dtype=dtype))
    if name == "online":
        online = OnlineCost(BlendedCost(MeasuredCost(cache_path=cache_path, dtype=dtype)))
        if calibration_path and os.path.exists(calibration_path):
            online.load_calibration(calibration_path)
        return online
    raise ValueError(f"unknown cost provider {name!r} (want analytic|measured|blended|online)")


# ---------------------------------------------------------------------------
# Segment / graph costing (provider-parameterized)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentCost:
    """Cost of running graph[lo:hi] 'assigned' to ``engine`` with illegal
    layers falling back to ``peer`` (paper's Jetson semantics)."""

    lo: int
    hi: int
    engine_busy: float  # time the assigned engine computes
    peer_busy: float  # time stolen from the peer by fallback
    transfer: float  # engine<->peer handoff time (incl. switch overhead)
    n_fallback_runs: int
    elapsed: float  # wall time of the segment (serialized fallback)

    @property
    def has_fallback(self):
        return self.n_fallback_runs > 0


def _effective_impls(graph: LayerGraph, lo: int, hi: int, impl: str) -> list[str] | None:
    """Per-layer implementation actually run by segment [lo, hi) under
    ``impl`` — mirrors ``StagedModel.segment_ops``: a fused group only
    switches when it lies entirely inside the segment, so blocks split by
    the segment boundary are costed (and executed) as xla. Composite
    layers keep ``impl``: their fused groups live inside the node, so a
    segment containing the node contains every group (the provider
    recurses into the decomposition)."""
    if impl == "xla":
        return None
    eff = [impl] * (hi - lo)
    for i, l in enumerate(graph):
        fu = l.attrs.get("fuse")
        if fu is None:
            continue
        a, b = i, i + fu["span"]
        if a >= lo and b <= hi:
            continue  # fully contained: the group runs fused
        for j in range(max(a, lo), min(b, hi)):
            eff[j - lo] = "xla"
    return eff


def segment_cost(
    graph: LayerGraph,
    lo: int,
    hi: int,
    engine,
    peer,
    allow_fallback=True,
    provider: CostProvider | None = None,
    impl: str = "xla",
    batch: int = 1,
) -> SegmentCost:
    """Per-frame segment cost at effective batch ``batch``: layer times
    are the provider's per-frame amortized numbers and each handoff moves
    the whole bucket's activations once (``bytes * batch`` through the
    link, one SWITCH_OVERHEAD) divided back per frame — so batching
    amortizes the fixed engine-switch latency exactly where the serving
    executor does. batch=1 reproduces the historical costs bit-for-bit."""
    if provider is None:
        provider = ANALYTIC
    batch = max(int(batch), 1)
    eff = _effective_impls(graph, lo, hi, impl)

    def xfer(nbytes: float) -> float:
        return transfer_time(nbytes * batch, engine) / batch

    engine_busy = peer_busy = transfer = 0.0
    runs = 0
    prev_illegal = False
    for i in range(lo, hi):
        l = graph[i]
        li = "xla" if eff is None else eff[i - lo]
        ill = allow_fallback and is_illegal(l, engine)
        if ill:
            peer_busy += provider.layer_time(l, peer, li, batch)
            if not prev_illegal:
                runs += 1
                # hand the activation to the peer...
                prev_bytes = graph[i - 1].boundary_bytes if i > lo else l.boundary_bytes
                transfer += xfer(prev_bytes)
        else:
            engine_busy += provider.layer_time(l, engine, li, batch)
            if prev_illegal:
                # ...and back
                transfer += xfer(graph[i - 1].boundary_bytes)
        prev_illegal = ill
    if prev_illegal:
        transfer += xfer(graph[hi - 1].boundary_bytes)
    return SegmentCost(
        lo=lo,
        hi=hi,
        engine_busy=engine_busy,
        peer_busy=peer_busy,
        transfer=transfer,
        n_fallback_runs=runs,
        elapsed=engine_busy + peer_busy + transfer,
    )


def graph_time(
    graph: LayerGraph,
    engine,
    peer=None,
    allow_fallback=True,
    provider: CostProvider | None = None,
    impl: str = "xla",
    batch: int = 1,
) -> SegmentCost:
    peer = peer or engine
    return segment_cost(
        graph, 0, len(graph), engine, peer,
        allow_fallback=allow_fallback, provider=provider, impl=impl, batch=batch,
    )


class SegmentCostCache:
    """Memoized ``segment_cost``/``transfer_time`` keyed on spans.

    The multi-cut planner evaluates the same (model, span, engine)
    segment under thousands of candidate routes — any two routes sharing
    a cut share the span on one side of it — so the planner's inner loop
    is one dict lookup per segment instead of an O(span) re-walk. Keys
    are (model_index, lo, hi, engine.name, allow_fallback); the provider
    is fixed per cache (a re-plan under another provider builds a fresh
    cache, so stale timings can never leak into a plan).
    """

    def __init__(self, provider: CostProvider | None = None):
        self.provider = provider or ANALYTIC
        self._segments: dict[tuple, SegmentCost] = {}
        self._transfers: dict[tuple, float] = {}

    def segment(
        self, mi: int, graph: LayerGraph, lo: int, hi: int, engine, peer, allow_fallback,
        impl: str = "xla", batch: int = 1,
    ) -> SegmentCost:
        key = (mi, lo, hi, engine.name, allow_fallback, impl, batch)
        c = self._segments.get(key)
        if c is None:
            c = segment_cost(
                graph, lo, hi, engine, peer, allow_fallback,
                provider=self.provider, impl=impl, batch=batch,
            )
            self._segments[key] = c
        return c

    def transfer(self, mi: int, graph: LayerGraph, p: int, engine, batch: int = 1) -> float:
        key = (mi, p, engine.name, batch)
        x = self._transfers.get(key)
        if x is None:
            # whole bucket crosses once, amortized back per frame
            x = transfer_time(partition_boundary_bytes(graph, p) * batch, engine) / batch
            self._transfers[key] = x
        return x


def partition_boundary_bytes(graph: LayerGraph, p: int) -> float:
    """Bytes crossing a partition placed after layer p-1."""
    if p <= 0 or p >= len(graph):
        return 0.0
    return graph[p - 1].boundary_bytes


def balanced_partition_point(
    graph: LayerGraph, head_engine, tail_engine, candidates=None, provider: CostProvider | None = None
) -> int:
    """Partition point that best balances head time on ``head_engine``
    against tail time on ``tail_engine`` — the warm start for the N-model
    planner's local searches (and a decent heuristic on its own)."""
    if provider is None:
        provider = ANALYTIC
    cands = list(candidates) if candidates is not None else graph.cut_points()
    if not cands:
        raise ValueError(f"{graph.model_name}: no interior partition point")
    prefix = [0.0]
    for l in graph:
        prefix.append(prefix[-1] + provider.layer_time(l, head_engine))
    suffix = [0.0]
    for l in reversed(list(graph)):
        suffix.append(suffix[-1] + provider.layer_time(l, tail_engine))
    suffix.reverse()
    return min(cands, key=lambda p: abs(prefix[p] - suffix[p]))
