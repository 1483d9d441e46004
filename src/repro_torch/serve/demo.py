"""Shared construction for the Pix2Pix + YOLO serving pair: one place builds
the staged models, the N-model plan, and the stream specs.

``cost`` selects the planner's CostProvider (``analytic`` — the paper's
roofline — or ``measured``/``blended``/``online``), ``norm``
selects the Pix2Pix norm layer (``instance``/``group`` build the
batch-independent variant whose streams the executor may merge-batch).
Weights are drawn from ``torch.Generator``s seeded ``seed`` (Pix2Pix) and
``seed + 1`` (YOLO) on the chosen device.

``build_pix_yolo_serving`` keeps the historical ``NModelPlan`` return;
new code should use ``serve.build_server``, which returns the ``PlanIR``
contract directly.
"""
from __future__ import annotations

import torch

from ..core.constraints import DLA_ANALOGUE_CONSTRAINTS
from ..core.cost_model import CostProvider, make_cost_provider
from ..core.engine import jetson_orin_engines
from ..core.pipeline import pix2pix_staged, yolo_staged
from ..core.scheduler import _nmodel_schedule_impl
from .streams import StreamSpec


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (``device="cpu"``). Without a card, ``None`` raises rather than
    falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device)
    g.manual_seed(seed)
    return g


def _build_pix_yolo_models(
    img: int = 64,
    base: int = 8,
    n_pix: int = 4,
    n_yolo: int = 1,
    seed: int = 0,
    norm: str = "batch",
    granularity: str = "coarse",
    device: str | torch.device = "cpu",
):
    """Staged Pix2Pix + YOLOv8 models with weights on ``device``, their
    stream specs, and the calibrated Jetson engine pair — the substrate
    ``build_pix_yolo_serving`` and the ``build_server`` facade plan over.
    Returns ``(models, streams, (gpu, dla))``."""
    from ..models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config

    device = torch.device(device)
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
    cfg = Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping", norm=norm)
    gen = Pix2PixGenerator(cfg)
    sm_pix = pix2pix_staged(
        cfg, {"generator": gen.init(_generator(seed, device))}, granularity=granularity
    )
    ycfg = YOLOv8Config(img_size=img)
    ym = YOLOv8(ycfg)
    sm_yolo = yolo_staged(ycfg, ym.init(_generator(seed + 1, device)), granularity=granularity)
    streams = [StreamSpec(f"mri-{i}", 0) for i in range(n_pix)] + [
        StreamSpec(f"det-{i}", 1) for i in range(n_yolo)
    ]
    return [sm_pix, sm_yolo], streams, (gpu, dla)


def build_pix_yolo_serving(
    img: int = 64,
    base: int = 8,
    n_pix: int = 4,
    n_yolo: int = 1,
    seed: int = 0,
    norm: str = "batch",
    cost: str | CostProvider = "analytic",
    search: str = "auto",
    granularity: str = "coarse",
    stride: int = 1,
    max_cuts: int = 1,
    impl: str = "xla",
    device: str | torch.device | None = None,
):
    """Returns ``(models, plan, streams, (gpu, dla))`` for ``n_pix``
    Pix2Pix reconstruction streams + ``n_yolo`` YOLOv8 detection streams
    over the calibrated Jetson engine pair.

    ``granularity="fine"`` plans on the *expanded* (primitive) graphs —
    the planner may cut inside YOLO's ``c2f``/``sppf``/``head`` blocks at
    stage-callable boundaries, and the staged models execute those fine
    cuts. ``stride`` thins the legal candidate set (the beam-tractability
    knob; only meaningful at fine granularity). ``max_cuts`` raises the
    per-model cut budget. ``impl`` selects the implementation-planning
    mode: ``xla`` (per-op, default), ``pallas`` (force the fused serving
    kernels), or ``auto`` (per-segment argmin over both). ``device=None``
    is the card (see ``resolve_device``)."""
    provider = cost if isinstance(cost, CostProvider) else make_cost_provider(cost)
    models, streams, (gpu, dla) = _build_pix_yolo_models(
        img=img, base=base, n_pix=n_pix, n_yolo=n_yolo, seed=seed, norm=norm,
        granularity=granularity, device=resolve_device(device),
    )
    plan = _nmodel_schedule_impl(
        [m.graph for m in models],
        [dla, gpu],
        provider=provider,
        search=search,
        stride=stride,
        max_cuts=max_cuts,
        impl=impl,
    )
    return models, plan, streams, (gpu, dla)


def build_replanner(models, config=None, cost: str | CostProvider = "analytic"):
    """Replanner over the same graphs + engine pair (in plan order:
    ``[dla, gpu]``) that ``build_pix_yolo_serving`` planned with — attach
    it to the server/executor to close the online re-planning loop."""
    from .replanner import Replanner

    provider = cost if isinstance(cost, CostProvider) else make_cost_provider(cost)
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
    return Replanner(
        [m.graph for m in models], [dla, gpu], config=config, base_provider=provider
    )


def merge_flags_for(models) -> list[bool]:
    """Per-model ``merge_batches`` flags: merge only batch-independent
    staged models (Pix2Pix with instance/group norm; never YOLO, whose
    BatchNorm takes batch statistics)."""
    return [m.batch_independent for m in models]
