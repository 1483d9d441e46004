# Engine-aware multi-model scheduling, planning and staged execution: the
# JAX package's namespace (its TPU engine pair and constants as the H100's)
# plus the device pool and the submesh placers.
from .api import plan
from .graph import LayerGraph, LayerMeta, conv_meta, pointwise_meta
from .engine import (
    H100_BF16_FLOPS,
    H100_HBM_BW,
    H100_LINK_BW,
    DevicePool,
    EngineSpec,
    h100_submesh_engines,
    jetson_orin_engines,
)
from .constraints import (
    DLA_ANALOGUE_CONSTRAINTS,
    TPU_SMALL_CONSTRAINTS,
    DeconvPaddingZero,
    DtypeConstraint,
    KernelSizeRange,
    LaneAlignment,
    StaticShapesOnly,
    Violation,
    check_graph,
)
from .surgery import RULES, SurgeryReport, apply_surgery, substitute_pix2pix
from .cost_model import (
    ANALYTIC,
    AnalyticCost,
    BlendedCost,
    CostProvider,
    MeasuredCost,
    OnlineCost,
    SegmentCostCache,
    balanced_partition_point,
    graph_time,
    layer_time,
    make_cost_provider,
    segment_cost,
    transfer_time,
)
from .plan_ir import PlanIR, PlanSegment, ir_from_routes, make_plan_ir, translate_ir
from .scheduler import (
    HaxConnResult,
    ModelRoute,
    NModelPlan,
    RouteSpec,
    Schedule,
    haxconn_schedule,
    naive_schedule,
    nmodel_schedule,
    peer_utilization,
    standalone_schedule,
)
from .pipeline import StagedModel, TickLog, TwoModelPipeline, pix2pix_staged, submesh_placers, yolo_staged
