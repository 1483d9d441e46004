# Engine-aware multi-model scheduling, planning and staged execution.
from .api import plan
from .engine import DevicePool, EngineSpec, jetson_orin_engines
from .graph import LayerGraph, LayerMeta
from .pipeline import StagedModel, TickLog, TwoModelPipeline, pix2pix_staged, submesh_placers, yolo_staged
from .plan_ir import PlanIR, PlanSegment
from .surgery import RULES, SurgeryReport, apply_surgery, substitute_pix2pix
