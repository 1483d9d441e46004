# Multi-stream serving: N staged models over E engines (one CUDA stream each
# on the card) with K frame streams, planned through the segment-level
# PlanIR and re-planned live by the drift-watching Replanner, replicated by
# the fleets (.fleet in process, .multiproc in worker processes).
# `build_server` is the one-call facade; the open-loop pieces (traffic,
# SLOs, admission) live in .traffic/.admission.
from .admission import ADMIT, DROP, SHED_RES, SHED_ROUTE, AdmissionConfig, subsample_frame
from .batching import BatchConfig, bucket_for
from .demo import build_pix_yolo_serving, build_replanner, merge_flags_for
from .executor import Completion, Flight, SegmentObservation, StreamExecutor, SwapEvent
from .facade import ServerBundle, build_server
from .fleet import FleetRouter, FleetServer, LocalReplica
from .metrics import (
    ServeMetrics,
    StreamMetrics,
    SwapStall,
    TickStats,
    TierMetrics,
    engine_wait_summary,
    fleet_report,
    merge_metrics,
    metrics_from_payload,
    overlap_summary,
    percentile,
    router_imbalance,
    segment_summary,
    swap_stall_summary,
)
from .multiproc import (
    ProcFleetServer,
    RemoteReplica,
    ShmRing,
    WorkerDied,
    WorkerError,
    WorkerTimeout,
    merge_calibration,
)
from .replanner import ReplanConfig, ReplanEvent, Replanner
from .server import MultiStreamServer, Request
from .streams import FrameQueue, StreamSpec
from .traffic import (
    SLOPolicy,
    TrafficConfig,
    arrival_times,
    merged_arrivals,
    run_open_loop,
)
