"""The port's observability; each module mirrors ``jumbo_mae_tpu_tpu/obs``.

The metrics registry, the cost and performance models and the request
tracer are re-exported here, as the JAX package's ``obs/__init__.py``
does.
"""

from jumbo_mae_tpu_tpu_torch.obs.costmodel import (
    COST_SCHEMA_VERSION,
    ProgramCost,
    UtilizationReport,
    cost_asdict,
    program_cost,
    publish_cost,
    utilization_report,
)
from jumbo_mae_tpu_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS,
    NULL_REGISTRY,
    RATIO_BUCKETS,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    get_registry,
    set_registry,
)
from jumbo_mae_tpu_tpu_torch.obs.perfmodel import (
    ChipSpec,
    PerfPrediction,
    chip_spec,
    detect_chip,
    dp_comm_bytes,
    fsdp_comm_bytes,
    predict_train_step,
    publish_drift,
    roofline,
)
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import OUTCOMES, AccessLog, RequestTrace, RequestTracer

__all__ = [
    "COST_SCHEMA_VERSION",
    "LATENCY_BUCKETS",
    "NULL_REGISTRY",
    "OUTCOMES",
    "RATIO_BUCKETS",
    "AccessLog",
    "ChipSpec",
    "Counter",
    "Family",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "PerfPrediction",
    "ProgramCost",
    "RequestTrace",
    "RequestTracer",
    "UtilizationReport",
    "chip_spec",
    "cost_asdict",
    "detect_chip",
    "dp_comm_bytes",
    "fsdp_comm_bytes",
    "get_registry",
    "predict_train_step",
    "program_cost",
    "publish_cost",
    "publish_drift",
    "roofline",
    "set_registry",
    "utilization_report",
]
