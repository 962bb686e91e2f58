"""The traffic-shaping tier between request submission and the replica
pool, and continuous deployment into it. Counterpart of
``jumbo_mae_tpu_tpu/serve``, with the same five components:

- ``serve/admission.py`` — per-tenant token-bucket quotas, priority
  classes and device-second budgets;
- ``serve/scheduler.py`` — continuous batching across requests;
- ``serve/autoscaler.py`` — SLO burn, queue state and the H100 roofline
  (``obs/perfmodel.py``) turned into a replica count through
  ``ReplicaSet.scale_to``;
- ``serve/costmeter.py`` — per-tenant device-seconds and FLOPs, split
  pro-rata over each flushed batch's rows;
- ``serve/publisher.py`` — the gated train→serve weights publisher and
  the verification the swap watcher and ``tools/publish_doctor.py``
  share.

The tier's telemetry lives in ``obs/``: the ``/metrics`` and ``/healthz``
exporter, the SLO tracker's gauges, the memory watcher and the capture
sentinel; ``cli/predict.py`` wires them.
"""

from jumbo_mae_tpu_tpu_torch.serve.admission import (
    CLASS_WEIGHT,
    CLASSES,
    AdmissionController,
    TenantBudgetError,
    TenantPressureError,
    TenantQuotaError,
    TenantSpec,
    parse_tenants,
)
from jumbo_mae_tpu_tpu_torch.serve.autoscaler import Autoscaler, roofline_capacity
from jumbo_mae_tpu_tpu_torch.serve.costmeter import CostMeter, default_cost_fn
from jumbo_mae_tpu_tpu_torch.serve.publisher import (
    CheckpointPublisher,
    PublishIntegrityError,
    is_publish_artifact,
    latest_artifact,
    resolve_chain,
    verify_artifact,
)
from jumbo_mae_tpu_tpu_torch.serve.scheduler import ContinuousScheduler

__all__ = [
    "CLASSES",
    "CLASS_WEIGHT",
    "AdmissionController",
    "Autoscaler",
    "CheckpointPublisher",
    "ContinuousScheduler",
    "CostMeter",
    "PublishIntegrityError",
    "TenantBudgetError",
    "TenantPressureError",
    "TenantQuotaError",
    "TenantSpec",
    "default_cost_fn",
    "is_publish_artifact",
    "latest_artifact",
    "parse_tenants",
    "resolve_chain",
    "roofline_capacity",
    "verify_artifact",
]
