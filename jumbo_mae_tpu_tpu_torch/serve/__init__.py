"""The traffic-shaping tier between request submission and the replica
pool: weighted tenant admission (``serve/admission.py``) and continuous
batching (``serve/scheduler.py``). The JAX package's autoscaler, cost
meter and publisher are ROADMAP A5 items still to port."""

from jumbo_mae_tpu_tpu_torch.serve.admission import (
    CLASS_WEIGHT,
    CLASSES,
    AdmissionController,
    TenantPressureError,
    TenantQuotaError,
    TenantSpec,
    parse_tenants,
)
from jumbo_mae_tpu_tpu_torch.serve.scheduler import ContinuousScheduler

__all__ = [
    "CLASSES",
    "CLASS_WEIGHT",
    "AdmissionController",
    "ContinuousScheduler",
    "TenantPressureError",
    "TenantQuotaError",
    "TenantSpec",
    "parse_tenants",
]
