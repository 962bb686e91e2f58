"""The port's observability; each module mirrors ``jumbo_mae_tpu_tpu/obs``.

The metrics registry is re-exported here, as the JAX package's
``obs/__init__.py`` does.
"""

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

__all__ = [
    "LATENCY_BUCKETS",
    "NULL_REGISTRY",
    "RATIO_BUCKETS",
    "Counter",
    "Family",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "get_registry",
    "set_registry",
]
