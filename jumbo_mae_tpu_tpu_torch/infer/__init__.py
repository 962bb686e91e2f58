"""Serving: the bucketed inference engine (``infer/engine.py``)."""

from jumbo_mae_tpu_tpu_torch.infer.bucketing import (
    OversizedBatchError,
    bucket_for,
    pow2_rungs,
)
from jumbo_mae_tpu_tpu_torch.infer.engine import (
    InferenceEngine,
    ResolutionMismatchError,
)

__all__ = [
    "InferenceEngine",
    "OversizedBatchError",
    "ResolutionMismatchError",
    "bucket_for",
    "pow2_rungs",
]
