"""Serving: the inference engine (``infer/engine.py``), int8 weights
(``infer/quant.py``) and the micro-batcher (``infer/batching.py``)."""

from jumbo_mae_tpu_tpu_torch.infer.batching import (
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
    ShutdownError,
)
from jumbo_mae_tpu_tpu_torch.infer.bucketing import (
    OversizedBatchError,
    bucket_for,
    pow2_rungs,
)
from jumbo_mae_tpu_tpu_torch.infer.engine import (
    InferenceEngine,
    ResolutionMismatchError,
)
from jumbo_mae_tpu_tpu_torch.infer.quant import (
    QuantizedTensor,
    parity_report,
    quantize_params,
)

__all__ = [
    "DeadlineExceededError",
    "InferenceEngine",
    "MicroBatcher",
    "OversizedBatchError",
    "QuantizedTensor",
    "QueueFullError",
    "ResolutionMismatchError",
    "ShutdownError",
    "bucket_for",
    "parity_report",
    "pow2_rungs",
    "quantize_params",
]
