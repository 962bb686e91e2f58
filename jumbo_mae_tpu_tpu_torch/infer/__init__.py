"""Serving: the inference engine (``infer/engine.py``, a CUDA graph per
(task, bucket)), int8 weights (``infer/quant.py``), the micro-batcher
(``infer/batching.py``), token packing (``infer/packing.py``) and the
supervised replica pool with its weight-swap controller
(``infer/replicaset.py``), and the warm cache of built task weights
(``infer/warmcache.py``)."""

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
from jumbo_mae_tpu_tpu_torch.infer.replicaset import (
    PoolUnhealthyError,
    ReplicaSet,
    RetriesExhaustedError,
    WeightSwapController,
)
from jumbo_mae_tpu_tpu_torch.infer.warmcache import WarmCache

__all__ = [
    "DeadlineExceededError",
    "InferenceEngine",
    "MicroBatcher",
    "OversizedBatchError",
    "PoolUnhealthyError",
    "QuantizedTensor",
    "QueueFullError",
    "ReplicaSet",
    "ResolutionMismatchError",
    "RetriesExhaustedError",
    "ShutdownError",
    "WarmCache",
    "WeightSwapController",
    "bucket_for",
    "parity_report",
    "pow2_rungs",
    "quantize_params",
]
