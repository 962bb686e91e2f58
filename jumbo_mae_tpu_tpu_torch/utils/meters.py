"""Host-side metric aggregation for the train loop's log windows.

Counterpart of ``AverageMeter`` in ``jumbo_mae_tpu_tpu/obs/metrics.py``
(re-exported by its ``utils/meters.py``): buffer per-step metric dicts of
host floats, then emit prefixed means — except keys marked ``use_latest``
(the live learning rate), which report their last value.
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self, *, use_latest: tuple[str, ...] = ("learning_rate",)):
        self.use_latest = set(use_latest)
        self.buffer: dict[str, list[float]] = {}

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.buffer.setdefault(k, []).append(float(v))

    def summary(self, prefix: str = "") -> dict[str, float]:
        out = {}
        for k, vals in self.buffer.items():
            if not vals:
                continue
            out[prefix + k] = vals[-1] if k in self.use_latest else float(np.mean(vals))
        self.buffer = {}
        return out
