"""The serving bucket ladder.

A copy of ``jumbo_mae_tpu_tpu/infer/bucketing.py``: requests pad up to a
power-of-two bucket capped at ``max_batch``, so the number of distinct
batch shapes the model sees is log2(max_batch)+1, not one per request
size. The packed path buckets its rows and segment slots with
:func:`ceil_pow2`; the continuous scheduler aligns partial batches with
:func:`floor_bucket`.
"""

from __future__ import annotations


class OversizedBatchError(ValueError):
    """A single dispatch larger than the engine's ``max_batch``.
    ``InferenceEngine.predict`` never raises this (it chunks oversized
    requests); direct ``bucket_for`` callers get it."""


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, clamped to ``max_batch`` (a
    non-power-of-two ``max_batch`` is itself the last rung). ``n >
    max_batch`` raises :class:`OversizedBatchError`."""
    if n <= 0:
        raise ValueError(f"need a positive batch, got {n}")
    if n > max_batch:
        raise OversizedBatchError(
            f"batch of {n} exceeds max_batch={max_batch} — split the "
            f"request upstream (engine.predict chunks automatically) or "
            f"raise max_batch"
        )
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def floor_bucket(k: int, max_batch: int) -> int:
    """Largest pad bucket <= ``k``: a batch of exactly this size runs with
    no pad rows."""
    if k >= max_batch:
        return max_batch
    b = 1
    while b * 2 <= k:
        b *= 2
    return b


def ceil_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, with no cap: the packed path's row
    and segment-slot counts bucket this way, so the distinct packed shapes
    stay logarithmic."""
    if n <= 0:
        raise ValueError(f"need a positive count, got {n}")
    b = 1
    while b < n:
        b <<= 1
    return b


def pow2_rungs(max_value: int) -> tuple[int, ...]:
    """Every power of two <= ``max_value``, plus ``max_value`` itself when
    it is not one — the engine's bucket ladder."""
    if max_value < 1:
        raise ValueError(f"need a positive max, got {max_value}")
    rungs = []
    b = 1
    while b <= max_value:
        rungs.append(b)
        b <<= 1
    if rungs[-1] != max_value:
        rungs.append(max_value)
    return tuple(rungs)
