"""Synthetic data source for smoke runs and benchmarks.

A copy of ``jumbo_mae_tpu_tpu/data/synthetic.py`` (numpy only):
deterministic uint8 image batches (and labels) made on the host, in the
dict layout the real loader produces: ``{"images": (B,H,W,C) uint8,
"labels": (B,) int32, "valid": (B,) bool}``.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def synthetic_batches(
    batch_size: int,
    image_size: int = 224,
    *,
    labels: int | None = None,
    grad_accum: int = 1,
    seed: int = 0,
    distinct: int = 8,
    shard: tuple[int, int] = (0, 1),
) -> Iterator[dict]:
    """Infinite iterator of synthetic batches.

    ``distinct`` controls how many unique batches are cycled. With
    ``grad_accum > 1`` leaves get a leading (accum, micro, ...) shape.
    ``shard=(rank, ranks)`` yields data rank ``rank``'s rows of each
    global batch of ``batch_size`` (of every micro-batch with
    ``grad_accum > 1``): the ranks together see the one-process batches.
    """
    rank, ranks = shard
    if not 0 <= rank < ranks:
        raise ValueError(f"shard {shard}: need 0 <= rank < ranks")
    rng = np.random.RandomState(seed)
    shape = (batch_size, image_size, image_size, 3)
    pool = []
    for _ in range(distinct):
        batch = {"images": rng.randint(0, 256, shape, dtype=np.uint8)}
        if labels is not None:
            batch["labels"] = rng.randint(0, labels, (batch_size,)).astype(np.int32)
        batch["valid"] = np.ones((batch_size,), bool)
        if grad_accum > 1:
            if batch_size % grad_accum:
                raise ValueError("batch_size must divide by grad_accum")
            batch = {
                k: v.reshape(grad_accum, batch_size // grad_accum, *v.shape[1:])
                for k, v in batch.items()
            }
        if ranks > 1:
            axis = 1 if grad_accum > 1 else 0
            rows = batch["images"].shape[axis]
            if rows % ranks:
                raise ValueError(f"{rows} rows per batch do not divide over {ranks} ranks")
            part = rows // ranks
            batch = {k: np.take(v, range(rank * part, (rank + 1) * part), axis=axis) for k, v in batch.items()}
        pool.append(batch)
    i = 0
    while True:
        yield pool[i % distinct]
        i += 1
