"""Fixed 2-D sin/cos positional embeddings.

A copy of ``jumbo_mae_tpu_tpu/ops/posemb.py`` (the port keeps its own).
Two quirks of the original are preserved deliberately because pretrained
checkpoints depend on them:

1. the frequency ladder is ``linspace(0, 1, dim//4)`` **including** the
   endpoint (upstream MAE excludes it);
2. the row/column coordinate grids are generated with ``nrows``/``ncols``
   swapped relative to their broadcast axes — harmless for square grids.

The table is built once in float64 numpy and returned as float32.
"""

from __future__ import annotations

import numpy as np


def sincos2d_positional_embedding(ncols: int, nrows: int, dim: int) -> np.ndarray:
    """Build a (ncols, nrows, dim) table of fixed 2-D sin/cos embeddings.

    ``dim`` must be divisible by 4: the feature axis is split into four
    equal bands — sin(col·f), cos(col·f), sin(row·f), cos(row·f).
    """
    if dim % 4 != 0:
        raise ValueError(f"posemb dim must be divisible by 4, got {dim}")
    nband = dim // 4
    inv_freq = 10000.0 ** -np.linspace(0.0, 1.0, nband, dtype=np.float64)

    # angles for the two spatial coordinates, in the original's (swapped
    # for non-square grids) broadcast layout
    a = np.arange(nrows, dtype=np.float64)[:, None] * inv_freq[None, :]
    b = np.arange(ncols, dtype=np.float64)[:, None] * inv_freq[None, :]
    a_grid = np.broadcast_to(a[None, :, :], (ncols, nrows, nband))
    b_grid = np.broadcast_to(b[:, None, :], (ncols, nrows, nband))

    table = np.concatenate(
        [np.sin(a_grid), np.cos(a_grid), np.sin(b_grid), np.cos(b_grid)], axis=2
    )
    return table.astype(np.float32)
