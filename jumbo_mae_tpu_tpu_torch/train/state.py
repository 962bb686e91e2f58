"""Train state: the model, the optimizer and its state, the step and one seed.

Counterpart of ``jumbo_mae_tpu_tpu/train/state.py``. The JAX state folds
(base key, step, domain, micro, stream) into a key per step; torch cannot
reproduce ``jax.random.fold_in``, so the port derives an integer seed from
the same coordinates (``utils/rng.py``) and seeds one ``torch.Generator``
per stream on the model's device. The streams are reproducible from the
seed and the step alone, which is what a sample-exact resume needs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.train.optim import Identity, Optimizer, OptState
from jumbo_mae_tpu_tpu_torch.utils.rng import derive_seed, generator

# Stable stream ids, the JAX package's.
STREAMS = {"dropout": 0, "noise": 1, "mixup": 2}

# Domain separators so train and eval streams never collide even at the
# same (step, micro) coordinates.
TRAIN_DOMAIN = 0
EVAL_DOMAIN = 1


@dataclass
class TrainState:
    """Everything a train step reads and advances. ``step`` counts train
    steps (guarded skips included); the optimizer keeps its own count."""

    model: nn.Module
    tx: Optimizer | Identity
    opt_state: OptState
    step: int
    seed: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step_generators(self, *, micro: int = 0, domain: int = TRAIN_DOMAIN) -> dict[str, torch.Generator]:
        """Per-step, per-micro-batch named generators on the model's device."""
        return {
            name: generator(derive_seed(self.seed, self.step, domain, micro, sid), self.device)
            for name, sid in STREAMS.items()
        }
