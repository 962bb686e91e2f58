"""AdamW with a kernel-only weight-decay mask and the warmup-cosine schedule.

Counterpart of ``jumbo_mae_tpu_tpu/train/optim.py`` for ``name="adamw"``,
the pretraining optimizer. optax's order of operations is kept, not
``torch.optim.AdamW``'s (which has no moment dtypes):

- the moments update in float32 (``mu = (1−b1)·g + b1·mu``), the
  bias-corrected update is computed from these uncast moments, and only
  the stored moment is cast to ``mu_dtype`` / ``nu_dtype``. With a bf16
  ``mu_dtype`` the jitted optax update multiplies the stored moment by b1
  rounded to bf16 (0.8984375 for 0.9) while the bias correction uses
  b1 itself; the port keeps that;
- eps is added outside the square root;
- weight decay is decoupled, uses the pre-update parameter and applies
  only to the weights flax names ``kernel`` (:func:`kernel_mask`);
- the step is ``p ← p − lr·(adam + wd·p)``;
- the learning rate is the schedule at the optimizer's own count before
  the update, as ``optax.inject_hyperparams`` evaluates it. A guarded
  skip (``train/steps.py``) advances the train step but not this count.

LAMB, LARS, SGD, layer-wise decay, gradient clipping and low-precision
parameter storage are for finetuning and linear probing and raise here
(ROADMAP queue A4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Literal

import numpy as np
import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import torch_dtype

OptimizerName = Literal["adamw", "lamb", "lars", "sgd"]
LrScaling = Literal["batch", "none"]

A4_NOT_PORTED = "{what} is not ported yet: ROADMAP queue A4 (finetuning and linear probing)"


@dataclass(frozen=True)
class OptimConfig:
    """Same fields and defaults as the JAX package's ``OptimConfig``."""

    name: OptimizerName = "adamw"
    learning_rate: float = 1.5e-4  # base LR (pre-scaling)
    lr_scaling: LrScaling = "batch"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.05
    momentum: float = 0.9
    clip_grad: float = 0.0
    layer_decay: float = 1.0  # <1 enables layer-wise decay
    warmup_steps: int = 0
    training_steps: int = 1
    init_lr: float = 1e-6
    end_lr: float = 1e-5
    mu_dtype: str | None = None
    nu_dtype: str | None = None
    param_dtype: str | None = None

    def peak_lr(self, global_batch_size: int) -> float:
        if self.lr_scaling == "batch":
            return self.learning_rate * global_batch_size / 256
        return self.learning_rate


def kernel_mask(model: nn.Module) -> dict[str, bool]:
    """``{parameter name: decayed}``: True for the weights flax names
    ``kernel`` — those of dense layers (``nn.Linear``) and the patch
    convolution (``nn.Conv2d``), the entries ``interop/from_jax.py`` fills
    from a ``kernel`` leaf. Biases, norm scales, CLS and mask tokens,
    positions and LayerScale are not decayed."""
    decayed = {
        f"{mod_name}.weight" if mod_name else "weight"
        for mod_name, mod in model.named_modules()
        if isinstance(mod, (nn.Linear, nn.Conv2d))
    }
    return {name: name in decayed for name, _ in model.named_parameters()}


def make_schedule(cfg: OptimConfig, global_batch_size: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_lr`` to
    the peak over ``warmup_steps``, then cosine to ``end_lr`` at
    ``training_steps``; evaluated in float32, as optax evaluates it."""
    f32 = np.float32
    init, peak, end = cfg.init_lr, cfg.peak_lr(global_batch_size), cfg.end_lr
    warmup, decay_steps = cfg.warmup_steps, cfg.training_steps - cfg.warmup_steps
    if not decay_steps > 0:
        raise ValueError(
            f"the cosine decay needs training_steps > warmup_steps, got {cfg.training_steps} "
            f"and {cfg.warmup_steps}"
        )
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclass
class AdamWState:
    """The optimizer's own step ``count``, the learning rate of its last
    update (``optax.inject_hyperparams``' ``hyperparams``), and the stored
    moments in parameter order."""

    count: int
    learning_rate: float
    mu: list[torch.Tensor] = field(repr=False)
    nu: list[torch.Tensor] = field(repr=False)
    decay: list[bool] = field(repr=False)


class AdamW:
    """``optax.chain(scale_by_adam, add_decayed_weights(mask),
    scale_by_learning_rate(schedule))`` as plain tensor code."""

    def __init__(
        self,
        schedule: Callable[[int], float],
        *,
        b1: float,
        b2: float,
        eps: float,
        weight_decay: float,
        mu_dtype: str | None = None,
        nu_dtype: str | None = None,
    ):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu_dtype = torch_dtype(mu_dtype) if mu_dtype else None
        self.nu_dtype = torch_dtype(nu_dtype) if nu_dtype else None

    def init(self, model: nn.Module) -> AdamWState:
        params = list(model.parameters())
        mask = kernel_mask(model)
        return AdamWState(
            count=0,
            learning_rate=self.schedule(0),
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params],
            nu=[torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for p in params],
            decay=[mask[name] for name, _ in model.named_parameters()],
        )

    def _moments(self, state: AdamWState, grads: list[torch.Tensor]):
        b1, b2 = self.b1, self.b2
        if self.nu_dtype is None:
            # optax.scale_by_adam: (1 − b1)·g + b1·mu. Under jit, JAX's weak
            # typing rounds the constant b1 to mu's stored dtype and XLA
            # multiplies in float32: with bf16 mu the decay is 0.8984375.
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item() if self.mu_dtype else b1
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, torch._foreach_mul([m.float() for m in state.mu], b1_mu))
            nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
            return mu, nu
        # the JAX package's scale_by_adam_dtyped: both moments cast up first
        mu = torch._foreach_mul([m.float() for m in state.mu], b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        nu = torch._foreach_mul([n.float() for n in state.nu], b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        return mu, nu

    @torch.no_grad()
    def update(self, state: AdamWState, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        """One step on ``params`` in place (float32 grads, parameter order)."""
        lr = self.schedule(state.count)
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** f32(count))
        c2 = float(f32(1) - f32(self.b2) ** f32(count))
        mu, nu = self._moments(state, grads)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        idx = [i for i, d in enumerate(state.decay) if d]
        if idx and self.weight_decay:
            torch._foreach_add_([upd[i] for i in idx], [params[i] for i in idx], alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        state.mu = [m.to(self.mu_dtype) for m in mu] if self.mu_dtype else mu
        state.nu = [n.to(self.nu_dtype) for n in nu] if self.nu_dtype else nu
        state.count = count
        state.learning_rate = lr


def make_optimizer(cfg: OptimConfig, global_batch_size: int) -> AdamW:
    """The optimizer :func:`make_schedule` drives; AdamW only."""
    if cfg.name != "adamw":
        raise NotImplementedError(A4_NOT_PORTED.format(what=f"optimizer {cfg.name!r}"))
    if cfg.layer_decay < 1.0:
        raise NotImplementedError(A4_NOT_PORTED.format(what="layer-wise lr decay (layer_decay < 1)"))
    if cfg.clip_grad > 0:
        raise NotImplementedError(A4_NOT_PORTED.format(what="gradient clipping (clip_grad > 0)"))
    if cfg.param_dtype and cfg.param_dtype != "float32":
        raise NotImplementedError(A4_NOT_PORTED.format(what="low-precision params with f32 master weights (param_dtype)"))
    return AdamW(
        make_schedule(cfg, global_batch_size),
        b1=cfg.b1,
        b2=cfg.b2,
        eps=cfg.eps,
        weight_decay=cfg.weight_decay,
        mu_dtype=cfg.mu_dtype,
        nu_dtype=cfg.nu_dtype,
    )
