"""The optimizers, the warmup-cosine schedule and layer-wise lr decay.

Counterpart of ``jumbo_mae_tpu_tpu/train/optim.py``: optax's chains as
plain tensor code, in optax's order of operations (not ``torch.optim``'s):

- ``adamw``: ``scale_by_adam`` → ``add_decayed_weights(mask)`` →
  ``scale_by_learning_rate``. The moments update in float32
  (``mu = (1−b1)·g + b1·mu``), the bias-corrected update is computed from
  these uncast moments, and only the stored moment is cast to
  ``mu_dtype`` / ``nu_dtype``. With a bf16 ``mu_dtype`` the jitted optax
  update multiplies the stored moment by b1 rounded to bf16 (0.8984375
  for 0.9) while the bias correction uses b1 itself; the port keeps
  that. eps is added outside the square root;
- ``lamb`` (the modified LAMB): AdamW's chain with a trust ratio
  ``‖p‖ / ‖u‖`` between the weight decay and the learning rate, on the
  decayed weights only;
- ``lars``: ``optax.lars`` — weight decay 0, the trust ratio
  ``1e-3 · ‖p‖ / ‖u‖`` on every parameter, the learning rate, then
  momentum (``trace``: ``t = u + momentum · t``);
- ``sgd``: momentum (``t = g + momentum · t``), then the learning rate.

A trust ratio is 1 where ``‖p‖`` or ``‖u‖`` is 0. Weight decay uses the
pre-update parameter and applies only to the weights flax names
``kernel`` (:func:`kernel_mask`). The learning rate is the schedule at the
optimizer's own count before the update, as ``optax.inject_hyperparams``
evaluates it; a guarded skip (``train/steps.py``) advances the train step
but not this count. Around the chain, as ``make_optimizer`` wraps it:
``clip_grad > 0`` clips by the global norm first; ``layer_decay < 1``
scales each update last by ``layer_decay ** (num_layers − layer)``
(:func:`layer_index`); a low-precision ``param_dtype`` keeps float32
master weights in the state, runs the chain on them, and leaves each
parameter the exact cast of its master. There the learning rate is
rounded to ``param_dtype`` (bf16: 1e-6 becomes 9.98e-7), as
``inject_hyperparams`` casts it to the gradients' dtype; the port keeps
that too.

A ``None`` gradient (a parameter the step did not differentiate, such as
the trunk of a linear probe, which JAX hands zeros) is taken as zeros, so
weight decay and the trust ratio act as optax's do. Every optimizer's
per-parameter state is a set of named tensor lists (:meth:`OptState.slots`),
which the checkpoints save and restore whatever the optimizer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, ClassVar, Literal, Sequence

import numpy as np
import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_path
from jumbo_mae_tpu_tpu_torch.models.config import torch_dtype

OptimizerName = Literal["adamw", "lamb", "lars", "sgd"]
LrScaling = Literal["batch", "none"]
LARS_TRUST_COEFFICIENT = 1e-3  # optax.lars' default, which the JAX package keeps


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


def layer_index(path: Sequence[str], num_layers: int) -> int:
    """A flax parameter path → its encoder depth for layer-wise lr decay,
    as the JAX package's ``layer_index``: in a classifier tree (the trunk
    under ``model``) ``embed`` → 0, ``block_i`` → i + 1, everything else
    (head, final norm, CLS tokens, the shared jumbo MLP) → ``num_layers``."""
    if path and path[0] == "model" and len(path) > 1:
        if path[1] == "embed":
            return 0
        if m := re.fullmatch(r"block_(\d+)", path[1]):
            return int(m.group(1)) + 1
    return num_layers


def layer_scales(model: nn.Module, layer_decay: float, num_layers: int) -> list[float]:
    """Each parameter's update scale ``layer_decay ** (num_layers − i)``,
    in parameter order, its layer ``i`` taken from its flax path
    (``interop/from_jax.py`` ``flax_path``)."""
    return [
        float(layer_decay ** (num_layers - layer_index(flax_path(name), num_layers)))
        for name, _ in model.named_parameters()
    ]


@dataclass
class OptState:
    """The optimizer's own step ``count``, the learning rate of its last
    update (``optax.inject_hyperparams``' ``hyperparams``), the decay mask
    and update scales in parameter order, and the per-parameter tensors
    named by ``SLOTS`` (plus ``master`` with master weights)."""

    count: int
    learning_rate: float
    decay: list[bool] = field(repr=False, default_factory=list)
    scales: list[float] | None = field(repr=False, default=None)
    master: list[torch.Tensor] | None = field(repr=False, default=None)

    SLOTS: ClassVar[tuple[str, ...]] = ()

    def slots(self) -> dict[str, list[torch.Tensor]]:
        """Every per-parameter tensor list of the state, by name: what a
        checkpoint saves and restores."""
        out = {name: getattr(self, name) for name in self.SLOTS}
        if self.master is not None:
            out["master"] = self.master
        return out


@dataclass
class AdamWState(OptState):
    """AdamW's and LAMB's: the stored moments."""

    mu: list[torch.Tensor] = field(repr=False, default_factory=list)
    nu: list[torch.Tensor] = field(repr=False, default_factory=list)

    SLOTS: ClassVar[tuple[str, ...]] = ("mu", "nu")


@dataclass
class MomentumState(OptState):
    """LARS' and SGD's: the momentum trace."""

    trace: list[torch.Tensor] = field(repr=False, default_factory=list)

    SLOTS: ClassVar[tuple[str, ...]] = ("trace",)


def _trust_ratio(params: list[torch.Tensor], updates: list[torch.Tensor], coefficient: float) -> list[torch.Tensor]:
    """``optax.scale_by_trust_ratio``'s factor per tensor:
    ``coefficient · ‖p‖ / ‖u‖``, 1 where either norm is 0."""
    pn = torch.stack(torch._foreach_norm(params))
    un = torch.stack(torch._foreach_norm(updates))
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), coefficient * pn / un)
    return list(ratio.unbind())


def low_precision(param_dtype: str | None) -> torch.dtype | None:
    """The parameters' stored dtype where it is below float32, else None."""
    low = torch_dtype(param_dtype) if param_dtype else torch.float32
    return None if low == torch.float32 else low


class Optimizer:
    """One of the chains above, with its clipping, layer scales and master
    weights. ``init(model)`` builds the state; ``update(state, params,
    grads)`` takes one step on ``params`` in place."""

    def __init__(
        self,
        name: OptimizerName,
        schedule: Callable[[int], float],
        *,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        momentum: float = 0.9,
        mu_dtype: str | None = None,
        nu_dtype: str | None = None,
        clip_grad: float = 0.0,
        layer_decay: float = 1.0,
        num_layers: int | None = None,
        param_dtype: str | None = None,
    ):
        if name not in ("adamw", "lamb", "lars", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        if layer_decay < 1.0 and num_layers is None:
            raise ValueError("layer_decay requires num_layers")
        self.name, self.schedule = name, schedule
        self.b1, self.b2, self.eps, self.weight_decay, self.momentum = b1, b2, eps, weight_decay, momentum
        self.mu_dtype = torch_dtype(mu_dtype) if mu_dtype else None
        self.nu_dtype = torch_dtype(nu_dtype) if nu_dtype else None
        self.clip_grad, self.layer_decay, self.num_layers = clip_grad, layer_decay, num_layers
        self.low_precision = low_precision(param_dtype)  # master weights, lr in that dtype

    def init(self, model: nn.Module) -> OptState:
        """The state for ``model``'s parameters as they are; with
        ``low_precision`` the master weights are their float32 copies, and
        ``create_state`` casts the parameters after this call."""
        params = list(model.parameters())
        master = [p.detach().float().clone() for p in params] if self.low_precision else None
        targets = master or params
        mask = kernel_mask(model)
        common = dict(
            count=0,
            learning_rate=self.schedule(0),
            decay=[mask[name] for name, _ in model.named_parameters()],
            scales=layer_scales(model, self.layer_decay, self.num_layers) if self.layer_decay < 1.0 else None,
            master=master,
        )
        if self.name in ("adamw", "lamb"):
            return AdamWState(
                **common,
                mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in targets],
                nu=[torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for p in targets],
            )
        return MomentumState(**common, trace=[torch.zeros_like(p) for p in targets])

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

    def _adam(self, state: AdamWState, targets: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Adam's direction plus the masked weight decay (AdamW and LAMB),
        the moments stored back in their dtypes."""
        f32 = np.float32
        count = state.count + 1
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
            torch._foreach_add_([upd[i] for i in idx], [targets[i] for i in idx], alpha=self.weight_decay)
        state.mu = [m.to(self.mu_dtype) for m in mu] if self.mu_dtype else mu
        state.nu = [n.to(self.nu_dtype) for n in nu] if self.nu_dtype else nu
        if self.name == "lamb" and idx:
            ratio = _trust_ratio([targets[i] for i in idx], [upd[i] for i in idx], 1.0)
            torch._foreach_mul_([upd[i] for i in idx], ratio)
        return upd

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """``optax.clip_by_global_norm``: ``(g / ‖g‖) · max_norm`` when the
        global norm reaches ``clip_grad``, chosen on the device."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scaled = torch._foreach_div(grads, norm)
        torch._foreach_mul_(scaled, self.clip_grad)
        keep = norm < self.clip_grad
        return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]

    @torch.no_grad()
    def update(self, state: OptState, params: list[torch.Tensor], grads: list[torch.Tensor | None]) -> None:
        """One step on ``params`` in place (gradients in parameter order; a
        ``None`` gradient counts as zeros)."""
        targets = state.master if state.master is not None else params
        grads = [torch.zeros_like(t) if g is None else g.to(t.dtype) for t, g in zip(targets, grads)]
        lr = self.schedule(state.count)
        if self.low_precision is not None:
            lr = torch.tensor(lr, dtype=self.low_precision).item()
        if self.clip_grad > 0:
            grads = self._clip(grads)
        if self.name in ("adamw", "lamb"):
            upd = self._adam(state, targets, grads)
            torch._foreach_mul_(upd, -lr)
        elif self.name == "lars":
            upd = torch._foreach_mul(grads, _trust_ratio(targets, grads, LARS_TRUST_COEFFICIENT))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(upd, torch._foreach_mul(state.trace, self.momentum))
            state.trace = upd
        else:  # sgd
            trace = torch._foreach_mul(state.trace, self.momentum)
            torch._foreach_add_(trace, grads)
            state.trace = trace
            upd = torch._foreach_mul(trace, -lr)
        if state.scales is not None:
            idx = [i for i, s in enumerate(state.scales) if s != 1.0]
            if idx:
                torch._foreach_mul_([upd[i] for i in idx], [state.scales[i] for i in idx])
        torch._foreach_add_(targets, upd)
        if state.master is not None:
            torch._foreach_copy_(params, [m.to(p.dtype) for m, p in zip(state.master, params)])
        state.count += 1
        state.learning_rate = lr


class Identity:
    """``optax.identity()``: the optimizer of an evaluation-only run, whose
    state holds no tensor, so no moment reaches the device. ``param_dtype``
    stores the parameters as the training run stored them."""

    def __init__(self, param_dtype: str | None = None):
        self.low_precision = low_precision(param_dtype)

    def init(self, model: nn.Module) -> OptState:
        return OptState(count=0, learning_rate=0.0)

    def update(self, state: OptState, params, grads) -> None:
        raise RuntimeError("the identity optimizer of an evaluation-only run takes no step")


def make_optimizer(cfg: OptimConfig, global_batch_size: int, *, num_layers: int | None = None) -> Optimizer:
    """The optimizer ``cfg`` names, driven by :func:`make_schedule`;
    ``num_layers`` (the encoder's depth) is needed for ``layer_decay < 1``."""
    return Optimizer(
        cfg.name,
        make_schedule(cfg, global_batch_size),
        b1=cfg.b1,
        b2=cfg.b2,
        eps=cfg.eps,
        weight_decay=cfg.weight_decay,
        momentum=cfg.momentum,
        mu_dtype=cfg.mu_dtype,
        nu_dtype=cfg.nu_dtype,
        clip_grad=cfg.clip_grad,
        layer_decay=cfg.layer_decay,
        num_layers=num_layers,
        param_dtype=cfg.param_dtype,
    )
