"""State creation, the train step and the eval step.

Counterpart of ``jumbo_mae_tpu_tpu/train/steps.py``
(``create_sharded_state`` → :func:`create_state`), in PyTorch's idiom:
the state is updated in place and returned, and a step runs eagerly.
Parameters are replicated: every process builds the same weights from
``init_seed``.

- ``grad_accum == 1``: batch leaves are (batch, ...); ``grad_accum > 1``:
  (accum, micro, ...), the gradients of the micro-batches summed in
  float32 (the parameters' ``.grad``) and scaled by 1/accum before the one
  optimizer update; the metrics are averaged alike.
- ``inject = [loss_mult, grad_mult]`` (default ones) multiplies the
  differentiated loss and the gradients, the fault-injection seam; a
  multiply by exactly 1.0 changes no bit.
- ``guard_nonfinite=True``: a non-finite loss (times ``loss_mult``) or
  gradient norm skips the update — parameters and optimizer state stay as
  they are, only ``step`` advances — and the metrics gain ``grad_norm``
  and ``skipped`` (``faults/sentinel.py:40-58`` in the JAX package).
- The metrics are ``loss`` and ``learning_rate`` (the rate of the
  optimizer's last update); the per-sample loss stays out.
- The step runs under the ambient mesh (``parallel.set_mesh``). With a
  ``data`` axis above 1 each data rank passes its own rows of the global
  batch (``synthetic_batches(..., shard=(rank, ranks))``); the gradients
  and the loss are averaged over the data group (all-reduce, then divide
  by its size) before the guard and the optimizer, and the random masks
  are drawn for the global batch, so the step equals one process on the
  global batch. Seq ranks need no all-reduce: ring attention hands every
  seq rank the whole gradient, so their parameter gradients are equal.

Classification (``mode="classify"``), per-layer diagnostics (``diag``) and
pipeline parallelism raise, naming ROADMAP A4, A7 and A6.
"""

from __future__ import annotations

from typing import Any, Callable, Literal

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, JumboViTConfig
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.parallel.mesh import ambient_mesh
from jumbo_mae_tpu_tpu_torch.train.optim import AdamW, OptimConfig, make_optimizer
from jumbo_mae_tpu_tpu_torch.train.state import EVAL_DOMAIN, TrainState
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

Mode = Literal["pretrain", "classify"]

CLASSIFY_NOT_PORTED = "mode='classify' (finetuning, linear probing) is not ported yet: ROADMAP queue A4"
DIAG_NOT_PORTED = "diag=True (per-layer-group diagnostics) is not ported yet: ROADMAP queue A7"
PIPE_NOT_PORTED = "pipe_microbatches > 0 (pipeline parallelism) is not ported yet: ROADMAP queue A6"


def _check_mode(mode: Mode) -> None:
    if mode == "classify":
        raise NotImplementedError(CLASSIFY_NOT_PORTED)
    if mode != "pretrain":
        raise ValueError(f"unknown mode {mode!r}")


def create_state(
    model_or_cfgs: nn.Module | tuple,
    optim: OptimConfig | AdamW,
    *,
    device: str | torch.device = "cuda",
    init_seed: int = 0,
    rng_seed: int = 0,
    global_batch_size: int | None = None,
) -> TrainState:
    """A fresh :class:`TrainState` on ``device``.

    ``model_or_cfgs`` is a built model, or ``(encoder_cfg, decoder_cfg)``
    / ``(encoder_cfg, decoder_cfg, norm_pix_loss)``, from which an
    :class:`MAEPretrainModel` is built with weights from ``init_seed``.
    ``optim`` is an optimizer from ``make_optimizer``, or an
    :class:`OptimConfig` (then ``global_batch_size`` sets the peak lr).
    ``rng_seed`` seeds the per-step noise and dropout streams."""
    dev = resolve_device(device)
    if isinstance(model_or_cfgs, nn.Module):
        model = model_or_cfgs.to(dev)
    else:
        enc, dec, *rest = model_or_cfgs
        if not (isinstance(enc, JumboViTConfig) and isinstance(dec, DecoderConfig)):
            raise TypeError("model_or_cfgs must be a module or (JumboViTConfig, DecoderConfig[, norm_pix_loss])")
        model = MAEPretrainModel(enc, dec, *rest, device=dev, seed=init_seed)
    if isinstance(optim, OptimConfig):
        if global_batch_size is None:
            raise ValueError("an OptimConfig needs global_batch_size for its peak learning rate")
        optim = make_optimizer(optim, global_batch_size)
    return TrainState(model=model, tx=optim, opt_state=optim.init(model), step=0, seed=rng_seed)


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device, non_blocking=True)


def _average_over_data(grads: list[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
    """Average ``grads`` (in place) and ``loss`` over the ambient mesh's
    data group, in one all-reduce; returns the averaged loss."""
    mesh = ambient_mesh()
    group = None if mesh is None else mesh.group("data")
    if group is None:
        return loss
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = flat.split([g.numel() for g in grads] + [1])
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(parts, grads)])
    return parts[-1].reshape(()).to(loss.dtype)


def make_train_step(
    *,
    mode: Mode = "pretrain",
    grad_accum: int = 1,
    guard_nonfinite: bool = False,
    diag: bool = False,
    pipe_microbatches: int = 0,
) -> Callable[..., tuple[TrainState, dict]]:
    """Build ``train_step(state, batch, inject=None) -> (state, metrics)``."""
    _check_mode(mode)
    if diag:
        raise NotImplementedError(DIAG_NOT_PORTED)
    if pipe_microbatches:
        raise NotImplementedError(PIPE_NOT_PORTED)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: TrainState, batch: dict, inject=None) -> tuple[TrainState, dict]:
        loss_mult, grad_mult = (1.0, 1.0) if inject is None else (float(inject[0]), float(inject[1]))
        model = state.model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        images = _to_device(batch["images"], state.device)
        micro_images = [images] if grad_accum == 1 else list(images)
        loss_sum = torch.zeros((), device=state.device)
        for micro, x in enumerate(micro_images):
            out = model(x, generators=state.step_generators(micro=micro))
            (out["loss"] * loss_mult).backward()
            loss_sum = loss_sum + out["loss"].detach()
        loss = loss_sum / grad_accum
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        loss = _average_over_data(grads, loss)
        if grad_accum > 1:  # the JAX step scales by 1/accum, then by grad_mult
            torch._foreach_mul_(grads, 1.0 / grad_accum)
        if grad_mult != 1.0:
            torch._foreach_mul_(grads, grad_mult)
        metrics: dict[str, Any] = {"loss": loss}
        apply = True
        if guard_nonfinite:
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            finite = bool(torch.isfinite(loss * loss_mult).item() and torch.isfinite(grad_norm).item())
            metrics |= {"grad_norm": grad_norm, "skipped": 0.0 if finite else 1.0}
            apply = finite
        if apply:
            state.tx.update(state.opt_state, params, grads)
        for p in params:
            p.grad = None
        state.step += 1
        metrics["learning_rate"] = state.opt_state.learning_rate
        return state, metrics

    return train_step


def make_eval_step(*, mode: Mode = "pretrain") -> Callable[..., dict]:
    """Build ``eval_step(state, batch, batch_idx=0) -> sums``: the sum of
    the per-sample loss over ``valid`` samples and ``num_samples``, the
    valid count; the caller divides at the end (an exact weighted mean
    with ragged last batches). ``batch_idx`` varies the mask draw, on a
    stream kept apart from training's."""
    _check_mode(mode)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, batch_idx: int = 0) -> dict:
        model = state.model.eval()
        images = _to_device(batch["images"], state.device)
        valid = batch.get("valid")
        valid = (
            torch.ones(images.shape[0], device=state.device)
            if valid is None
            else _to_device(valid, state.device).float()
        )
        out = model(images, generators=state.step_generators(micro=batch_idx, domain=EVAL_DOMAIN))
        return {"loss": (out["loss_per_sample"] * valid).sum(), "num_samples": valid.sum()}

    return eval_step
