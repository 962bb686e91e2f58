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

``mode="classify"`` trains a ``ClassificationModel``: the batch
holds ``images`` and ``labels`` (int or soft; under ``grad_accum`` both
carry the micro axis), the BatchNorm head runs in train mode, and the
metrics are ``loss``, ``acc1``, ``acc5`` (batch means) and
``learning_rate``. Torch moves the BatchNorm running statistics inside
the forward, before the guard decides, so a guarded skip puts them back
(the JAX step's ``jnp.where(finite, new, old)``). Its eval step sums
``loss``, ``acc1`` and ``acc5`` over the valid rows, with negative labels
(padding) taken as 0. The JAX step computes BatchNorm statistics and the
Mixup permutation over the global batch; the port refuses both on a data
axis above 1 until the statistics are reduced and the batch gathered over
the data group (ROADMAP A6).

``diag=True`` adds the JAX step's per-layer-group diagnostics
(``obs/modelstats.py``): ``finite_frac``, the finite share of the
per-sample loss, on every step, and ``diag``, the ``(groups, 3)`` array
of :func:`~jumbo_mae_tpu_tpu_torch.obs.modelstats.group_stats` over the
parameters before the update, the gradients after ``grad_mult`` and
1/accum, and the parameters after it. The optimizer updates in place, so
a diag step first keeps a copy of the parameters in their stored dtype
(1.62 GB at ViT-L/16 in float32, 3.1 GB at ViT-H/14): ``||new - old||``
is then the difference of the stored values, as JAX's is, whatever the
optimizer did (clipping, master weights, a guarded skip, whose update
ratio is 0 and grad norms NaN). Reading the update off the optimizer
instead would give the master weights' step, not the stored one's. The
copy and the statistics cost a diag step only: ``train_step(...,
diag=False)`` skips them on a step whose array nobody fetches (the CLI
asks only on its ``run.diag_every`` cadence), and ``diag=False`` at the
factory changes nothing at all. Pipeline parallelism raises, naming
ROADMAP A6.
"""

from __future__ import annotations

from typing import Any, Callable, Literal

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, JumboViTConfig
from jumbo_mae_tpu_tpu_torch.models.layers import BatchNorm
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.obs.modelstats import group_stats
from jumbo_mae_tpu_tpu_torch.parallel.mesh import ambient_mesh
from jumbo_mae_tpu_tpu_torch.train.optim import Identity, OptimConfig, Optimizer, make_optimizer
from jumbo_mae_tpu_tpu_torch.train.state import EVAL_DOMAIN, TrainState
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

Mode = Literal["pretrain", "classify"]

GLOBAL_BATCH_NOT_PORTED = (
    "{what} on a data axis above 1 is not ported yet: ROADMAP queue A6 (the JAX step computes it over the "
    "global batch; the port would compute it over each rank's rows)"
)
PIPE_NOT_PORTED = "pipe_microbatches > 0 (pipeline parallelism) is not ported yet: ROADMAP queue A6"


def _check_mode(mode: Mode) -> None:
    if mode not in ("pretrain", "classify"):
        raise ValueError(f"unknown mode {mode!r}")


def _batchnorm_stats(model: nn.Module) -> list[torch.Tensor]:
    """The running statistics of every BatchNorm in ``model``."""
    return [t for m in model.modules() if isinstance(m, BatchNorm) for t in (m.running_mean, m.running_var)]


def _refuse_global_batch_ops(model: nn.Module) -> None:
    """A data axis above 1 with a BatchNorm or Mixup/CutMix: the JAX step
    takes their statistics and permutation over the global batch, which
    the port has no collective for yet."""
    mesh = ambient_mesh()
    if mesh is None or mesh.data_size <= 1:
        return
    if _batchnorm_stats(model):
        raise NotImplementedError(GLOBAL_BATCH_NOT_PORTED.format(what="a BatchNorm head (its batch statistics)"))
    if getattr(model, "mixes", False):
        raise NotImplementedError(GLOBAL_BATCH_NOT_PORTED.format(what="Mixup/CutMix (its batch permutation)"))


def create_state(
    model_or_cfgs: nn.Module | tuple,
    optim: OptimConfig | Optimizer | Identity,
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
    ``rng_seed`` seeds the per-step noise, dropout and mixup streams.
    An optimizer with ``low_precision`` (``OptimConfig.param_dtype``)
    keeps float32 copies of the parameters as given as its master
    weights, and the parameters are then stored in that dtype (BatchNorm
    statistics stay float32)."""
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
        enc = getattr(model, "encoder_cfg", None)  # the encoder depth for layer-wise lr decay
        optim = make_optimizer(optim, global_batch_size, num_layers=None if enc is None else enc.layers)
    opt_state = optim.init(model)
    if optim.low_precision is not None:
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(optim.low_precision)
    return TrainState(model=model, tx=optim, opt_state=opt_state, step=0, seed=rng_seed)


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A batch leaf on ``device``; a tensor already there (the CUDA-stream
    prefetch's) passes through untouched."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t if t.device == device else t.to(device, non_blocking=True)


def _average_over_data(params: list[torch.Tensor], grads: list[torch.Tensor | None],
                       scalars: list[torch.Tensor]) -> list[torch.Tensor]:
    """Average ``grads`` (in place; a ``None`` becomes zeros, as every rank
    must send the same layout) and the scalar metrics over the ambient
    mesh's data group, in one all-reduce; returns the averaged scalars."""
    mesh = ambient_mesh()
    group = None if mesh is None else mesh.group("data")
    if group is None:
        return scalars
    for i, (p, g) in enumerate(zip(params, grads)):
        if g is None:
            grads[i] = torch.zeros_like(p)
    dt = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads] + [m.reshape(1).to(dt) for m in scalars])
    if flat.is_cuda and dist.get_backend(group) == "gloo":
        # gloo reduces on the host (ranks sharing a card): staged there explicitly
        host = flat.cpu()
        dist.all_reduce(host, group=group)
        flat.copy_(host)
    else:
        dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = flat.split([g.numel() for g in grads] + [1] * len(scalars))
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(parts, grads)])
    return [c.reshape(()).to(m.dtype) for c, m in zip(parts[len(grads):], scalars)]


def _micro(x: torch.Tensor, grad_accum: int) -> list[torch.Tensor]:
    return [x] if grad_accum == 1 else list(x)


def make_train_step(
    *,
    mode: Mode = "pretrain",
    grad_accum: int = 1,
    guard_nonfinite: bool = False,
    diag: bool = False,
    pipe_microbatches: int = 0,
) -> Callable[..., tuple[TrainState, dict]]:
    """Build ``train_step(state, batch, inject=None, *, diag=None) ->
    (state, metrics)``; the call's ``diag=False`` skips a ``diag=True``
    step's group statistics (``finite_frac`` stays)."""
    _check_mode(mode)
    if pipe_microbatches:
        raise NotImplementedError(PIPE_NOT_PORTED)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    names = ("loss",) if mode == "pretrain" else ("loss", "acc1", "acc5")
    if diag:
        names += ("finite_frac",)
    factory_diag = diag

    def train_step(state: TrainState, batch: dict, inject=None, *, diag: bool | None = None
                   ) -> tuple[TrainState, dict]:
        loss_mult, grad_mult = (1.0, 1.0) if inject is None else (float(inject[0]), float(inject[1]))
        want_stats = factory_diag and diag is not False
        model = state.model.train()
        _refuse_global_batch_ops(model)
        named = list(model.named_parameters())
        params = [p for _, p in named]
        for p in params:
            p.grad = None
        images = _micro(_to_device(batch["images"], state.device), grad_accum)
        labels = _micro(_to_device(batch["labels"], state.device), grad_accum) if mode == "classify" else None
        stats = _batchnorm_stats(model)
        stats_before = [t.clone() for t in stats] if guard_nonfinite else []
        sums = {k: torch.zeros((), device=state.device) for k in names}
        for micro, x in enumerate(images):
            gens = state.step_generators(micro=micro)
            raw = model(x, generators=gens) if labels is None else model(x, labels[micro], generators=gens)
            out = raw if labels is None else {k: v.mean() for k, v in raw.items()}
            if factory_diag:
                # the finite share of the per-sample loss (the classifier's
                # "loss" is per sample), as the JAX step's loss_fn
                ps = raw.get("loss_per_sample", raw["loss"]).detach()
                out["finite_frac"] = torch.isfinite(ps).float().mean()
            (out["loss"] * loss_mult).backward()
            for k in names:
                sums[k] = sums[k] + out[k].detach()
        # a parameter the step did not differentiate (a linear probe's trunk)
        # keeps a None gradient: zeros to the guard and the optimizer
        grads = [p.grad for p in params]
        avg = _average_over_data(params, grads, [sums[k] / grad_accum for k in names])
        metrics: dict[str, Any] = dict(zip(names, avg))
        live = [g for g in grads if g is not None]
        if grad_accum > 1:  # the JAX step scales by 1/accum, then by grad_mult
            torch._foreach_mul_(live, 1.0 / grad_accum)
        if grad_mult != 1.0:
            torch._foreach_mul_(live, grad_mult)
        # the parameters before the update: the optimizer writes in place
        old = torch._foreach_mul([p.detach() for p in params], 1.0) if want_stats else None  # x*1 keeps every bit
        apply = True
        if guard_nonfinite:
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(live)))
            finite = bool(torch.isfinite(metrics["loss"] * loss_mult).item() and torch.isfinite(grad_norm).item())
            metrics |= {"grad_norm": grad_norm, "skipped": 0.0 if finite else 1.0}
            apply = finite
        if apply:
            state.tx.update(state.opt_state, params, grads)
        elif stats:
            # the forward moved the BatchNorm statistics before the guard
            # decided; a skipped step leaves them as they were
            torch._foreach_copy_(stats, stats_before)
        if want_stats:
            # one stacked (groups, 3) array: one small fetch per diag step
            metrics["diag"] = group_stats(old, grads, [p.detach() for p in params], names=[n for n, _ in named])
        for p in params:
            p.grad = None
        state.step += 1
        metrics["learning_rate"] = state.opt_state.learning_rate
        return state, metrics

    return train_step


def make_eval_step(*, mode: Mode = "pretrain") -> Callable[..., dict]:
    """Build ``eval_step(state, batch, batch_idx=0) -> sums``: the sums of
    the per-sample metrics over ``valid`` samples (``loss`` in pretraining;
    ``loss``, ``acc1`` and ``acc5`` in classification) and
    ``num_samples``, the valid count; the caller divides at the end (an
    exact weighted mean with ragged last batches). ``batch_idx`` varies the
    MAE mask draw, on a stream kept apart from training's; under a mesh
    with a ``data`` axis the draw covers the global batch, as in training.
    ``eval_step.sums`` names the keys of the sums."""
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
        if mode == "pretrain":
            out = model(images, generators=state.step_generators(micro=batch_idx, domain=EVAL_DOMAIN))
            per_sample = {"loss": out["loss_per_sample"]}
        else:
            labels = _to_device(batch["labels"], state.device)
            out = model(images, torch.where(labels >= 0, labels, torch.zeros_like(labels)))
            per_sample = {k: out[k] for k in ("loss", "acc1", "acc5")}
        sums = {k: (v * valid).sum() for k, v in per_sample.items()}
        sums["num_samples"] = valid.sum()
        return sums

    # the keys of every call's sums, so that a process with no batch can
    # still take its part in a sum over processes
    eval_step.sums = ("loss", "num_samples") if mode == "pretrain" else ("loss", "acc1", "acc5", "num_samples")
    return eval_step
