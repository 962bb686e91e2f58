"""Supervised classification: finetuning and linear probing.

Counterpart of ``jumbo_mae_tpu_tpu/models/classifier.py``, with its
numerics:

- uint8 images are normalized on the device into the compute dtype;
- integer labels become one-hot float32 rows (a label outside
  ``[0, labels)`` an all-zero row, as ``flax.linen.one_hot`` gives);
- in training only, label smoothing (``optax.smooth_labels``:
  ``(1 − a)·y + a/K``, CE only) comes **before** Mixup/CutMix, which draw
  from the step's ``"mixup"`` stream (``ops/mixup.py``);
- the trunk is ``JumboViT(cfg.replace(mask_ratio=None))``, its logits
  float32;
- criteria: CE (``optax.softmax_cross_entropy``) and BCE (the sigmoid
  cross-entropy against ``labels > 0``, a mean over classes);
- top-1 and top-5 are membership of the predicted classes in the
  per-sample label set (the classes at the row's maximum), exact for
  single labels and meaningful after mixup.

``forward`` returns per-sample ``loss``, ``acc1`` and ``acc5``; the train
step averages them, the eval step sums them over valid rows. Training
mode is ``self.training`` (``deterministic=False`` in flax).
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig
from jumbo_mae_tpu_tpu_torch.models.vit import Generators, JumboViT
from jumbo_mae_tpu_tpu_torch.ops.mixup import mixup_cutmix
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

Criterion = Literal["ce", "bce"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -(labels * F.log_softmax(logits, dim=-1)).sum(-1)


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    y = (labels > 0).to(logits.dtype)
    return -(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits)).mean(-1)


CRITERIA = {"ce": cross_entropy, "bce": binary_cross_entropy}


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside ``[0, num_classes)`` gives
    zeros, as ``flax.linen.one_hot`` does (``F.one_hot`` raises)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes).float()


class ClassificationModel(nn.Module):
    """uint8 images + integer (or soft) labels → per-sample loss and
    accuracies. Weights from ``seed`` as :class:`JumboViT` draws them."""

    def __init__(
        self,
        encoder_cfg: JumboViTConfig,
        mixup_alpha: float = 0.0,
        cutmix_alpha: float = 0.0,
        label_smoothing: float = 0.0,
        criterion: Criterion = "ce",
        *,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        if (encoder_cfg.labels or 0) <= 0:
            raise ValueError("ClassificationModel requires encoder_cfg.labels > 0")
        if criterion not in CRITERIA:
            raise ValueError(f"unknown criterion {criterion!r}")
        self.encoder_cfg = encoder_cfg
        self.mixup_alpha, self.cutmix_alpha = mixup_alpha, cutmix_alpha
        self.label_smoothing, self.criterion = label_smoothing, criterion
        self.model = JumboViT(encoder_cfg.replace(mask_ratio=None), device=resolve_device(device), seed=seed)
        self.eval()

    @property
    def mixes(self) -> bool:
        return self.mixup_alpha > 0 or self.cutmix_alpha > 0

    def forward(
        self,
        images: torch.Tensor,
        labels: torch.Tensor,
        *,
        generators: Generators | None = None,
        mixup_draws: dict | None = None,
    ) -> dict[str, torch.Tensor]:
        cfg = self.encoder_cfg
        x = normalize_images(images, dtype=cfg.compute_dtype)
        y = one_hot(labels, cfg.labels) if labels.dim() == 1 else labels.float()
        if self.training:
            if self.criterion == "ce" and self.label_smoothing > 0:
                a = self.label_smoothing
                y = (1.0 - a) * y + a / y.shape[-1]
            if self.mixes:
                x, y = mixup_cutmix(
                    x, y, self.mixup_alpha, self.cutmix_alpha,
                    generator=(generators or {}).get("mixup"), draws=mixup_draws,
                )
        logits = self.model(x, generators=generators).float()
        loss = CRITERIA[self.criterion](logits, y)
        label_set = y == y.amax(-1, keepdim=True)
        hits = torch.gather(label_set, 1, torch.topk(logits, k=5, dim=-1).indices)
        return {"loss": loss, "acc1": hits[:, 0].float(), "acc5": hits.any(-1).float()}
