"""Patchification and the masked-patch MSE loss.

Counterpart of ``jumbo_mae_tpu_tpu/ops/patches.py``: pure reshape and
transpose work, so plain torch. The loss is computed in float32.
"""

from __future__ import annotations

import torch


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/p · W/p, p²·C), row-major patch order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.transpose(2, 3)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def merge_patches(patches: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, N, p²·C) → (B, H, W, C); inverse of :func:`extract_patches` for a
    square grid (N must be a perfect square)."""
    b, n, _ = patches.shape
    g = int(round(n**0.5))
    x = patches.reshape(b, g, g, patch_size, patch_size, -1)
    x = x.transpose(2, 3)
    return x.reshape(b, g * patch_size, g * patch_size, -1)


def patch_mse_loss_per_sample(
    output: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(B,) float32 mean-squared error over MASKED patches only, per sample.

    ``mask`` is (B, N) with 1 at masked positions; the per-sample mean over
    patches is divided by the masked ratio, so the result is the mean over
    masked patches. With ``mask=None`` it is a plain per-sample MSE."""
    per_patch = (target.float() - output.float()).square().mean(dim=-1)
    if mask is None:
        return per_patch.mean(dim=-1)
    masked_ratio = mask.sum(dim=-1) / mask.shape[-1]
    per_sample = torch.where(mask > 0.0, per_patch, 0.0).mean(dim=-1)
    return per_sample / masked_ratio


def patch_mse_loss(
    output: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Scalar batch mean of :func:`patch_mse_loss_per_sample`."""
    return patch_mse_loss_per_sample(output, target, mask).mean()
