"""On-device image normalization.

Counterpart of ``jumbo_mae_tpu_tpu/ops/preprocess.py``: uint8 images cross
to the device (4x fewer host-to-device bytes than float32) and are
normalized there. The native layout is NHWC; NCHW input is recognised by
the same heuristic and moved to NHWC.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(
    images: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
) -> torch.Tensor:
    """uint8 (B,H,W,C) or (B,C,H,W) → normalized ``dtype`` NHWC.

    The arithmetic runs in float32 and is cast to ``dtype`` last, as the
    JAX version does."""
    if images.ndim != 4:
        raise ValueError(f"expected 4-D image batch, got {tuple(images.shape)}")
    if images.shape[1] <= 4 < images.shape[-1]:  # NCHW heuristic: C in {1,3,4}
        images = images.permute(0, 2, 3, 1)
    x = images.to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(dtype)
