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
    m, s = _constants(tuple(mean), tuple(std), x.device)
    return ((x - m) / s).to(dtype)


_CONSTANTS: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(mean: tuple, std: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and std as float32 tensors on ``device``, made once per
    device: a host-to-device copy cannot run inside a CUDA graph capture,
    and the serving engine captures this function."""
    key = (mean, std, str(device))
    got = _CONSTANTS.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = (torch.tensor(mean, dtype=torch.float32, device=device),
                   torch.tensor(std, dtype=torch.float32, device=device))
        _CONSTANTS[key] = got
    return got
