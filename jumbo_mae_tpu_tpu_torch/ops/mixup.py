"""Mixup and CutMix on a float image batch and soft labels.

Counterpart of ``jumbo_mae_tpu_tpu/ops/mixup.py``: a Beta-sampled ratio,
mixing with a permutation of the batch, CutMix through a bounding-box
mask (1 outside the box, 0 inside; the box holds the pixels whose
coordinates on ``linspace(0, 1, W)`` fall in ``[cx − s/2, cx + s/2)``,
s = sqrt(1 − ratio)), and, with both alphas positive, one of the two
chosen per batch by a coin (mixup when the coin exceeds 0.5).

The draws — the Beta ratios, the permutations, the box centre and the
coin — are a handful of numbers a batch, drawn on the host by
:func:`sample_draws` from a numpy generator seeded with the step's
``"mixup"`` stream (``train/state.py`` ``STREAMS``), so every device draws
the same. ``draws=`` takes them from the caller instead, the seam through
which the parity tests pin JAX's draws (as ``random_masking`` takes
``noise=``). JAX computes both mixes and selects one, branch-free under
jit; the port computes only the selected one, which is the same value.

The permutation mixes rows of the batch this process holds; JAX permutes
the global batch, so ``train/steps.py`` refuses mixup on a data axis
above 1 (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np
import torch


def sample_draws(rng: np.random.Generator, batch: int, mixup_alpha: float, cutmix_alpha: float) -> dict:
    """The random numbers one call of :func:`mixup_cutmix` uses."""
    draws: dict = {}
    if mixup_alpha > 0:
        draws["mixup_ratio"] = rng.beta(mixup_alpha, mixup_alpha)
        draws["mixup_perm"] = rng.permutation(batch)
    if cutmix_alpha > 0:
        draws["cutmix_ratio"] = rng.beta(cutmix_alpha, cutmix_alpha)
        draws["cutmix_center"] = rng.random(2)
        draws["cutmix_perm"] = rng.permutation(batch)
    if mixup_alpha > 0 and cutmix_alpha > 0:
        draws["coin"] = rng.random()
    return draws


def _linspace01(n: int) -> np.ndarray:
    """``jnp.linspace(0, 1, n)`` in float32, bit for bit: XLA computes
    ``i · fl(1 / (n − 1))``, not ``i / (n − 1)``."""
    if n == 1:
        return np.zeros(1, np.float32)
    out = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(n - 1))
    out[-1] = 1.0
    return out


def bounding_box_mask(ratio: float, center, height: int, width: int) -> np.ndarray:
    """(height, width) float32: 1 outside the box, 0 inside; the box's
    area is about ``1 − ratio`` of the image."""
    f32 = np.float32
    size = np.sqrt(f32(1) - f32(ratio))
    cx, cy = (f32(c) for c in center)
    half = f32(0.5) * size
    xs, ys = _linspace01(width), _linspace01(height)
    in_x = (cx - half <= xs) & (xs < cx + half)
    in_y = (cy - half <= ys) & (ys < cy + half)
    return (~(in_y[:, None] & in_x[None, :])).astype(np.float32)


def _perm(perm, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(perm), dtype=torch.long).to(device)


def mixup_cutmix(
    images: torch.Tensor,
    labels: torch.Tensor,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    *,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mix a (B, H, W, C) image batch and its (B, K) float32 soft labels.

    The identity with both alphas 0. Otherwise the draws come from
    ``draws`` or, without it, from ``generator``'s seed (the step's
    ``"mixup"`` stream). The mixed images are float32, as JAX's are (its
    float32 ratio promotes the batch)."""
    if mixup_alpha == 0 and cutmix_alpha == 0:
        return images, labels
    if draws is None:
        if generator is None:
            raise ValueError("mixup_cutmix needs a generator (the step's 'mixup' stream) or draws=")
        rng = np.random.default_rng(generator.initial_seed())
        draws = sample_draws(rng, images.shape[0], mixup_alpha, cutmix_alpha)
    take_mixup = cutmix_alpha == 0 or (mixup_alpha > 0 and float(draws["coin"]) > 0.5)
    x = images.float()
    dev = x.device
    if take_mixup:
        r = torch.tensor(np.float32(draws["mixup_ratio"]), device=dev)
        perm = _perm(draws["mixup_perm"], dev)
        return r * x + (1 - r) * x[perm], r * labels + (1 - r) * labels[perm]
    mask_np = bounding_box_mask(draws["cutmix_ratio"], draws["cutmix_center"], x.shape[1], x.shape[2])
    mask = torch.from_numpy(mask_np).to(dev)[None, :, :, None]
    lr = torch.tensor(mask_np.mean(dtype=np.float32), device=dev)
    perm = _perm(draws["cutmix_perm"], dev)
    return mask * x + (1 - mask) * x[perm], lr * labels + (1 - lr) * labels[perm]
