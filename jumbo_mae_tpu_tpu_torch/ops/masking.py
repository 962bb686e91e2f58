"""Random patch masking for MAE pretraining, and the mask algebra.

Counterpart of ``jumbo_mae_tpu_tpu/ops/masking.py``. ``shared`` mode draws
one permutation for the whole batch (the reference's behaviour);
``per_sample`` draws one per sample, for the global batch of which a data
rank keeps its rows. The noise is uniform, drawn from an
explicit ``torch.Generator`` on the tensor's device, or injected through
``noise=`` to pin the permutation (fixed eval masks, parity tests).
Argsorts are stable, as ``jnp.argsort`` is, so ties break alike.

The JAX package offers two gather lowerings; ``"onehot"`` was a TPU
lowering (the gather as a 0/1 matmul on the MXU) and is not ported: the
port has one gather, ``"take"``.
"""

from __future__ import annotations

from typing import Literal

import torch

from jumbo_mae_tpu_tpu_torch.parallel.mesh import batch_rand

MaskMode = Literal["shared", "per_sample"]
GatherImpl = Literal["take", "onehot"]

ONEHOT_NOT_PORTED = (
    "gather_impl='onehot' was a TPU lowering (the gather as a 0/1 matmul "
    "on the MXU) and has no counterpart on the GPU; use 'take'"
)


def _check_impl(impl: str) -> None:
    if impl == "onehot":
        raise NotImplementedError(ONEHOT_NOT_PORTED)
    if impl != "take":
        raise ValueError(f"unknown gather impl {impl!r}; choose 'take'")


def index_sequence(x: torch.Tensor, ids: torch.Tensor, *, impl: GatherImpl = "take") -> torch.Tensor:
    """Gather along the sequence (second) axis.

    ``ids`` may be 1-D (one permutation for every batch row) or 2-D
    ``(batch, n)`` (one per sample)."""
    _check_impl(impl)
    if ids.dim() == 1:
        return x.index_select(1, ids)
    idx = ids.reshape(*ids.shape, *(1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(*ids.shape, *x.shape[2:]))


def random_masking(
    x: torch.Tensor,
    keep_len: int,
    *,
    mode: MaskMode = "shared",
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    gather_impl: GatherImpl = "take",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomly drop all but ``keep_len`` tokens of ``x`` (batch, len, dim).

    Returns ``(kept, mask, ids_restore)``: ``kept`` is (batch, keep_len,
    dim), ``mask`` (batch, len) float32 with 1 at MASKED positions, and
    ``ids_restore`` inverts the shuffle (1-D in shared mode, 2-D per
    sample). ``noise`` (shape ``(len,)`` shared, ``(batch, len)`` per
    sample) overrides the draw from ``generator``."""
    batch, length, _ = x.shape
    if mode not in ("shared", "per_sample"):
        raise ValueError(f"unknown masking mode: {mode!r}")
    expected = (length,) if mode == "shared" else (batch, length)
    if noise is not None and tuple(noise.shape) != expected:
        raise ValueError(
            f"injected noise shape {tuple(noise.shape)} != {expected} for mode={mode!r}"
        )
    if noise is None:
        if generator is None:
            raise ValueError("random_masking needs a generator when no noise is injected")
        if mode == "shared":
            noise = torch.rand(expected, generator=generator, device=x.device, dtype=torch.float32)
        else:  # drawn for the global batch; a data rank keeps its rows
            noise = batch_rand(expected, generator=generator, device=x.device)
    noise = noise.to(x.device)
    ids_shuffle = torch.argsort(noise, dim=-1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=-1, stable=True)
    kept = index_sequence(x, ids_shuffle[..., :keep_len], impl=gather_impl)
    shuffled_mask = (torch.arange(length, device=x.device) >= keep_len).float()
    if mode == "shared":
        mask = shuffled_mask[ids_restore].expand(batch, length)
    else:
        mask = torch.gather(shuffled_mask.expand(batch, length), 1, ids_restore)
    return kept, mask, ids_restore


def unshuffle_with_mask_tokens(
    visible: torch.Tensor,
    mask_token: torch.Tensor,
    ids_restore: torch.Tensor,
    *,
    impl: GatherImpl = "take",
) -> torch.Tensor:
    """Restore the full sequence from visible tokens and a learned mask token.

    ``visible`` is (batch, keep_len, dim); ``mask_token`` broadcasts to
    (batch, length − keep_len, dim). The number of mask tokens is
    ``length − keep_len``, not the reference's ``int(length · ratio)``."""
    _check_impl(impl)
    batch, keep_len, dim = visible.shape
    length = ids_restore.shape[-1]
    mask_tokens = mask_token.expand(batch, length - keep_len, dim).to(visible.dtype)
    return index_sequence(torch.cat([visible, mask_tokens], dim=1), ids_restore)


# Mask algebra: float masks with 1.0 at MASKED positions.


def no_mask(x: torch.Tensor) -> torch.Tensor:
    """All-zeros (nothing masked) mask for a (batch, len, ...) sequence."""
    return torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)


def all_mask(x: torch.Tensor) -> torch.Tensor:
    """All-ones (everything masked) mask for a (batch, len, ...) sequence."""
    return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)


def mask_not(mask: torch.Tensor) -> torch.Tensor:
    """``1.0 − mask``: pure arithmetic, so a soft 0.3 inverts to 0.7."""
    return 1.0 - mask.float()


def mask_union(*masks: torch.Tensor) -> torch.Tensor:
    """Positions masked (> 0) in ANY input mask, as binary 0/1."""
    out = masks[0] > 0
    for m in masks[1:]:
        out = out | (m > 0)
    return out.float()


def mask_intersection(*masks: torch.Tensor) -> torch.Tensor:
    """Positions masked (> 0) in EVERY input mask, as binary 0/1."""
    out = masks[0] > 0
    for m in masks[1:]:
        out = out & (m > 0)
    return out.float()


def mask_select(
    mask: torch.Tensor, when_unmasked: torch.Tensor, when_masked: torch.Tensor
) -> torch.Tensor:
    """``when_unmasked`` where mask == 0, else ``when_masked`` (the
    reference's argument order). The mask broadcasts over trailing axes."""
    m = mask.reshape(*mask.shape, *(1,) * (when_unmasked.dim() - mask.dim()))
    return torch.where(m > 0, when_masked, when_unmasked)
