"""Model configuration dataclasses and presets.

Counterpart of ``jumbo_mae_tpu_tpu/models/config.py``: the same frozen
config with the same fields and defaults, so a config round-trips between
the two packages. Fields the serving path does not read (``grad_ckpt``,
``remat_policy``, ``mask_ratio``, ``gather_impl``, ``ring_inner``) stay for
that reason. ``compute_dtype`` returns a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

import torch

Posemb = Literal["learnable", "sincos2d"]
Pooling = Literal["cls", "gap"]
AttnImpl = Literal["einsum", "flash", "ring", "auto"]
MaskModeT = Literal["shared", "per_sample"]
GatherImplT = Literal["take", "onehot"]
RematPolicy = Literal["none", "dots", "dots_no_batch"]

# the compute dtypes the port serves in (the flash kernel takes these two)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config dtype name (``"bfloat16"``...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; have {sorted(_DTYPES)}"
        ) from None


@dataclass(frozen=True)
class JumboViTConfig:
    """Encoder configuration (same fields and defaults as the JAX one)."""

    layers: int = 12
    dim: int = 768
    heads: int = 12
    num_cls_tokens: int = 3
    labels: int | None = 1000
    layerscale: bool = False

    patch_size: int = 16
    image_size: int = 224
    posemb: Posemb = "learnable"
    pooling: Pooling = "cls"

    dropout: float = 0.0
    droppath: float = 0.0
    grad_ckpt: bool = False
    remat_policy: RematPolicy = "none"

    # MAE
    mask_ratio: float | None = None
    mask_mode: MaskModeT = "shared"

    # classification-head behavior
    linear_probing: bool = False
    batch_norm: bool = False

    dtype: str = "bfloat16"  # compute dtype; params always float32
    attn_impl: AttnImpl = "auto"
    ring_inner: str = "einsum"
    gather_impl: GatherImplT = "take"

    def __post_init__(self):
        if self.heads <= 0 or self.dim % self.heads:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by heads ({self.heads})"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def hidden_dim(self) -> int:
        return 4 * self.dim

    @property
    def grid(self) -> tuple[int, int]:
        return (self.image_size // self.patch_size,) * 2

    @property
    def num_patches(self) -> int:
        g = self.grid
        return g[0] * g[1]

    @property
    def keep_len(self) -> int:
        if self.mask_ratio is None:
            raise ValueError("keep_len undefined without mask_ratio")
        return int(self.num_patches * (1.0 - self.mask_ratio))

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "JumboViTConfig":
        return dataclasses.replace(self, **kw)


RING_NOT_PORTED = (
    "attn_impl='ring' (sequence-parallel ring attention) is not ported "
    "yet: ROADMAP queue A6, on kernel K4 (queue B4)"
)
MAE_NOT_PORTED = (
    "MAE mode (mask_ratio set, no labels) is not ported yet: ROADMAP "
    "queue A2 (the pretraining slice)"
)


def require_ported(cfg: JumboViTConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a part of the
    JAX package this port does not have yet, naming the ROADMAP item that
    will bring it. Configs themselves stay constructible, so they
    round-trip; models call this when they are built."""
    if cfg.attn_impl == "ring":
        raise NotImplementedError(RING_NOT_PORTED)
    if cfg.mask_ratio is not None and not (cfg.labels or 0) > 0:
        raise NotImplementedError(MAE_NOT_PORTED)


# Named presets, the same table as the JAX package's.
PRESETS: dict[str, dict] = {
    "vit_t16": dict(layers=2, dim=64, heads=4),  # test-sized
    "vit_s16": dict(layers=12, dim=384, heads=6),
    "vit_b16": dict(layers=12, dim=768, heads=12),
    "vit_l16": dict(layers=24, dim=1024, heads=16),
    "vit_h14": dict(layers=32, dim=1280, heads=16, patch_size=14),
}


def preset(name: str, **overrides) -> JumboViTConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return JumboViTConfig(**{**PRESETS[name], **overrides})
