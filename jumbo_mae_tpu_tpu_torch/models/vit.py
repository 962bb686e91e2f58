"""The Jumbo ViT encoder, classify and feature modes.

Counterpart of ``jumbo_mae_tpu_tpu/models/vit.py``:

- **classify mode** (``cfg.labels > 0``): the full sequence is encoded; the
  ``num_cls_tokens`` CLS embeddings are concatenated (or the patch tokens
  mean-pooled, ``pooling="gap"``) and fed to the head; returns logits;
- **feature mode** (``cfg.labels`` None and no ``mask_ratio``): returns the
  normalized token sequence.

MAE mode is the next slice (ROADMAP queue A2) and raises here. The shared
``jumbo_mlp`` is built once and handed to every block. Inputs are
normalized NHWC images, as the flax module takes them.
"""

from __future__ import annotations

import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig, require_ported
from jumbo_mae_tpu_tpu_torch.models.layers import (
    ClassifierHead,
    JumboBlock,
    LayerNorm,
    PatchEmbed,
    make_jumbo_mlp,
    trunc_normal_,
)
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device


def pool_tokens(tokens: torch.Tensor, num_cls_tokens: int, pooling: str = "cls") -> torch.Tensor:
    """``"cls"`` concatenates the CLS embeddings; ``"gap"`` mean-pools the
    patch tokens."""
    if pooling == "gap":
        return tokens[:, num_cls_tokens:, :].mean(dim=1)
    return tokens[:, :num_cls_tokens, :].reshape(tokens.shape[0], -1)


class JumboViT(nn.Module):
    """The encoder, with a head when ``cfg.labels > 0``.

    Parameters are float32, initialized as flax initializes them
    (truncated normal std 0.02 for dense, conv and learnable positional
    weights; zero biases and CLS tokens; LayerScale 1e-4) from a CPU
    ``torch.Generator`` seeded with ``seed``, then moved to ``device`` —
    the same seed gives the same weights on every device."""

    def __init__(self, cfg: JumboViTConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        require_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        k = cfg.num_cls_tokens
        self.embed = PatchEmbed(cfg)
        self.cls_tokens = nn.Parameter(torch.zeros(1, k, cfg.dim))
        self.jumbo_mlp = make_jumbo_mlp(cfg)
        self.blocks = nn.ModuleList(JumboBlock(cfg) for _ in range(cfg.layers))
        self.ln = LayerNorm(cfg.dim, cfg.compute_dtype)
        self.drop = nn.Dropout(cfg.dropout)
        self.head = None
        if (cfg.labels or 0) > 0:
            in_features = cfg.dim if cfg.pooling == "gap" else k * cfg.dim
            self.head = ClassifierHead(in_features, cfg.labels, cfg.batch_norm)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        self.eval()

    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                trunc_normal_(mod.weight, gen)
                nn.init.zeros_(mod.bias)
        if isinstance(self.embed.pos_embed, nn.Parameter):
            trunc_normal_(self.embed.pos_embed, gen)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Patch embedding, CLS tokens, every block and the final norm:
        (B, k + num_patches, dim) in the compute dtype."""
        cfg = self.cfg
        x = self.embed(images)
        cls = self.cls_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.drop(torch.cat([cls, x], dim=1))
        for block in self.blocks:
            x = block(x, self.jumbo_mlp)
        return self.ln(x)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.encode(images)
        if self.head is None:
            return x
        pooled = pool_tokens(x, self.cfg.num_cls_tokens, self.cfg.pooling)
        return self.head(pooled.float())

    def serve_full(self, images: torch.Tensor, *, pooling: str = "cls") -> dict[str, torch.Tensor]:
        """``{"pooled": ..., "logits": ...}`` (logits when there is a head)
        from one encoder pass, both float32."""
        cfg = self.cfg
        x = self.encode(images)
        out = {"pooled": pool_tokens(x, cfg.num_cls_tokens, pooling).float()}
        if self.head is not None:
            head_in = pool_tokens(x, cfg.num_cls_tokens, cfg.pooling)
            out["logits"] = self.head(head_in.float()).float()
        return out
