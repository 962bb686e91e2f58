"""The Jumbo ViT encoder: MAE, classify and feature modes.

Counterpart of ``jumbo_mae_tpu_tpu/models/vit.py``:

- **MAE mode** (``cfg.mask_ratio`` set, ``cfg.labels`` None/0): after the
  patch embedding, patch tokens are randomly masked and only the visible
  ones (plus the CLS tokens) are encoded; returns
  ``(tokens, mask, ids_restore)``;
- **classify mode** (``cfg.labels > 0``): the full sequence is encoded; the
  ``num_cls_tokens`` CLS embeddings are concatenated (or the patch tokens
  mean-pooled, ``pooling="gap"``) and fed to the head; returns logits.
  ``cfg.linear_probing`` runs the trunk without autograd (the JAX model's
  ``stop_gradient``): the trunk's parameters get no gradient;
- **feature mode** (``cfg.labels`` None and no ``mask_ratio``): returns the
  normalized token sequence;
- **token-packed serving** (:meth:`JumboViT.embed_patches`, then
  :meth:`JumboViT.serve_packed` over a buffer ``infer/packing.py``
  plans): requests of several resolutions share one forward, attention
  block-diagonal per segment; :meth:`JumboViT.serve_full` is its
  unpacked mirror and parity reference, at any patch-aligned resolution
  with ``posemb="sincos2d"``.

The shared ``jumbo_mlp`` is built once and handed to every block; with
``grad_ckpt`` each block runs under gradient checkpointing
(``layers.maybe_remat``). Inputs are normalized NHWC images, as the flax
module takes them. Random draws come from explicit generators:
``generators["noise"]`` for the mask (unless ``mask_noise`` pins it) and
``generators["dropout"]``, whose seed each block's dropout and DropPath
sites, and the embedding dropout, derive theirs from.
"""

from __future__ import annotations

import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig, checkpoint_policy
from jumbo_mae_tpu_tpu_torch.models.layers import (
    ClassifierHead,
    Dropout,
    JumboBlock,
    LayerNorm,
    PatchEmbed,
    make_jumbo_mlp,
    maybe_remat,
    segment_attention_mask,
    site_generators,
    trunc_normal_,
)
from jumbo_mae_tpu_tpu_torch.ops.masking import random_masking
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device
from jumbo_mae_tpu_tpu_torch.utils.rng import derive_seed

Generators = dict[str, torch.Generator]

# the domains of block_seeds: the encoder's blocks, the decoder's, and the
# encoder's embedding dropout
ENCODER_DOMAIN, DECODER_DOMAIN, EMBED_DOMAIN = 0, 1, 2


def block_seeds(generators: Generators | None, domain: int, n: int) -> list[int | None]:
    """The dropout and DropPath seed of each of ``n`` blocks: derived from
    the dropout generator's seed, the stack's ``domain`` and the block
    index. ``None``s when there is no dropout generator (eval)."""
    gen = (generators or {}).get("dropout")
    if gen is None:
        return [None] * n
    base = gen.initial_seed()
    return [derive_seed(base, domain, i) for i in range(n)]


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
    the same seed gives the same weights on every device.
    ``init_weights=False`` skips those draws (the weights are then
    PyTorch's construction values), for a caller that overwrites every
    parameter."""

    def __init__(
        self, cfg: JumboViTConfig, *, device: str | torch.device = "cuda", seed: int = 0, init_weights: bool = True
    ):
        super().__init__()
        if cfg.grad_ckpt:
            checkpoint_policy(cfg.remat_policy)  # an unknown policy fails here, not at the first step
        dev = resolve_device(device)
        self.cfg = cfg
        k = cfg.num_cls_tokens
        self.embed = PatchEmbed(cfg)
        self.cls_tokens = nn.Parameter(torch.zeros(1, k, cfg.dim))
        self.jumbo_mlp = make_jumbo_mlp(cfg)
        self.blocks = nn.ModuleList(JumboBlock(cfg) for _ in range(cfg.layers))
        self.ln = LayerNorm(cfg.dim, cfg.compute_dtype)
        self.drop = Dropout(cfg.dropout)
        self.head = None
        if (cfg.labels or 0) > 0:
            in_features = cfg.dim if cfg.pooling == "gap" else k * cfg.dim
            self.head = ClassifierHead(in_features, cfg.labels, cfg.batch_norm)
        if init_weights:
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

    @property
    def mae_mode(self) -> bool:
        return self.head is None and self.cfg.mask_ratio is not None

    def _encode_tokens(self, x: torch.Tensor, generators: Generators | None) -> torch.Tensor:
        """CLS tokens in front of the patch tokens ``x``, every block (under
        ``maybe_remat``) and the final norm."""
        cls = self.cls_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        (g,) = site_generators(self, self.cfg.dropout, block_seeds(generators, EMBED_DOMAIN, 1)[0], x.device, 1)
        x = self.drop(torch.cat([cls, x], dim=1), g)
        run = [maybe_remat(block, self.cfg) for block in self.blocks]
        for block, seed in zip(run, block_seeds(generators, ENCODER_DOMAIN, len(run))):
            x = block(x, self.jumbo_mlp, seed)
        return self.ln(x)

    def encode(self, images: torch.Tensor, generators: Generators | None = None) -> torch.Tensor:
        """Patch embedding, CLS tokens, every block and the final norm:
        (B, k + num_patches, dim) in the compute dtype."""
        return self._encode_tokens(self.embed(images), generators)

    def forward(
        self,
        images: torch.Tensor,
        *,
        mask_noise: torch.Tensor | None = None,
        generators: Generators | None = None,
    ):
        cfg = self.cfg
        if not self.mae_mode:
            if self.head is not None and cfg.linear_probing:
                # the JAX model stops gradients at the trunk's output: no
                # autograd graph, so no backward kernel runs for the trunk
                with torch.no_grad():
                    x = self.encode(images, generators)
            else:
                x = self.encode(images, generators)
            if self.head is None:
                return x
            pooled = pool_tokens(x, cfg.num_cls_tokens, cfg.pooling)
            return self.head(pooled.float())
        x, mask, ids_restore = random_masking(
            self.embed(images),
            cfg.keep_len,
            mode=cfg.mask_mode,
            noise=mask_noise,
            generator=None if mask_noise is not None else (generators or {}).get("noise"),
            gather_impl=cfg.gather_impl,
        )
        return self._encode_tokens(x, generators), mask, ids_restore

    # ------------------------------------------------- token-packed serving

    def embed_patches(self, images: torch.Tensor) -> torch.Tensor:
        """The patch embedding alone (conv + posemb), (B, N, dim), at the
        images' own resolution: stage one of the packed path. The CLS
        tokens are not prepended — posemb applies to patches only, so
        :meth:`encode_packed` writes them into the packed buffer."""
        return self.embed(images)

    def encode_packed(
        self, tokens: torch.Tensor, segment_ids: torch.Tensor, cls_pos: torch.Tensor, cls_index: torch.Tensor
    ) -> torch.Tensor:
        """Every block and the final norm over a packed (rows, budget, dim)
        buffer of patch tokens (zeros at CLS slots and padding), with the
        ``infer/packing.py`` plan arrays: the CLS parameter is written at
        each segment's ``cls_pos`` slots, attention is block-diagonal per
        segment and every other op is per token, so each segment computes
        what its own unpacked row would."""
        x = tokens.to(self.cfg.compute_dtype)
        cls = self.cls_tokens.to(x.dtype)[0]  # (k, dim)
        x = torch.where(cls_pos[..., None] >= 0, cls[cls_pos.clamp_min(0).long()], x)
        (g,) = site_generators(self, self.cfg.dropout, None, x.device, 1)
        x = self.drop(x, g)
        packed = {
            "mask": segment_attention_mask(segment_ids),
            "segment_ids": segment_ids,
            "cls_pos": cls_pos,
            "cls_index": cls_index,
        }
        for block in self.blocks:
            x = block(x, self.jumbo_mlp, None, packed=packed)
        return self.ln(x)

    def pool_packed(
        self,
        tokens: torch.Tensor,
        segment_ids: torch.Tensor,
        cls_pos: torch.Tensor,
        cls_index: torch.Tensor,
        pooling: str = "cls",
    ) -> torch.Tensor:
        """:func:`pool_tokens` per segment: (rows, max_segments, k·dim) for
        ``"cls"``, (rows, max_segments, dim) for ``"gap"``. An unoccupied
        slot pools slot 0's tokens (or a count clamped to 1); callers read
        results through the pack plan, so those never escape."""
        k = self.cfg.num_cls_tokens
        rows, _, dim = tokens.shape
        smax = cls_index.shape[1]
        if pooling == "gap":
            slot = torch.arange(1, smax + 1, dtype=segment_ids.dtype, device=tokens.device)
            own = (segment_ids[:, None, :] == slot[None, :, None]) & (cls_pos[:, None, :] < 0)
            w = own.to(tokens.dtype)
            sums = torch.einsum("rsl,rld->rsd", w, tokens)
            return sums / w.sum(-1).clamp_min(1.0)[..., None]
        idx = cls_index.reshape(rows, smax * k, 1).long().expand(rows, smax * k, dim)
        return torch.gather(tokens, 1, idx).reshape(rows, smax, k * dim)

    def serve_packed(
        self,
        tokens: torch.Tensor,
        segment_ids: torch.Tensor,
        cls_pos: torch.Tensor,
        cls_index: torch.Tensor,
        *,
        pooling: str = "cls",
    ) -> dict[str, torch.Tensor]:
        """The packed serving forward: encode, pool per segment and, with a
        head, classify — ``{"pooled": ..., "logits": ...}``, float32, so
        features and logits requests share one dispatch."""
        x = self.encode_packed(tokens, segment_ids, cls_pos, cls_index)
        pooled = self.pool_packed(x, segment_ids, cls_pos, cls_index, pooling)
        out = {"pooled": pooled.float()}
        if self.head is not None:
            head_in = (
                pooled if pooling == self.cfg.pooling
                else self.pool_packed(x, segment_ids, cls_pos, cls_index, self.cfg.pooling)
            )
            out["logits"] = self.head(head_in.float()).float()
        return out

    def serve_full(self, images: torch.Tensor, *, pooling: str = "cls") -> dict[str, torch.Tensor]:
        """``{"pooled": ..., "logits": ...}`` (logits when there is a head)
        from one encoder pass, both float32: the unpacked mirror of
        :meth:`serve_packed`, at the images' own resolution."""
        cfg = self.cfg
        x = self.encode(images)
        out = {"pooled": pool_tokens(x, cfg.num_cls_tokens, pooling).float()}
        if self.head is not None:
            head_in = pool_tokens(x, cfg.num_cls_tokens, cfg.pooling)
            out["logits"] = self.head(head_in.float()).float()
        return out
