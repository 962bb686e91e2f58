"""MAE decoder and the end-to-end pretraining model.

Counterpart of ``jumbo_mae_tpu_tpu/models/mae.py``, with its numerics:

- the number of mask tokens is ``num_patches − keep_len``;
- decoder positions are fixed sincos2d at the decoder width, added to the
  patch tokens only (never to CLS) and cast to the token dtype;
- ``decoder_proj`` computes in the decoder's compute dtype; ``pixel_proj``
  has no compute dtype in flax, so it computes in float32 on the float32
  cast of the decoded tokens;
- ``norm_pix_loss`` normalizes each target patch by its mean and its
  *population* variance (``var(correction=0)``, as ``jnp.var``), eps 1e-6
  inside the square root;
- the loss is the masked-patch MSE in float32, divided by the masked
  ratio, and ``loss = loss_per_sample.mean()``.
"""

from __future__ import annotations

import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, JumboViTConfig, require_ported
from jumbo_mae_tpu_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    PlainBlock,
    maybe_remat,
    trunc_normal_,
)
from jumbo_mae_tpu_tpu_torch.models.vit import DECODER_DOMAIN, Generators, JumboViT, block_seeds
from jumbo_mae_tpu_tpu_torch.ops.masking import unshuffle_with_mask_tokens
from jumbo_mae_tpu_tpu_torch.ops.patches import extract_patches, patch_mse_loss_per_sample
from jumbo_mae_tpu_tpu_torch.ops.posemb import sincos2d_positional_embedding
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device


class MAEDecoder(nn.Module):
    """Plain pre-norm blocks over the unshuffled full sequence, then a
    final LayerNorm."""

    def __init__(self, cfg: DecoderConfig, grid: tuple[int, int], num_cls_tokens: int):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.num_cls_tokens = num_cls_tokens
        table = sincos2d_positional_embedding(*grid, cfg.dim).reshape(1, -1, cfg.dim)
        self.register_buffer("pos_embed", torch.from_numpy(table), persistent=False)
        self.blocks = nn.ModuleList(PlainBlock(cfg) for _ in range(cfg.layers))
        self.ln = LayerNorm(cfg.dim, cfg.compute_dtype)

    def forward(self, x: torch.Tensor, generators: Generators | None = None) -> torch.Tensor:
        k = self.num_cls_tokens
        x = torch.cat([x[:, :k, :], x[:, k:, :] + self.pos_embed.to(x.dtype)], dim=1)
        run = [maybe_remat(block, self.cfg) for block in self.blocks]
        for block, seed in zip(run, block_seeds(generators, DECODER_DOMAIN, len(run))):
            x = block(x, seed)
        return self.ln(x)


class MAEPretrainModel(nn.Module):
    """uint8 images → masked-patch reconstruction loss.

    Normalize on the device → JumboViT in MAE mode → project to the
    decoder width → insert mask tokens and unshuffle → MAEDecoder →
    per-patch pixel regression → masked MSE.

    Parameters are float32 and initialized as flax initializes them (the
    encoder as :class:`JumboViT` does; ``mask_token`` and every decoder
    dense weight truncated normal std 0.02, zero biases, LayerScale 1e-4),
    from CPU generators seeded from ``seed``, then moved to ``device``."""

    def __init__(
        self,
        encoder_cfg: JumboViTConfig,
        decoder_cfg: DecoderConfig,
        norm_pix_loss: bool = False,
        *,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        enc = encoder_cfg.replace(labels=None)
        if enc.mask_ratio is None:
            raise ValueError("encoder_cfg.mask_ratio is required for MAE pretraining")
        self.encoder_cfg = encoder_cfg
        self.decoder_cfg = decoder_cfg
        self.norm_pix_loss = norm_pix_loss
        self.encoder = JumboViT(enc, device="cpu", seed=seed)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_cfg.dim))
        self.decoder_proj = Dense(enc.dim, decoder_cfg.dim, decoder_cfg.compute_dtype)
        self.decoder = MAEDecoder(decoder_cfg, enc.grid, enc.num_cls_tokens)
        self.pixel_proj = Dense(decoder_cfg.dim, enc.patch_size**2 * 3, torch.float32)
        gen = torch.Generator().manual_seed(seed + 1)
        trunc_normal_(self.mask_token, gen)
        for mod in (self.decoder_proj, self.pixel_proj, *self.decoder.modules()):
            if isinstance(mod, nn.Linear):
                trunc_normal_(mod.weight, gen)
                nn.init.zeros_(mod.bias)
        self.to(dev)
        self.eval()

    def forward(
        self,
        images: torch.Tensor,
        *,
        mask_noise: torch.Tensor | None = None,
        generators: Generators | None = None,
        return_reconstruction: bool = False,
    ) -> dict[str, torch.Tensor]:
        enc_cfg = self.encoder_cfg
        k = enc_cfg.num_cls_tokens
        images = normalize_images(images, dtype=enc_cfg.compute_dtype)

        tokens, mask, ids_restore = self.encoder(images, mask_noise=mask_noise, generators=generators)
        tokens = self.decoder_proj(tokens)
        cls, visible = tokens[:, :k, :], tokens[:, k:, :]
        full = unshuffle_with_mask_tokens(visible, self.mask_token, ids_restore, impl=enc_cfg.gather_impl)
        decoded = self.decoder(torch.cat([cls, full], dim=1), generators)
        pred = self.pixel_proj(decoded[:, k:, :].float())

        target = extract_patches(images.float(), enc_cfg.patch_size)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=0)
            target = (target - mean) / torch.sqrt(var + 1e-6)

        loss_per_sample = patch_mse_loss_per_sample(pred, target, mask)
        out = {"loss": loss_per_sample.mean(), "loss_per_sample": loss_per_sample}
        if return_reconstruction:
            out["reconstruction"] = pred
            out["mask"] = mask
        return out
