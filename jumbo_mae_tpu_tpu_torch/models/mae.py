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

from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, JumboViTConfig, checkpoint_policy
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
        if cfg.grad_ckpt:
            checkpoint_policy(cfg.remat_policy)  # an unknown policy fails here, not at the first step
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
    from CPU generators seeded from ``seed``, then moved to ``device``
    (``init_weights=False`` skips the draws, as :class:`JumboViT` does)."""

    def __init__(
        self,
        encoder_cfg: JumboViTConfig,
        decoder_cfg: DecoderConfig,
        norm_pix_loss: bool = False,
        *,
        device: str | torch.device = "cuda",
        seed: int = 0,
        init_weights: bool = True,
    ):
        super().__init__()
        dev = resolve_device(device)
        enc = encoder_cfg.replace(labels=None)
        if enc.mask_ratio is None:
            raise ValueError("encoder_cfg.mask_ratio is required for MAE pretraining")
        self.encoder_cfg = encoder_cfg
        self.decoder_cfg = decoder_cfg
        self.norm_pix_loss = norm_pix_loss
        self.encoder = JumboViT(enc, device=dev, seed=seed, init_weights=init_weights)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_cfg.dim))
        self.decoder_proj = Dense(enc.dim, decoder_cfg.dim, decoder_cfg.compute_dtype)
        self.decoder = MAEDecoder(decoder_cfg, enc.grid, enc.num_cls_tokens)
        self.pixel_proj = Dense(decoder_cfg.dim, enc.patch_size**2 * 3, torch.float32)
        if init_weights:
            gen = torch.Generator().manual_seed(seed + 1)
            trunc_normal_(self.mask_token, gen)
            for mod in (self.decoder_proj, self.pixel_proj, *self.decoder.modules()):
                if isinstance(mod, nn.Linear):
                    trunc_normal_(mod.weight, gen)
                    nn.init.zeros_(mod.bias)
        self.to(dev)
        self.eval()

    def encode_normalized(
        self,
        x: torch.Tensor,
        *,
        mask_noise: torch.Tensor | None = None,
        generators: Generators | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked encoder → ``decoder_proj`` on normalized images: the
        tokens at the decoder width, the mask and ``ids_restore``."""
        tokens, mask, ids_restore = self.encoder(x, mask_noise=mask_noise, generators=generators)
        return self.decoder_proj(tokens), mask, ids_restore

    def mae_encode(
        self,
        images: torch.Tensor,
        *,
        mask_noise: torch.Tensor | None = None,
        generators: Generators | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The first half of the reconstruction forward (the JAX engine's
        ``_mae_encode``): normalize → masked encoder → ``decoder_proj``.
        Everything that depends only on (image, mask): the part a serving
        cache keeps."""
        x = normalize_images(images, dtype=self.encoder_cfg.compute_dtype)
        return self.encode_normalized(x, mask_noise=mask_noise, generators=generators)

    def mae_decode(
        self, tokens: torch.Tensor, ids_restore: torch.Tensor, generators: Generators | None = None
    ) -> torch.Tensor:
        """The second half (``_mae_decode``): mask-token unshuffle →
        decoder → ``pixel_proj``; the float32 per-patch prediction. Row
        independent throughout (per-token norms, attention within a
        sample, a per-sample gather), so zero pad rows stay inert.
        ``ids_restore`` is 1-D (shared mode) or one row per sample."""
        k = self.encoder_cfg.num_cls_tokens
        cls, visible = tokens[:, :k, :], tokens[:, k:, :]
        full = unshuffle_with_mask_tokens(visible, self.mask_token, ids_restore, impl=self.encoder_cfg.gather_impl)
        decoded = self.decoder(torch.cat([cls, full], dim=1), generators)
        return self.pixel_proj(decoded[:, k:, :].float())

    def forward(
        self,
        images: torch.Tensor,
        *,
        mask_noise: torch.Tensor | None = None,
        generators: Generators | None = None,
        return_reconstruction: bool = False,
    ) -> dict[str, torch.Tensor]:
        enc_cfg = self.encoder_cfg
        images = normalize_images(images, dtype=enc_cfg.compute_dtype)
        # the two halves the serving engine runs apart, in this order
        tokens, mask, ids_restore = self.encode_normalized(images, mask_noise=mask_noise, generators=generators)
        pred = self.mae_decode(tokens, ids_restore, generators)

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
