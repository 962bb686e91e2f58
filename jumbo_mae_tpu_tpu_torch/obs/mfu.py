"""Analytic FLOP counting for the Jumbo-MAE workloads.

Counterpart of the counting half of ``jumbo_mae_tpu_tpu/obs/mfu.py``
(``_attention_flops`` … ``classify_flops_per_image``), copied: matmul
FLOPs only, counted from the configs, so MFU = achieved / peak is
comparable across runs. The JAX module's peak table is for TPUs; the
port reads MFU against one H100's dense bf16 peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM dense bf16 TFLOP/s, from NVIDIA's data sheet (at the
# card's full 700 W power limit)
H100_PEAK_BF16_TFLOPS = 989.0


def _attention_flops(seq: int, dim: int, *, causal: bool = False) -> float:
    """Matmul FLOPs for one MHSA block on one sample: qkv+out projections and
    the two (N,N) einsums. 2·m·n·k per matmul."""
    proj = 4 * 2 * seq * dim * dim
    scores = 2 * 2 * seq * seq * dim
    if causal:
        scores /= 2
    return proj + scores


def _mlp_flops(seq: int, dim: int, hidden: int) -> float:
    return 2 * 2 * seq * dim * hidden


def encoder_flops_per_image(cfg, *, masked: bool) -> float:
    """Forward FLOPs for the Jumbo-ViT encoder on one image.

    ``masked=True`` uses the MAE visible-token count (``cfg.keep_len``)."""
    patches = cfg.keep_len if masked else cfg.num_patches
    seq = patches + cfg.num_cls_tokens
    d = cfg.dim
    per_layer = (
        _attention_flops(seq, d)
        + _mlp_flops(patches, d, cfg.hidden_dim)  # patch-token FF
        + _mlp_flops(1, cfg.num_cls_tokens * d, 4 * cfg.num_cls_tokens * d)  # jumbo MLP
    )
    # patchify conv runs on ALL patches (masking happens after embedding)
    embed = 2 * cfg.num_patches * d * (cfg.patch_size**2 * 3)
    return cfg.layers * per_layer + embed


def decoder_flops_per_image(enc_cfg, dec_cfg) -> float:
    seq = enc_cfg.num_patches + enc_cfg.num_cls_tokens
    d = dec_cfg.dim
    per_layer = _attention_flops(seq, d) + _mlp_flops(seq, d, dec_cfg.hidden_dim)
    proj_in = 2 * seq * enc_cfg.dim * d
    proj_out = 2 * enc_cfg.num_patches * d * (enc_cfg.patch_size**2 * 3)
    return dec_cfg.layers * per_layer + proj_in + proj_out


def pretrain_flops_per_image(enc_cfg, dec_cfg, *, training: bool = True) -> float:
    fwd = encoder_flops_per_image(enc_cfg, masked=True) + decoder_flops_per_image(
        enc_cfg, dec_cfg
    )
    return fwd * (3.0 if training else 1.0)  # bwd ≈ 2× fwd


def classify_flops_per_image(enc_cfg, *, training: bool = True) -> float:
    """The classifier's FLOPs per image: the full-sequence encoder and the
    head over ``num_cls_tokens · dim`` features, times 3 in training. Kept
    as the JAX package counts it in linear-probe mode too, where the trunk
    runs no backward: there it counts about three times the FLOPs the step
    does."""
    fwd = encoder_flops_per_image(enc_cfg, masked=False)
    if enc_cfg.labels:
        fwd += 2 * enc_cfg.num_cls_tokens * enc_cfg.dim * enc_cfg.labels
    return fwd * (3.0 if training else 1.0)


def mfu(images_per_s: float, flops_per_image: float, peak_tflops: float = H100_PEAK_BF16_TFLOPS) -> float:
    """Model FLOP utilization: achieved FLOP/s over the peak."""
    return images_per_s * flops_per_image / (peak_tflops * 1e12)
