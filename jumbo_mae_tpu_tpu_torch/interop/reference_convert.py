"""Reference-layout flax checkpoints into this framework's flax layout.

Counterpart of ``jumbo_mae_tpu_tpu/interop/reference_convert.py``, on
numpy trees. The reference trainer names its modules ``wq/wk/wv/wo``,
``w1/w2``, ``norm1..3``, ``scale1..3``, ``layer_N``, ``dec_layer_N``,
``image_mask_embedding``...; these functions rename and re-nest a tree
(read from a reference ``.msgpack`` by ``train.checkpoint.
import_params_msgpack``) into the ``JumboViT`` / ``MAEPretrainModel`` flax
tree that ``interop/from_jax.py`` maps onto the port. Both sides are flax,
so no kernel is transposed.
"""

from __future__ import annotations

__all__ = [
    "reference_encoder_to_jumbo",
    "reference_pretrain_to_jumbo",
    "reference_head_batch_stats_to_jumbo",
]

_ATTN_MAP = {"wq": "q", "wk": "k", "wv": "v", "wo": "out"}
_MLP_MAP = {"w1": "fc1", "w2": "fc2"}


def _convert_mlp(ff: dict) -> dict:
    return {_MLP_MAP[k]: v for k, v in ff.items()}


def _convert_block(layer: dict, *, jumbo: bool) -> dict:
    """Reference ``JumboLayer``/``ViTLayer`` params → ``JumboBlock``/
    ``PlainBlock`` params."""
    out: dict = {
        "attn": {_ATTN_MAP[k]: v for k, v in layer["attn"].items()},
        "mlp": _convert_mlp(layer["ff"]),
    }
    norms = ("norm1", "norm2", "norm3") if jumbo else ("norm1", "norm2")
    scales = ("scale1", "scale2", "scale3") if jumbo else ("scale1", "scale2")
    for n in norms:
        if n in layer:
            out["ln" + n[-1]] = layer[n]
    for s in scales:
        if s in layer:
            out["ls" + s[-1]] = layer[s]
    return out


def _numbered(tree: dict, prefix: str) -> list[str]:
    keys = [k for k in tree if k.startswith(prefix)]
    return sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))


def reference_encoder_to_jumbo(ref: dict) -> dict:
    """Reference ``ViT`` param tree → ``JumboViT`` param tree.

    Accepts the bare encoder tree (what sits under ``"model"`` in a reference
    checkpoint).
    """
    out: dict = {"cls_tokens": ref["cls_tokens"]}

    embed: dict = {"proj": ref["embed"]["wte"]}
    if "wpe" in ref["embed"]:
        embed["pos_embed"] = ref["embed"]["wpe"]
    out["embed"] = embed

    out["jumbo_mlp"] = _convert_mlp(ref["jumbo_mlp"])
    for key in _numbered(ref, "layer_"):
        idx = key.rsplit("_", 1)[1]
        out[f"block_{idx}"] = _convert_block(ref[key], jumbo=True)
    out["ln"] = ref["norm"]

    if "head" in ref:
        head: dict = {}
        if "Dense_0" in ref["head"]:
            head["fc"] = ref["head"]["Dense_0"]
        if "BatchNorm_0" in ref["head"]:
            head["bn"] = ref["head"]["BatchNorm_0"]
        out["head"] = head
    return out


def _reference_decoder_to_jumbo(ref: dict) -> dict:
    """Reference ``MAEDecoder`` param tree → ``MAEDecoder`` (this package)."""
    out: dict = {}
    for key in _numbered(ref, "dec_layer_"):
        idx = key.rsplit("_", 1)[1]
        out[f"block_{idx}"] = _convert_block(ref[key], jumbo=False)
    out["ln"] = ref["dec_norm"]
    return out


def reference_pretrain_to_jumbo(ref: dict) -> dict:
    """Reference ``PretrainModule`` param tree → ``MAEPretrainModel`` tree.

    Reference layout: ``model`` (ViT), ``decoder_model`` (MAEDecoder),
    ``image_mask_embedding``, ``decoder_proj``, ``decoder_image_output``.
    """
    return {
        "encoder": reference_encoder_to_jumbo(ref["model"]),
        "decoder": _reference_decoder_to_jumbo(ref["decoder_model"]),
        "mask_token": ref["image_mask_embedding"],
        "decoder_proj": ref["decoder_proj"],
        "pixel_proj": ref["decoder_image_output"],
    }


def reference_head_batch_stats_to_jumbo(batch_stats: dict) -> dict:
    """Reference linear-probe BatchNorm running stats
    (``{"head": {"BatchNorm_0": {"mean", "var"}}}``) → this layout
    (``{"head": {"bn": {...}}}``)."""
    bn = batch_stats["head"]["BatchNorm_0"]
    return {"head": {"bn": {"mean": bn["mean"], "var": bn["var"]}}}
