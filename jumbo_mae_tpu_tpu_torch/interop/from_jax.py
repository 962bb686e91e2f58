"""The weight bridge: a flax params tree → the port's state_dict.

Two trees are known. A ``JumboViT`` tree as ``JumboViT.init`` lays it out
(numpy arrays in nested dicts): ``cls_tokens``, ``embed/{proj,pos_embed}``,
``jumbo_mlp/fc{1,2}``, ``block_i/{attn/{q,k,v,out},ln1,ln2,ln3,ls1,ls2,ls3,
mlp/fc{1,2}}``, ``ln`` and ``head/{fc,bn}``; ``batch_stats`` holds
``head/bn/{mean,var}``. And an ``MAEPretrainModel`` tree: ``encoder`` (a
JumboViT tree without head), ``mask_token``, ``decoder_proj``,
``decoder/{block_i/{attn,ln1,ln2,mlp,ls1,ls2},ln}`` and ``pixel_proj``.
The layout changes:

- ``DenseGeneral`` kernels: q/k/v are (D, H, hd) → Linear (H·hd, D); out
  is (H, hd, D) → Linear (D, H·hd);
- ``Dense`` kernels (in, out) → Linear weights (out, in);
- the conv kernel is HWIO → OIHW;
- ``pos_embed`` stays (gh, gw, D);
- LayerNorm / BatchNorm ``scale`` → ``weight``.

The same mapping carries a gradient tree of the same structure. A key
this bridge does not know raises ``KeyError``: a tree from another
architecture must not load half-way.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(out: dict, prefix: str, mod: dict) -> None:
    out[prefix + ".weight"] = _t(np.asarray(mod["kernel"]).T)
    out[prefix + ".bias"] = _t(mod["bias"])


def _norm(out: dict, prefix: str, mod: dict) -> None:
    out[prefix + ".weight"] = _t(mod["scale"])
    out[prefix + ".bias"] = _t(mod["bias"])


def _unknown(where: str, keys) -> None:
    if keys:
        raise KeyError(f"unknown flax params under {where or 'the root'}: {sorted(keys)}")


def _attention(out: dict, p: str, attn: dict) -> None:
    for name in ("q", "k", "v"):
        kern = np.asarray(attn[name]["kernel"])  # (D, H, hd)
        out[f"{p}.{name}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
        out[f"{p}.{name}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(-1))
    kern = np.asarray(attn["out"]["kernel"])  # (H, hd, D)
    out[f"{p}.out.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
    out[f"{p}.out.bias"] = _t(attn["out"]["bias"])
    _unknown(p, set(attn) - {"q", "k", "v", "out"})


def _block(out: dict, p: str, blk: dict) -> None:
    _attention(out, f"{p}.attn", blk["attn"])
    for ln in ("ln1", "ln2", "ln3"):
        _norm(out, f"{p}.{ln}", blk[ln])
    for ls in ("ls1", "ls2", "ls3"):
        if ls in blk:
            out[f"{p}.{ls}"] = _t(blk[ls])
    for fc in ("fc1", "fc2"):
        _dense(out, f"{p}.mlp.{fc}", blk["mlp"][fc])
    _unknown(p, set(blk) - {"attn", "ln1", "ln2", "ln3", "ls1", "ls2", "ls3", "mlp"})


def _plain_block(out: dict, p: str, blk: dict) -> None:
    _attention(out, f"{p}.attn", blk["attn"])
    for ln in ("ln1", "ln2"):
        _norm(out, f"{p}.{ln}", blk[ln])
    for ls in ("ls1", "ls2"):
        if ls in blk:
            out[f"{p}.{ls}"] = _t(blk[ls])
    for fc in ("fc1", "fc2"):
        _dense(out, f"{p}.mlp.{fc}", blk["mlp"][fc])
    _unknown(p, set(blk) - {"attn", "ln1", "ln2", "ls1", "ls2", "mlp"})


def mae_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Map a flax ``MAEPretrainModel`` params tree onto the port's
    ``MAEPretrainModel.state_dict()`` names, as float32 tensors."""
    out = {f"encoder.{k}": v for k, v in state_dict_from_jax(params["encoder"]).items()}
    out["mask_token"] = _t(params["mask_token"])
    _dense(out, "decoder_proj", params["decoder_proj"])
    _dense(out, "pixel_proj", params["pixel_proj"])
    dec = params["decoder"]
    blocks = [k for k in dec if k.startswith("block_")]
    for key in blocks:
        _plain_block(out, f"decoder.blocks.{int(key.split('_')[1])}", dec[key])
    _norm(out, "decoder.ln", dec["ln"])
    _unknown("decoder", set(dec) - {"ln", *blocks})
    _unknown("", set(params) - {"encoder", "mask_token", "decoder_proj", "decoder", "pixel_proj"})
    return out


def state_dict_from_jax(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """Map a flax ``JumboViT`` params tree (and its BatchNorm statistics)
    onto the port's ``JumboViT.state_dict()`` names, as float32 tensors.
    An ``MAEPretrainModel`` tree (it has an ``encoder``) goes to
    :func:`mae_state_dict_from_jax`."""
    if "encoder" in params:
        return mae_state_dict_from_jax(params)
    out: dict[str, torch.Tensor] = {}
    out["cls_tokens"] = _t(params["cls_tokens"])
    embed = params["embed"]
    kern = np.asarray(embed["proj"]["kernel"])  # (p, p, 3, D) HWIO
    out["embed.proj.weight"] = _t(kern.transpose(3, 2, 0, 1))  # OIHW
    out["embed.proj.bias"] = _t(embed["proj"]["bias"])
    if "pos_embed" in embed:
        out["embed.pos_embed"] = _t(embed["pos_embed"])  # (gh, gw, D)
    _unknown("embed", set(embed) - {"proj", "pos_embed"})
    for fc in ("fc1", "fc2"):
        _dense(out, f"jumbo_mlp.{fc}", params["jumbo_mlp"][fc])
    blocks = [k for k in params if k.startswith("block_")]
    for key in blocks:
        _block(out, f"blocks.{int(key.split('_')[1])}", params[key])
    _norm(out, "ln", params["ln"])
    known = {"cls_tokens", "embed", "jumbo_mlp", "ln", "head", *blocks}
    _unknown("", set(params) - known)

    if "head" in params:
        head = params["head"]
        _dense(out, "head.fc", head["fc"])
        if "bn" in head:
            _norm(out, "head.bn", head["bn"])
            stats = (batch_stats or {}).get("head", {}).get("bn")
            if stats is None:
                raise KeyError("the head has a BatchNorm but batch_stats has no head/bn")
            out["head.bn.running_mean"] = _t(stats["mean"])
            out["head.bn.running_var"] = _t(stats["var"])
            out["head.bn.num_batches_tracked"] = torch.tensor(0)
        _unknown("head", set(head) - {"fc", "bn"})
    return out
