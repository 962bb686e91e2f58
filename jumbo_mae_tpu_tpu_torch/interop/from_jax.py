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
architecture must not load half-way. :func:`flax_path` is the map the
other way, from a state_dict name to its flax path, and
:func:`flax_tree_from_state_dict` the whole bridge the other way (the
weights publisher writes its artifacts in the flax layout, so the two
packages fingerprint the same weights alike); :func:`state_dict_from_flax`
takes either tree back by its root.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_NORMS = re.compile(r"ln\d?|bn")
_STATS = {"running_mean": "mean", "running_var": "var"}


def flax_path(name: str) -> tuple[str, ...]:
    """The flax path of the port's state_dict entry ``name``: the inverse of
    this bridge's map, for the trees it knows (a ``ClassificationModel``'s
    trunk is ``model.<JumboViT name>`` on both sides). ``blocks.i`` is
    ``block_i``; a norm's ``weight`` is ``scale`` and every other
    ``weight`` a ``kernel``; BatchNorm's ``running_mean``/``running_var``
    are ``mean``/``var`` of ``batch_stats``."""
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks":
            out.append(f"block_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[-1] == "weight":
        out[-1] = "scale" if len(out) > 1 and _NORMS.fullmatch(out[-2]) else "kernel"
    out[-1] = _STATS.get(out[-1], out[-1])
    return tuple(out)


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
        _unknown("head", set(head) - {"fc", "bn"})
    return out


def classifier_state_dict_from_jax(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """Map a flax ``ClassificationModel`` tree (its ``JumboViT`` under
    ``model``) and its BatchNorm statistics onto the port's
    ``ClassificationModel.state_dict()`` names."""
    _unknown("", set(params) - {"model"})
    stats = (batch_stats or {}).get("model")
    return {f"model.{k}": v for k, v in state_dict_from_jax(params["model"], stats).items()}


def state_dict_from_flax(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of any tree this bridge knows, by its root:
    a ``ClassificationModel`` (``model``), an ``MAEPretrainModel``
    (``encoder``) or a ``JumboViT``."""
    if "model" in params:
        return classifier_state_dict_from_jax(params, batch_stats)
    return state_dict_from_jax(params, batch_stats)


# ------------------------------------------------------------ the way back


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _take(sd: dict, name: str) -> np.ndarray:
    return _np(sd.pop(name))


def _dense_back(sd: dict, prefix: str) -> dict:
    return {"kernel": _take(sd, prefix + ".weight").T, "bias": _take(sd, prefix + ".bias")}


def _norm_back(sd: dict, prefix: str) -> dict:
    return {"scale": _take(sd, prefix + ".weight"), "bias": _take(sd, prefix + ".bias")}


def _attention_back(sd: dict, p: str, heads: int) -> dict:
    out = {}
    for name in ("q", "k", "v"):
        w = _take(sd, f"{p}.{name}.weight")  # (H·hd, D)
        out[name] = {"kernel": w.T.reshape(w.shape[1], heads, -1),
                     "bias": _take(sd, f"{p}.{name}.bias").reshape(heads, -1)}
    w = _take(sd, f"{p}.out.weight")  # (D, H·hd)
    out["out"] = {"kernel": w.T.reshape(heads, -1, w.shape[0]), "bias": _take(sd, f"{p}.out.bias")}
    return out


def _block_back(sd: dict, p: str, heads: int, norms: tuple[str, ...], scales: tuple[str, ...]) -> dict:
    blk = {"attn": _attention_back(sd, f"{p}.attn", heads)}
    for ln in norms:
        blk[ln] = _norm_back(sd, f"{p}.{ln}")
    for ls in scales:
        if f"{p}.{ls}" in sd:
            blk[ls] = _take(sd, f"{p}.{ls}")
    blk["mlp"] = {fc: _dense_back(sd, f"{p}.mlp.{fc}") for fc in ("fc1", "fc2")}
    return blk


def _blocks(sd: dict, prefix: str) -> list[int]:
    return sorted({int(n[len(prefix):].split(".", 1)[0]) for n in sd if n.startswith(prefix)})


def _vit_back(sd: dict, heads: int) -> tuple[dict, dict | None]:
    params: dict = {"cls_tokens": _take(sd, "cls_tokens")}
    embed = {"proj": {"kernel": _take(sd, "embed.proj.weight").transpose(2, 3, 1, 0),  # OIHW -> HWIO
                      "bias": _take(sd, "embed.proj.bias")}}
    if "embed.pos_embed" in sd:
        embed["pos_embed"] = _take(sd, "embed.pos_embed")
    params["embed"] = embed
    params["jumbo_mlp"] = {fc: _dense_back(sd, f"jumbo_mlp.{fc}") for fc in ("fc1", "fc2")}
    for i in _blocks(sd, "blocks."):
        params[f"block_{i}"] = _block_back(sd, f"blocks.{i}", heads, ("ln1", "ln2", "ln3"), ("ls1", "ls2", "ls3"))
    params["ln"] = _norm_back(sd, "ln")
    stats = None
    if "head.fc.weight" in sd:
        head = {"fc": _dense_back(sd, "head.fc")}
        if "head.bn.weight" in sd:
            head["bn"] = _norm_back(sd, "head.bn")
            stats = {"head": {"bn": {"mean": _take(sd, "head.bn.running_mean"),
                                     "var": _take(sd, "head.bn.running_var")}}}
        params["head"] = head
    return params, stats


def flax_tree_from_state_dict(state_dict: dict, *, heads: int, dec_heads: int | None = None
                              ) -> tuple[dict, dict | None]:
    """The inverse of this bridge: the port's ``state_dict`` of a
    ``JumboViT``, a ``ClassificationModel`` (``model.`` names) or an
    ``MAEPretrainModel`` (``encoder.`` names; ``dec_heads`` required) as
    the flax ``(params, batch_stats)`` trees, float32 numpy leaves.
    ``heads`` splits the q/k/v/out kernels into their flax (D, H, hd)
    layout. A name the bridge does not know raises ``KeyError``."""
    sd = dict(state_dict)
    if any(n.startswith("model.") for n in sd):
        inner = {n[len("model."):]: t for n, t in sd.items() if n.startswith("model.")}
        vit, stats = _vit_back(inner, heads)
        _unknown("model", inner)
        _unknown("", [n for n in sd if not n.startswith("model.")])
        return {"model": vit}, (None if stats is None else {"model": stats})
    if any(n.startswith("encoder.") for n in sd):
        if dec_heads is None:
            raise ValueError("an MAE state_dict needs dec_heads to lay out the decoder's attention")
        enc = {n[len("encoder."):]: t for n, t in sd.items() if n.startswith("encoder.")}
        encoder, _ = _vit_back(enc, heads)
        _unknown("encoder", enc)
        rest = {n: t for n, t in sd.items() if not n.startswith("encoder.")}
        params = {"encoder": encoder, "mask_token": _take(rest, "mask_token"),
                  "decoder_proj": _dense_back(rest, "decoder_proj"), "pixel_proj": _dense_back(rest, "pixel_proj")}
        dec = {f"block_{i}": _block_back(rest, f"decoder.blocks.{i}", dec_heads, ("ln1", "ln2"), ("ls1", "ls2"))
               for i in _blocks(rest, "decoder.blocks.")}
        dec["ln"] = _norm_back(rest, "decoder.ln")
        params["decoder"] = dec
        _unknown("", rest)
        return params, None
    params, stats = _vit_back(sd, heads)
    _unknown("", sd)
    return params, stats


def model_flax_tree(model) -> tuple[dict, dict | None]:
    """:func:`flax_tree_from_state_dict` of a port model, its head counts
    read from its configs."""
    if hasattr(model, "decoder_cfg"):  # MAEPretrainModel
        return flax_tree_from_state_dict(model.state_dict(), heads=model.encoder_cfg.heads,
                                         dec_heads=model.decoder_cfg.heads)
    vit = getattr(model, "model", model)  # a ClassificationModel wraps its JumboViT
    return flax_tree_from_state_dict(model.state_dict(), heads=vit.cfg.heads)
