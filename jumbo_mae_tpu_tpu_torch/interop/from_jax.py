"""The weight bridge: a flax ``JumboViT`` params tree → the port's state_dict.

The input is the tree ``JumboViT.init`` lays out, as numpy arrays (nested
dicts): ``cls_tokens``, ``embed/{proj,pos_embed}``, ``jumbo_mlp/fc{1,2}``,
``block_i/{attn/{q,k,v,out},ln1,ln2,ln3,ls1,ls2,ls3,mlp/fc{1,2}}``, ``ln``
and ``head/{fc,bn}``; ``batch_stats`` holds ``head/bn/{mean,var}``. The
layout changes:

- ``DenseGeneral`` kernels: q/k/v are (D, H, hd) → Linear (H·hd, D); out
  is (H, hd, D) → Linear (D, H·hd);
- ``Dense`` kernels (in, out) → Linear weights (out, in);
- the conv kernel is HWIO → OIHW;
- ``pos_embed`` stays (gh, gw, D);
- LayerNorm / BatchNorm ``scale`` → ``weight``.

A key this bridge does not know raises ``KeyError``: a tree from another
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


def _block(out: dict, p: str, blk: dict) -> None:
    attn = blk["attn"]
    for name in ("q", "k", "v"):
        kern = np.asarray(attn[name]["kernel"])  # (D, H, hd)
        out[f"{p}.attn.{name}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
        out[f"{p}.attn.{name}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(-1))
    kern = np.asarray(attn["out"]["kernel"])  # (H, hd, D)
    out[f"{p}.attn.out.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
    out[f"{p}.attn.out.bias"] = _t(attn["out"]["bias"])
    _unknown(f"{p}.attn", set(attn) - {"q", "k", "v", "out"})
    for ln in ("ln1", "ln2", "ln3"):
        _norm(out, f"{p}.{ln}", blk[ln])
    for ls in ("ls1", "ls2", "ls3"):
        if ls in blk:
            out[f"{p}.{ls}"] = _t(blk[ls])
    for fc in ("fc1", "fc2"):
        _dense(out, f"{p}.mlp.{fc}", blk["mlp"][fc])
    _unknown(p, set(blk) - {"attn", "ln1", "ln2", "ln3", "ls1", "ls2", "ls3", "mlp"})


def state_dict_from_jax(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """Map a flax ``JumboViT`` params tree (and its BatchNorm statistics)
    onto the port's ``JumboViT.state_dict()`` names, as float32 tensors."""
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
