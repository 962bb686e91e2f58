"""Jumbo checkpoints between the flax layout and the timm-style PyTorch
layout.

Counterpart of ``jumbo_mae_tpu_tpu/interop/torch_convert.py``, on numpy
trees, so both packages convert alike. The PyTorch side uses timm's ViT
names, extended for the jumbo layout:

- ``cls_tokens``                 (1, K, D): K CLS tokens
- ``patch_embed.proj.{weight,bias}``; ``pos_embed`` (1, N, D), the patch grid only
- ``blocks.{i}.norm{1,2,3}.*``, ``blocks.{i}.attn.qkv.{weight,bias}`` (fused),
  ``blocks.{i}.attn.proj.*``, ``blocks.{i}.mlp.fc{1,2}.*``,
  ``blocks.{i}.ls{1,2,3}.gamma`` (LayerScale)
- ``jumbo_mlp.fc{1,2}.*``        stored once (every block shares it)
- ``norm.*``, ``head.{weight,bias}``, ``head_bn.{weight,bias,running_mean,running_var}``

A round trip is exact (transposes, reshapes and concatenations only).
:func:`port_state_to_timm` and :func:`timm_to_port_state` take a port
``state_dict`` to and from that layout through ``interop/from_jax.py``'s
flax tree.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "flax_to_torch_state",
    "port_state_to_timm",
    "timm_plain_vit_to_jumbo_state",
    "timm_to_port_state",
    "torch_to_flax_params",
]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _find_encoder(params: dict) -> dict:
    for key in ("model", "encoder"):
        if key in params:
            return params[key]
    if "cls_tokens" in params:
        return params
    raise KeyError(
        "no encoder subtree found (expected 'model', 'encoder', or a bare "
        f"encoder tree); top-level keys: {sorted(params)}"
    )


def _fuse_qkv(attn: dict) -> tuple[np.ndarray, np.ndarray]:
    """flax q/k/v DenseGeneral kernels (D, H, hd) → torch fused qkv
    (3D, D) weight + (3D,) bias, rows ordered [q; k; v]."""
    ws, bs = [], []
    for name in ("q", "k", "v"):
        k = _np(attn[name]["kernel"])
        d = k.shape[0]
        ws.append(k.reshape(d, -1).T)  # (D_out, D_in)
        bs.append(_np(attn[name]["bias"]).reshape(-1))
    return np.concatenate(ws, axis=0), np.concatenate(bs, axis=0)


def _unfuse_qkv(weight: np.ndarray, bias: np.ndarray, heads: int) -> dict:
    d = weight.shape[1]
    head_dim = d // heads
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        w = weight[i * d : (i + 1) * d]  # (D, D)
        b = bias[i * d : (i + 1) * d]
        out[name] = {
            "kernel": w.T.reshape(d, heads, head_dim),
            "bias": b.reshape(heads, head_dim),
        }
    return out


def _linear_to_torch(mod: dict) -> dict[str, np.ndarray]:
    return {"weight": _np(mod["kernel"]).T, "bias": _np(mod["bias"])}


def _linear_from_torch(weight: np.ndarray, bias: np.ndarray) -> dict:
    return {"kernel": _np(weight).T, "bias": _np(bias)}


def _norm_to_torch(mod: dict) -> dict[str, np.ndarray]:
    return {"weight": _np(mod["scale"]), "bias": _np(mod["bias"])}


def flax_to_torch_state(params: dict, batch_stats: dict | None = None) -> dict:
    """Convert a jumbo encoder param tree (a ``ClassificationModel``/
    ``MAEPretrainModel`` tree or a bare ``JumboViT`` tree) to a torch-style
    flat state dict of numpy arrays (wrap in ``torch.from_numpy`` to save)."""
    enc = _find_encoder(params)
    out: dict[str, np.ndarray] = {}

    out["cls_tokens"] = _np(enc["cls_tokens"])
    embed = enc["embed"]
    # flax conv kernel (p, p, 3, D) → torch (D, 3, p, p)
    out["patch_embed.proj.weight"] = _np(embed["proj"]["kernel"]).transpose(3, 2, 0, 1)
    out["patch_embed.proj.bias"] = _np(embed["proj"]["bias"])
    if "pos_embed" in embed:
        grid = _np(embed["pos_embed"])  # (gh, gw, D)
        out["pos_embed"] = grid.reshape(1, -1, grid.shape[-1])

    blocks = sorted(
        (k for k in enc if k.startswith("block_")), key=lambda k: int(k.split("_")[1])
    )
    for i, bk in enumerate(blocks):
        blk = enc[bk]
        p = f"blocks.{i}."
        w, b = _fuse_qkv(blk["attn"])
        out[p + "attn.qkv.weight"], out[p + "attn.qkv.bias"] = w, b
        proj_k = _np(blk["attn"]["out"]["kernel"])  # (H, hd, D)
        d = proj_k.shape[-1]
        out[p + "attn.proj.weight"] = proj_k.reshape(-1, d).T
        out[p + "attn.proj.bias"] = _np(blk["attn"]["out"]["bias"])
        for ln in ("ln1", "ln2", "ln3"):
            if ln in blk:
                tn = _norm_to_torch(blk[ln])
                out[p + f"norm{ln[-1]}.weight"] = tn["weight"]
                out[p + f"norm{ln[-1]}.bias"] = tn["bias"]
        for ls in ("ls1", "ls2", "ls3"):
            if ls in blk:
                out[p + f"{ls}.gamma"] = _np(blk[ls])
        for fc in ("fc1", "fc2"):
            lt = _linear_to_torch(blk["mlp"][fc])
            out[p + f"mlp.{fc}.weight"] = lt["weight"]
            out[p + f"mlp.{fc}.bias"] = lt["bias"]

    for fc in ("fc1", "fc2"):
        lt = _linear_to_torch(enc["jumbo_mlp"][fc])
        out[f"jumbo_mlp.{fc}.weight"] = lt["weight"]
        out[f"jumbo_mlp.{fc}.bias"] = lt["bias"]

    tn = _norm_to_torch(enc["ln"])
    out["norm.weight"], out["norm.bias"] = tn["weight"], tn["bias"]

    if "head" in enc:
        head = enc["head"]
        if "fc" in head:
            lt = _linear_to_torch(head["fc"])
            out["head.weight"], out["head.bias"] = lt["weight"], lt["bias"]
        if "bn" in head:
            out["head_bn.weight"] = _np(head["bn"]["scale"])
            out["head_bn.bias"] = _np(head["bn"]["bias"])
    if batch_stats is not None:
        bn_stats = _find_encoder(batch_stats).get("head", {}).get("bn", {})
        if bn_stats:
            out["head_bn.running_mean"] = _np(bn_stats["mean"])
            out["head_bn.running_var"] = _np(bn_stats["var"])
    return out


def timm_plain_vit_to_jumbo_state(
    state: dict, *, num_cls_tokens: int = 3
) -> dict:
    """Adapt a PLAIN-ViT timm state dict (single ``cls_token``, CLS position
    baked into ``pos_embed``) to the extended-jumbo torch grammar consumed by
    :func:`torch_to_flax_params` — the timm-hub import workflow of the
    reference's conversion scripts, retargeted at the jumbo layout:

    - the CLS positional embedding folds into the token (as the reference
      did) and the token is tiled to ``num_cls_tokens`` — every jumbo CLS
      slot starts from the pretrained one;
    - ``pos_embed`` drops the CLS slot, leaving the patch-only grid;
    - blocks/norm keys already share the timm grammar and pass through;
    - the jumbo head reads the K CLS embeddings *concatenated* (input K·D,
      ``models/vit.py``), so the plain head weight (L, D) becomes
      (L, K·D) as K copies scaled by 1/K — when the K CLS slots carry the
      same embedding (as they do right after this import), the logits
      equal the plain model's;
    - there is no pretrained source for the shared jumbo MLP — it stays
      absent so a warm-start merge keeps its fresh init.
    """
    state = {k: _np(v) for k, v in state.items()}
    out = {k: v for k, v in state.items() if k not in ("cls_token", "pos_embed")}
    if "head.weight" in state:
        out["head.weight"] = np.tile(
            state["head.weight"] / num_cls_tokens, (1, num_cls_tokens)
        )
    cls = state.get("cls_token")  # (1, 1, D); absent on GAP-pooled models
    if "pos_embed" in state:
        pe = state["pos_embed"]  # (1, 1 + N, D) — CLS position first
        n_patches = pe.shape[1] - (1 if cls is not None else 0)
        side = int(round(np.sqrt(n_patches)))
        if cls is not None and side * side == n_patches:
            cls = cls + pe[:, :1, :]
            out["pos_embed"] = pe[:, 1:, :]
        else:
            # no CLS slot (GAP model) or non-square grid: pass through
            out["pos_embed"] = pe
    if cls is not None:
        out["cls_tokens"] = np.tile(cls, (1, num_cls_tokens, 1))
    # else: GAP-pooled source has no CLS token — leave cls_tokens absent so
    # a warm-start merge keeps the jumbo model's fresh init for them
    return out


def torch_to_flax_params(state: dict, *, heads: int) -> dict:
    """Inverse of :func:`flax_to_torch_state`: torch-style flat dict → bare
    jumbo encoder tree (nest under ``model``/``encoder`` for warm starts via
    ``load_pretrained_params``). ``heads`` is needed to re-split the fused
    qkv. BatchNorm running stats, if present, come back under the key
    ``__batch_stats__``."""
    state = {k: _np(v) for k, v in state.items()}
    enc: dict = {}

    if "cls_tokens" in state:
        enc["cls_tokens"] = state["cls_tokens"]
    # else: GAP-pooled source (no CLS) — warm-start merge keeps fresh init
    embed: dict = {
        "proj": {
            "kernel": state["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
            "bias": state["patch_embed.proj.bias"],
        }
    }
    if "pos_embed" in state:
        pe = state["pos_embed"][0]  # (N, D)
        side = int(round(np.sqrt(pe.shape[0])))
        if side * side != pe.shape[0]:
            raise ValueError(f"non-square pos_embed with {pe.shape[0]} positions")
        embed["pos_embed"] = pe.reshape(side, side, pe.shape[-1])
    enc["embed"] = embed

    n_blocks = 1 + max(
        (int(k.split(".")[1]) for k in state if k.startswith("blocks.")), default=-1
    )
    for i in range(n_blocks):
        p = f"blocks.{i}."
        blk: dict = {}
        attn = _unfuse_qkv(state[p + "attn.qkv.weight"], state[p + "attn.qkv.bias"], heads)
        proj_w = state[p + "attn.proj.weight"]  # (D, D)
        d = proj_w.shape[0]
        attn["out"] = {
            "kernel": proj_w.T.reshape(heads, d // heads, d),
            "bias": state[p + "attn.proj.bias"],
        }
        blk["attn"] = attn
        for n in ("1", "2", "3"):
            if p + f"norm{n}.weight" in state:
                blk[f"ln{n}"] = {
                    "scale": state[p + f"norm{n}.weight"],
                    "bias": state[p + f"norm{n}.bias"],
                }
            if p + f"ls{n}.gamma" in state:
                blk[f"ls{n}"] = state[p + f"ls{n}.gamma"]
        blk["mlp"] = {
            fc: _linear_from_torch(state[p + f"mlp.{fc}.weight"], state[p + f"mlp.{fc}.bias"])
            for fc in ("fc1", "fc2")
        }
        enc[f"block_{i}"] = blk

    if "jumbo_mlp.fc1.weight" in state:
        enc["jumbo_mlp"] = {
            fc: _linear_from_torch(
                state[f"jumbo_mlp.{fc}.weight"], state[f"jumbo_mlp.{fc}.bias"]
            )
            for fc in ("fc1", "fc2")
        }
    # else: plain-ViT source (e.g. a timm hub checkpoint) has no shared
    # jumbo MLP — leave the key out; a warm-start merge keeps fresh init.
    enc["ln"] = {"scale": state["norm.weight"], "bias": state["norm.bias"]}

    head: dict = {}
    if "head.weight" in state:
        head["fc"] = _linear_from_torch(state["head.weight"], state["head.bias"])
    if "head_bn.weight" in state:
        head["bn"] = {"scale": state["head_bn.weight"], "bias": state["head_bn.bias"]}
    if head:
        enc["head"] = head
    if "head_bn.running_mean" in state:
        enc["__batch_stats__"] = {
            "head": {
                "bn": {
                    "mean": state["head_bn.running_mean"],
                    "var": state["head_bn.running_var"],
                }
            }
        }
    return enc


def _encoder_state(state_dict: dict) -> dict:
    """The ``JumboViT`` names of a port ``state_dict``: an MAE model's
    ``encoder.*`` or a classifier's ``model.*`` without the prefix, a
    ``JumboViT``'s as they are."""
    for key in ("encoder.", "model."):
        if any(n.startswith(key) for n in state_dict):
            return {n[len(key):]: t for n, t in state_dict.items() if n.startswith(key)}
    return dict(state_dict)


def port_state_to_timm(state_dict: dict, *, heads: int) -> dict:
    """A port model's encoder (a ``JumboViT``, or the encoder of an MAE
    model or a classifier) as the timm-style state dict of numpy arrays,
    through the flax tree ``interop.from_jax.flax_tree_from_state_dict``
    gives."""
    from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_tree_from_state_dict

    params, batch_stats = flax_tree_from_state_dict(_encoder_state(state_dict), heads=heads)
    # under "model": flax_to_torch_state finds no encoder in bare statistics
    return flax_to_torch_state({"model": params}, None if batch_stats is None else {"model": batch_stats})


def timm_to_port_state(state: dict, *, heads: int) -> dict:
    """A timm-style state dict (this layout, or a plain timm ViT passed
    through :func:`timm_plain_vit_to_jumbo_state`) as a port ``JumboViT``
    ``state_dict`` of float32 tensors, through
    ``interop.from_jax.state_dict_from_jax``. What a plain ViT lacks (the
    shared jumbo MLP, each block's ``ln3``, and the CLS tokens of a
    GAP-pooled one) is left out, so a warm-start merge keeps its fresh
    init; only this path lets the bridge take a tree without them."""
    from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_jax

    params = torch_to_flax_params(state, heads=heads)
    batch_stats = params.pop("__batch_stats__", None)
    return state_dict_from_jax(params, batch_stats, plain_vit=True)
