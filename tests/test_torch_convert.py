"""The port's checkpoint converters against the JAX package's, on the CPU.

``interop/torch_convert.py`` and ``interop/reference_convert.py`` on
seeded synthetic numpy trees (a ``JumboViT`` tree with LayerScale and a
BatchNorm head drawn at O(1), a plain timm ViT state, reference-layout
trees built from the same leaves): every output equals the JAX
function's exactly (same keys, same arrays), and the round trips are
exact. Then the port's own step: a port ``state_dict`` (a JumboViT, an
MAE model's encoder, a classifier's trunk) to the timm layout and back
equals itself bit for bit, and a plain timm ViT imports into a JumboViT
whose fresh jumbo MLP stays untouched by the merge.
"""

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.interop import reference_convert as jref
from jumbo_mae_tpu_tpu.interop import torch_convert as jtc
from jumbo_mae_tpu_tpu.models import JumboViT as FlaxViT
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu_torch.interop import reference_convert as tref
from jumbo_mae_tpu_tpu_torch.interop import torch_convert as ttc
from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_tree_from_state_dict, state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, JumboViT, preset
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.train.checkpoint import merge_pretrained_params
from torch_port_util import random_batch_stats, random_jumbo_params

HEADS = 4
CFG = dict(image_size=32, patch_size=8, labels=10, layerscale=True, linear_probing=True, batch_norm=True)


def assert_same(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], (*path, k))
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.fixture(scope="module")
def tree():
    """A JumboViT tree (LayerScale, BatchNorm head) and its statistics."""
    init = FlaxViT(flax_preset("vit_t16", **CFG)).init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), True)
    init = jax.tree_util.tree_map(np.asarray, init)
    rng = np.random.default_rng(4)
    return random_jumbo_params(init["params"], rng), random_batch_stats(init["batch_stats"], rng)


def plain_timm_state(rng, d=64, blocks=2, grid=4, labels=10):
    """A plain timm ViT state: one cls_token, the CLS slot in pos_embed."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    st = {"cls_token": f(1, 1, d), "pos_embed": f(1, 1 + grid * grid, d),
          "patch_embed.proj.weight": f(d, 3, 8, 8), "patch_embed.proj.bias": f(d),
          "norm.weight": f(d), "norm.bias": f(d), "head.weight": f(labels, d), "head.bias": f(labels)}
    for i in range(blocks):
        p = f"blocks.{i}."
        st |= {p + "norm1.weight": f(d), p + "norm1.bias": f(d), p + "norm2.weight": f(d), p + "norm2.bias": f(d),
               p + "attn.qkv.weight": f(3 * d, d), p + "attn.qkv.bias": f(3 * d),
               p + "attn.proj.weight": f(d, d), p + "attn.proj.bias": f(d),
               p + "mlp.fc1.weight": f(4 * d, d), p + "mlp.fc1.bias": f(4 * d),
               p + "mlp.fc2.weight": f(d, 4 * d), p + "mlp.fc2.bias": f(d)}
    return st


@pytest.mark.parametrize("root", [None, "model", "encoder"])
def test_flax_to_torch_and_back_equal_jax(tree, root):
    params, stats = tree
    wrapped = params if root is None else {root: params}
    wstats = None if root is None else {root: stats}
    if root is None:  # both read a bare statistics tree as having no encoder
        for fn in (ttc.flax_to_torch_state, jtc.flax_to_torch_state):
            with pytest.raises(KeyError, match="no encoder subtree"):
                fn(params, stats)
    got = ttc.flax_to_torch_state(wrapped, wstats)
    assert_same(got, jtc.flax_to_torch_state(wrapped, wstats))
    back = ttc.torch_to_flax_params(got, heads=HEADS)
    assert_same(back, jtc.torch_to_flax_params(got, heads=HEADS))
    assert_same({k: v for k, v in back.items() if k != "__batch_stats__"}, params)  # exact round trip
    if root is not None:
        assert_same(back["__batch_stats__"], stats)


def test_timm_plain_vit_import_equals_jax():
    st = plain_timm_state(np.random.default_rng(5))
    got = ttc.timm_plain_vit_to_jumbo_state(st, num_cls_tokens=3)
    assert_same(got, jtc.timm_plain_vit_to_jumbo_state(st, num_cls_tokens=3))
    gap = {k: v for k, v in st.items() if k != "cls_token"}  # a GAP-pooled source
    assert_same(ttc.timm_plain_vit_to_jumbo_state(gap), jtc.timm_plain_vit_to_jumbo_state(gap))
    assert_same(ttc.torch_to_flax_params(got, heads=HEADS), jtc.torch_to_flax_params(got, heads=HEADS))


def _reference_tree(params: dict) -> dict:
    """A reference-layout encoder tree holding the leaves of ``params``."""
    att = {"q": "wq", "k": "wk", "v": "wv", "out": "wo"}
    ref = {"cls_tokens": params["cls_tokens"],
           "embed": {"wte": params["embed"]["proj"], "wpe": params["embed"]["pos_embed"]},
           "jumbo_mlp": {"w1": params["jumbo_mlp"]["fc1"], "w2": params["jumbo_mlp"]["fc2"]},
           "norm": params["ln"], "head": {"Dense_0": params["head"]["fc"], "BatchNorm_0": params["head"]["bn"]}}
    for key in (k for k in params if k.startswith("block_")):
        blk = params[key]
        ref[f"layer_{key.split('_')[1]}"] = {
            "attn": {att[n]: v for n, v in blk["attn"].items()},
            "ff": {"w1": blk["mlp"]["fc1"], "w2": blk["mlp"]["fc2"]},
            **{f"norm{i}": blk[f"ln{i}"] for i in (1, 2, 3)}, **{f"scale{i}": blk[f"ls{i}"] for i in (1, 2, 3)},
        }
    return ref


def test_reference_converters_equal_jax(tree):
    params, stats = tree
    ref_enc = _reference_tree(params)
    got = tref.reference_encoder_to_jumbo(ref_enc)
    assert_same(got, jref.reference_encoder_to_jumbo(ref_enc))
    assert_same(got, params)  # the renames give the framework's tree back
    rng = np.random.default_rng(6)
    dec_layer = {"attn": ref_enc["layer_0"]["attn"], "ff": ref_enc["layer_0"]["ff"],
                 "norm1": ref_enc["layer_0"]["norm1"], "norm2": ref_enc["layer_0"]["norm2"]}
    ref_pre = {"model": {k: v for k, v in ref_enc.items() if k != "head"},
               "decoder_model": {"dec_layer_0": dec_layer, "dec_layer_1": dec_layer, "dec_norm": ref_enc["norm"]},
               "image_mask_embedding": rng.standard_normal((1, 1, 64)).astype(np.float32),
               "decoder_proj": {"kernel": rng.standard_normal((64, 64)).astype(np.float32)},
               "decoder_image_output": {"kernel": rng.standard_normal((64, 192)).astype(np.float32)}}
    assert_same(tref.reference_pretrain_to_jumbo(ref_pre), jref.reference_pretrain_to_jumbo(ref_pre))
    bs = {"head": {"BatchNorm_0": stats["head"]["bn"]}}
    assert_same(tref.reference_head_batch_stats_to_jumbo(bs), jref.reference_head_batch_stats_to_jumbo(bs))


def _models():
    enc = preset("vit_t16", **CFG)
    yield "vit", JumboViT(enc, device="cpu", seed=1), ""
    yield "classifier", ClassificationModel(enc, device="cpu", seed=2), "model."
    mae = preset("vit_t16", **dict(CFG, labels=None, linear_probing=False, batch_norm=False, mask_ratio=0.75))
    yield "mae", MAEPretrainModel(mae, DecoderConfig(layers=1, dim=32, heads=2), device="cpu", seed=3), "encoder."


@pytest.mark.parametrize("which", ["vit", "classifier", "mae"])
def test_a_port_state_dict_round_trips_through_timm(which):
    name, model, prefix = next(m for m in _models() if m[0] == which)
    with torch.no_grad():  # O(1) values everywhere, BatchNorm statistics included
        gen = torch.Generator().manual_seed(7)
        for t in model.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen))
    sd = model.state_dict()
    timm = ttc.port_state_to_timm(sd, heads=HEADS)
    assert "blocks.0.attn.qkv.weight" in timm and "jumbo_mlp.fc1.weight" in timm
    back = ttc.timm_to_port_state(timm, heads=HEADS)
    enc = {n[len(prefix):]: t for n, t in sd.items() if n.startswith(prefix)}
    assert set(back) == set(enc)
    for n, t in enc.items():
        assert torch.equal(back[n], t), n


def test_a_plain_timm_vit_warm_starts_a_jumbo_vit():
    enc = preset("vit_t16", image_size=32, patch_size=8, labels=10)
    st = ttc.timm_plain_vit_to_jumbo_state(plain_timm_state(np.random.default_rng(8)))
    sd = ttc.timm_to_port_state(st, heads=HEADS)
    assert not any(n.startswith("jumbo_mlp.") for n in sd)
    model = JumboViT(enc, device="cpu", seed=1)
    params = dict(model.named_parameters())
    stats = {}
    merged = merge_pretrained_params(sd, params, stats=stats, verbose=False)
    assert sorted(stats["new"]) == sorted(n for n in params if n.startswith("jumbo_mlp.") or ".ln3." in n)
    assert torch.equal(merged["cls_tokens"], sd["cls_tokens"]) and merged["jumbo_mlp.fc1.weight"] is params[
        "jumbo_mlp.fc1.weight"]
    assert state_dict_from_jax(ttc.torch_to_flax_params(st, heads=HEADS), plain_vit=True).keys() == sd.keys()


@pytest.mark.parametrize("drop", ["jumbo_mlp", "cls_tokens", "ln3"])
def test_the_bridge_refuses_a_tree_without_jumbo_parts_unless_told(drop):
    _, model, _ = next(_models())
    tree, stats = flax_tree_from_state_dict(model.state_dict(), heads=HEADS)
    # the whole jumbo tree with one part taken away
    if drop == "ln3":
        tree["block_0"] = {k: v for k, v in tree["block_0"].items() if k != "ln3"}
    else:
        tree.pop(drop)
    with pytest.raises(KeyError, match=drop):
        state_dict_from_jax(tree, stats)
    gone = "blocks.0.ln3." if drop == "ln3" else drop
    assert not any(n.startswith(gone) for n in state_dict_from_jax(tree, stats, plain_vit=True))
    st = ttc.timm_plain_vit_to_jumbo_state(plain_timm_state(np.random.default_rng(8)))
    params = ttc.torch_to_flax_params(st, heads=HEADS)
    with pytest.raises(KeyError):  # a converted plain ViT lacks the jumbo MLP and every ln3
        state_dict_from_jax(params, params.pop("__batch_stats__", None))
