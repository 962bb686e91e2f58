"""The port's small modules against their JAX counterparts, on the CPU:
positional embeddings, image normalization, the config and presets, and
the weight bridge's layout algebra."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.models import JumboViT as FlaxJumboViT
from jumbo_mae_tpu_tpu.models import config as flax_config
from jumbo_mae_tpu_tpu.ops.posemb import sincos2d_positional_embedding as flax_posemb
from jumbo_mae_tpu_tpu.ops.preprocess import normalize_images as flax_normalize
from jumbo_mae_tpu_tpu_torch.interop import state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import JumboViT, config, preset
from jumbo_mae_tpu_tpu_torch.ops.posemb import sincos2d_positional_embedding
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from torch_port_util import random_batch_stats, random_jumbo_params


@pytest.mark.parametrize("grid", [(14, 14, 768), (8, 8, 64), (4, 6, 32)])
def test_posemb_is_the_same_table(grid):
    got = sincos2d_positional_embedding(*grid)
    assert got.dtype == np.float32 and got.shape == grid
    np.testing.assert_array_equal(got, flax_posemb(*grid))


def test_posemb_rejects_dim_not_divisible_by_4():
    with pytest.raises(ValueError):
        sincos2d_positional_embedding(4, 4, 6)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_normalize_matches_jax(layout):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    if layout == "nchw":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    ref = np.asarray(flax_normalize(jnp.asarray(x)))
    got = normalize_images(torch.from_numpy(x))
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    bf = normalize_images(torch.from_numpy(x), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))
    with pytest.raises(ValueError):
        normalize_images(torch.from_numpy(x[0]))


def test_config_fields_and_presets_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(config.JumboViTConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(flax_config.JumboViTConfig)}
    assert ours == theirs
    assert config.PRESETS == flax_config.PRESETS
    for name in config.PRESETS:
        a, b = preset(name, posemb="sincos2d"), flax_config.preset(name, posemb="sincos2d")
        # a config round-trips between the packages field for field
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert flax_config.JumboViTConfig(**dataclasses.asdict(a)) == b
        assert (a.head_dim, a.hidden_dim, a.grid, a.num_patches) == (
            b.head_dim, b.hidden_dim, b.grid, b.num_patches,
        )
    assert preset("vit_b16").compute_dtype == torch.bfloat16
    assert preset("vit_b16", dtype="float32").compute_dtype == torch.float32
    assert preset("vit_b16", mask_ratio=0.75).keep_len == 49 == flax_config.preset("vit_b16", mask_ratio=0.75).keep_len
    with pytest.raises(ValueError):
        preset("vit_b16", heads=7)
    with pytest.raises(ValueError):
        preset("vit_x")
    with pytest.raises(ValueError):
        preset("vit_b16", dtype="int8").compute_dtype


def _flax_tree(**overrides):
    cfg = flax_config.preset("vit_t16", image_size=32, patch_size=4, dtype="float32", **overrides)
    init = FlaxJumboViT(cfg).init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), True)
    return jax.tree_util.tree_map(np.asarray, init)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(labels=None, posemb="sincos2d"),
        dict(labels=10, posemb="learnable", layerscale=True, batch_norm=True),
        dict(labels=10, pooling="gap"),
    ],
    ids=["features", "bn-layerscale", "gap-head"],
)
def test_bridge_fills_every_port_parameter(overrides):
    tree = _flax_tree(**overrides)
    rng = np.random.default_rng(0)
    params = random_jumbo_params(tree["params"], rng)
    stats = random_batch_stats(tree["batch_stats"], rng) if "batch_stats" in tree else None
    sd = state_dict_from_jax(params, stats)
    model = JumboViT(preset("vit_t16", image_size=32, patch_size=4, **overrides), device="cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for key, val in want.items():
        assert sd[key].shape == val.shape, key
    model.load_state_dict(sd)  # strict


def test_bridge_layouts():
    tree = _flax_tree(labels=None, posemb="learnable")
    params = random_jumbo_params(tree["params"], np.random.default_rng(1))
    sd = state_dict_from_jax(params)
    blk = params["block_0"]["attn"]
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    # q: DenseGeneral (D, H, hd) → Linear (H·hd, D)
    ref = np.einsum("sd,dhk->shk", x, blk["q"]["kernel"]) + blk["q"]["bias"]
    got = x @ sd["blocks.0.attn.q.weight"].numpy().T + sd["blocks.0.attn.q.bias"].numpy()
    np.testing.assert_allclose(got, ref.reshape(5, -1), atol=1e-5)
    # out: DenseGeneral (H, hd, D) contracting (h, d) → Linear (D, H·hd)
    z = np.random.default_rng(3).standard_normal((5, 4, 16)).astype(np.float32)
    ref = np.einsum("shk,hkd->sd", z, blk["out"]["kernel"])
    got = z.reshape(5, -1) @ sd["blocks.0.attn.out.weight"].numpy().T
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # conv: HWIO → OIHW
    hwio = params["embed"]["proj"]["kernel"]
    np.testing.assert_array_equal(sd["embed.proj.weight"].numpy()[7, 2, 1, 3], hwio[1, 3, 2, 7])
    # pos_embed stays (gh, gw, D)
    np.testing.assert_array_equal(sd["embed.pos_embed"].numpy(), params["embed"]["pos_embed"])


def test_bridge_rejects_unknown_params():
    tree = _flax_tree(labels=None)
    params = random_jumbo_params(tree["params"], np.random.default_rng(4))
    with pytest.raises(KeyError, match="decoder"):
        state_dict_from_jax({**params, "decoder": {}})
    with pytest.raises(KeyError, match="attn"):
        state_dict_from_jax({**params, "block_0": {**params["block_0"], "attn": {**params["block_0"]["attn"], "qkv": {}}}})
    bn_tree = _flax_tree(labels=10, batch_norm=True)
    with pytest.raises(KeyError, match="batch_stats"):
        state_dict_from_jax(random_jumbo_params(bn_tree["params"], np.random.default_rng(5)))
