"""The port's JumboViT against the flax JumboViT, on the CPU.

Both models get the same weights — drawn at O(1) scale from a seeded numpy
generator and carried into the port by ``state_dict_from_jax`` — and the
same uint8 images. Tolerances:

- float32: atol 1e-4 / rtol 1e-4. Both run the same float32 math; only
  the order of sums differs (XLA's and PyTorch's CPU matmuls block
  differently).
- bfloat16: relative error ‖port − jax‖ / ‖jax‖ ≤ 3e-2. bf16 keeps 8
  bits of mantissa (rounding step 2^-8 ≈ 4e-3 relative), and the two
  frameworks round at different places: XLA fuses elementwise chains and
  rounds once, PyTorch rounds after every op; matmuls accumulate in
  float32 in different orders. Over two blocks those differences add up
  to about 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.models import JumboViT as FlaxJumboViT
from jumbo_mae_tpu_tpu.models import pool_tokens as flax_pool_tokens
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.ops.preprocess import normalize_images as flax_normalize
from jumbo_mae_tpu_tpu_torch.interop import state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import JumboViT, pool_tokens, preset
from jumbo_mae_tpu_tpu_torch.models.layers import DropPath
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh
from torch_port_util import random_batch_stats, random_images, random_jumbo_params, rel_err

SIZE = 32
TINY = dict(image_size=SIZE, patch_size=4)  # vit_t16: 2 layers, dim 64, 4 heads


def build_pair(seed: int, **overrides):
    """(flax model, flax variables, port model, images) with shared weights."""
    kw = dict(TINY, **overrides)
    jcfg = flax_preset("vit_t16", **kw)
    fmodel = FlaxJumboViT(jcfg)
    init = fmodel.init(
        jax.random.key(0), np.zeros((1, SIZE, SIZE, 3), np.float32), True
    )
    init = jax.tree_util.tree_map(np.asarray, init)
    rng = np.random.default_rng(seed)
    variables = {"params": random_jumbo_params(init["params"], rng)}
    if "batch_stats" in init:
        variables["batch_stats"] = random_batch_stats(init["batch_stats"], rng)
    tmodel = JumboViT(preset("vit_t16", **kw), device="cpu", seed=1)
    tmodel.load_state_dict(
        state_dict_from_jax(variables["params"], variables.get("batch_stats"))
    )
    return fmodel, variables, tmodel, random_images(rng, 3, SIZE)


def run_flax(fmodel, variables, images):
    x = flax_normalize(jnp.asarray(images), dtype=fmodel.cfg.compute_dtype)
    return fmodel.apply(variables, x, True)


def run_port(tmodel, images):
    x = normalize_images(torch.from_numpy(images), dtype=tmodel.cfg.compute_dtype)
    with torch.inference_mode():
        return tmodel(x)


LOGIT_CASES = [
    dict(layerscale=False, posemb="learnable"),
    dict(layerscale=True, posemb="sincos2d"),
    dict(layerscale=True, posemb="learnable", batch_norm=True),
    dict(layerscale=False, posemb="sincos2d", batch_norm=True, pooling="gap"),
]


def _case_id(case: dict) -> str:
    return "-".join(f"{k}={v}" for k, v in case.items())


@pytest.mark.parametrize("case", LOGIT_CASES, ids=_case_id)
def test_logits_match_flax_f32(case):
    fmodel, variables, tmodel, images = build_pair(0, labels=10, dtype="float32", **case)
    ref = np.asarray(run_flax(fmodel, variables, images))
    got = run_port(tmodel, images).numpy()
    assert got.shape == (3, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # the weights move the output: a random init would not match
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("layerscale", [False, True])
@pytest.mark.parametrize("pool", ["cls", "gap", "tokens"])
def test_features_match_flax_f32(pool, layerscale):
    fmodel, variables, tmodel, images = build_pair(
        1, labels=None, dtype="float32", posemb="sincos2d", layerscale=layerscale
    )
    ref_tokens = run_flax(fmodel, variables, images)
    got_tokens = run_port(tmodel, images)
    if pool == "tokens":
        ref, got = np.asarray(ref_tokens), got_tokens.numpy()
        assert got.shape == (3, 3 + 64, 64)
    else:
        ref = np.asarray(flax_pool_tokens(ref_tokens, 3, pool))
        got = pool_tokens(got_tokens, 3, pool).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "case",
    [dict(layerscale=False, posemb="sincos2d"), dict(layerscale=True, posemb="learnable", batch_norm=True)],
    ids=_case_id,
)
def test_logits_match_flax_bf16(case):
    fmodel, variables, tmodel, images = build_pair(2, labels=10, dtype="bfloat16", **case)
    ref = np.asarray(run_flax(fmodel, variables, images), np.float32)
    got = run_port(tmodel, images).float().numpy()
    assert rel_err(got, ref) <= 3e-2


@pytest.mark.parametrize("layerscale", [False, True])
def test_features_match_flax_bf16(layerscale):
    fmodel, variables, tmodel, images = build_pair(
        3, labels=None, dtype="bfloat16", posemb="sincos2d", layerscale=layerscale
    )
    ref = np.asarray(run_flax(fmodel, variables, images), np.float32)
    got = run_port(tmodel, images)
    # LayerScale promotes the residual stream to f32 in both frameworks,
    # and the final norm casts back to the compute dtype
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), ref) <= 3e-2


def test_flash_impl_on_cpu_matches_flax():
    """attn_impl='flash' on CPU tensors runs the kernel's plain version;
    heads=2 gives head_dim 32, a width the CUDA kernel takes."""
    fmodel, variables, tmodel, images = build_pair(
        4, labels=10, dtype="float32", heads=2, attn_impl="flash", layerscale=True
    )
    ref = np.asarray(run_flax(fmodel, variables, images))
    np.testing.assert_allclose(run_port(tmodel, images).numpy(), ref, atol=1e-4, rtol=1e-4)


def test_serve_full_matches_forward():
    _, _, tmodel, images = build_pair(5, labels=10, dtype="float32", pooling="gap")
    x = normalize_images(torch.from_numpy(images))
    with torch.inference_mode():
        out = tmodel.serve_full(x, pooling="cls")
        tokens = tmodel.encode(x)
        logits = tmodel(x)
    assert set(out) == {"pooled", "logits"}
    torch.testing.assert_close(out["pooled"], pool_tokens(tokens, 3, "cls"), rtol=0, atol=0)
    torch.testing.assert_close(out["logits"], logits, rtol=0, atol=0)


def test_unported_modes_raise():
    """MAE mode (ROADMAP A2) is ported: it builds and returns (tokens, mask,
    ids_restore) for the visible patches. Ring attention is ported too (A6,
    the data and seq axes): the ring model builds. An fsdp axis above 1
    (FSDP2, the rest of A6) still raises."""
    mae = JumboViT(preset("vit_t16", labels=None, mask_ratio=0.75, **TINY), device="cpu")
    images = normalize_images(torch.from_numpy(random_images(np.random.default_rng(0), 2, SIZE)))
    with torch.no_grad():
        tokens, mask, ids_restore = mae(images, mask_noise=torch.rand(64))
    assert tokens.shape == (2, 3 + 16, 64)  # 64 patches at mask 0.75 keep 16
    assert mask.shape == (2, 64) and mask.sum().item() == 2 * 48
    assert ids_restore.shape == (64,)
    ring = JumboViT(preset("vit_t16", attn_impl="ring", ring_inner="flash", **TINY), device="cpu")
    assert all(b.attn.cfg.attn_impl == "ring" for b in ring.blocks)
    with pytest.raises(NotImplementedError, match="A6"):
        create_mesh(MeshConfig(data=1, fsdp=2), device="cpu")


def test_same_seed_same_init_and_flax_init_statistics():
    a = JumboViT(preset("vit_t16", **TINY), device="cpu", seed=7)
    b = JumboViT(preset("vit_t16", **TINY), device="cpu", seed=7)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.jumbo_mlp.fc1.weight
    # truncated at ±2σ of 0.02: the truncated normal's std is 0.88·0.02
    assert w.abs().max() <= 0.04 and abs(w.std().item() - 0.0176) < 1e-3
    assert torch.count_nonzero(a.cls_tokens) == 0


def test_droppath_is_inert_in_eval_and_unported_in_training():
    """Inert in eval and at rate 0. In training (ported with the
    pretraining slice): each sample's branch is kept whole and scaled by
    1/(1 − rate) or zeroed whole; the mean over many samples stays near
    the input at rate 0.5; one generator seed gives one result."""
    x = torch.randn(4, 3, 8)
    dp = DropPath(0.5)
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    dp.train()
    with pytest.raises(ValueError, match="generator"):
        dp(x)
    ones = torch.ones(4000, 3, 8)
    y = dp(ones, torch.Generator().manual_seed(0))
    per_sample = y.reshape(4000, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert ((per_sample == per_sample[:, :1]).all(dim=1)).all()  # all or nothing
    kept = (per_sample[:, 0] > 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05 and abs(y.mean().item() - 1.0) < 0.1
    a = dp(x, torch.Generator().manual_seed(3))
    b = dp(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, dp(x, torch.Generator().manual_seed(4)))
