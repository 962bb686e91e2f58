"""The port's MAEPretrainModel against the flax one, on the CPU.

Both models get the same weights — drawn at O(1) scale from a seeded numpy
generator and carried into the port by ``mae_state_dict_from_jax`` — the
same uint8 images and the same mask noise. Sizes: a vit_t16 encoder (2
layers, dim 64, 4 heads) at 64 px with 8 px patches (64 patches, 16
visible), a 2-layer decoder of width 32, float32.

Tolerances: the loss at rtol 1e-5; every parameter's gradient at
atol 1e-5 + rtol 1e-4 of the largest entry of that gradient (the same
float32 math, summed in other orders by XLA and by PyTorch, through two
encoder and two decoder blocks). With ``attn_impl="flash"`` the port runs
its flash autograd Function, whose CPU backward is the kernels' plain
version (P recomputed from lse), while the JAX package differentiates
``xla_attention``; gradient checkpointing must not change a bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.models import DecoderConfig as FlaxDecoderConfig
from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FlaxMAE
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu_torch.interop import mae_state_dict_from_jax, state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
from torch_port_util import random_images, random_jumbo_params

SIZE = 64
ENC = dict(labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32")
DEC = dict(layers=2, dim=32, heads=2, dtype="float32")
N, KEEP = 64, 16


def build_pair(seed, *, norm_pix=True, enc=None, dec=None, batch=3):
    """(flax model, flax params, port model, images) with shared weights."""
    ekw, dkw = dict(ENC, **(enc or {})), dict(DEC, **(dec or {}))
    fmodel = FlaxMAE(flax_preset("vit_t16", **ekw), FlaxDecoderConfig(**dkw), norm_pix_loss=norm_pix)
    noise = np.zeros((N,), np.float32) if ekw.get("mask_mode", "shared") == "shared" else np.zeros((1, N), np.float32)
    init = fmodel.init(jax.random.key(0), np.zeros((1, SIZE, SIZE, 3), np.uint8), True, mask_noise=noise)
    rng = np.random.default_rng(seed)
    params = random_jumbo_params(jax.tree_util.tree_map(np.asarray, init["params"]), rng)
    tmodel = MAEPretrainModel(preset("vit_t16", **ekw), DecoderConfig(**dkw), norm_pix, device="cpu", seed=1)
    tmodel.load_state_dict(mae_state_dict_from_jax(params))
    return fmodel, params, tmodel, random_images(rng, batch, SIZE)


def mask_noise(mode, batch, seed):
    shape = (N,) if mode == "shared" else (batch, N)
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def flax_loss_and_grads(fmodel, params, images, noise):
    def loss_fn(p):
        out = fmodel.apply({"params": p}, jnp.asarray(images), True, mask_noise=jnp.asarray(noise))
        return out["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return out, jax.tree_util.tree_map(np.asarray, grads)


def port_loss_and_grads(tmodel, images, noise):
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(images), mask_noise=torch.from_numpy(noise))
    out["loss"].backward()
    return out, {n: p.grad.clone() for n, p in tmodel.named_parameters()}


def assert_grads_close(got: dict, ref_tree: dict):
    ref = state_dict_from_jax(ref_tree)
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name].numpy()
        scale = float(np.abs(r).max())
        assert scale > 0, f"{name}: zero reference gradient"
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 1e-4 * scale, rtol=0, err_msg=name)


CASES = [
    dict(norm_pix=True, mode="shared", attn="einsum", ckpt=False),
    dict(norm_pix=False, mode="per_sample", attn="einsum", ckpt=True),
    dict(norm_pix=True, mode="per_sample", attn="flash", ckpt=True),
    dict(norm_pix=False, mode="shared", attn="flash", ckpt=False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_loss_and_every_gradient_match_flax(case):
    enc = dict(mask_mode=case["mode"], attn_impl=case["attn"], grad_ckpt=case["ckpt"], layerscale=case["norm_pix"])
    dec = dict(attn_impl=case["attn"], grad_ckpt=case["ckpt"], layerscale=case["norm_pix"])
    fmodel, params, tmodel, images = build_pair(0, norm_pix=case["norm_pix"], enc=enc, dec=dec)
    noise = mask_noise(case["mode"], 3, 1)
    ref_out, ref_grads = flax_loss_and_grads(fmodel, params, images, noise)
    launches = fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV
    out, grads = port_loss_and_grads(tmodel, images, noise)
    # on CPU tensors the flash path takes the plain versions: no launch
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == launches
    np.testing.assert_allclose(out["loss"].item(), float(ref_out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["loss_per_sample"].detach().numpy(), np.asarray(ref_out["loss_per_sample"]), rtol=1e-5)
    assert out["loss"].item() > 0.1  # the weights move the loss
    assert_grads_close(grads, ref_grads)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_grad_checkpointing_changes_no_bit(attn):
    noise = mask_noise("shared", 3, 2)
    outs = []
    for ckpt in (False, True):
        _, _, tmodel, images = build_pair(
            3, enc=dict(attn_impl=attn, grad_ckpt=ckpt), dec=dict(attn_impl=attn, grad_ckpt=ckpt)
        )
        outs.append(port_loss_and_grads(tmodel, images, noise))
    (o0, g0), (o1, g1) = outs
    assert torch.equal(o0["loss"], o1["loss"])
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_flash_and_einsum_paths_agree():
    noise = mask_noise("per_sample", 3, 4)
    res = {}
    for attn in ("einsum", "flash"):
        _, _, tmodel, images = build_pair(
            5, enc=dict(attn_impl=attn, mask_mode="per_sample"), dec=dict(attn_impl=attn)
        )
        res[attn] = port_loss_and_grads(tmodel, images, noise)
    (oe, ge), (of, gf) = res["einsum"], res["flash"]
    np.testing.assert_allclose(of["loss"].item(), oe["loss"].item(), rtol=1e-5)
    for name in ge:
        scale = ge[name].abs().max().item()
        torch.testing.assert_close(gf[name], ge[name], atol=1e-5 + 1e-4 * scale, rtol=0)


def test_reconstruction_and_mask_outputs():
    fmodel, params, tmodel, images = build_pair(6)
    noise = mask_noise("shared", 3, 7)
    ref = jax.jit(lambda p, x, n: fmodel.apply({"params": p}, x, True, True, mask_noise=n))(
        params, jnp.asarray(images), jnp.asarray(noise))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), mask_noise=torch.from_numpy(noise), return_reconstruction=True)
    assert got["reconstruction"].shape == (3, N, 8 * 8 * 3)
    assert got["reconstruction"].dtype == torch.float32
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["reconstruction"].numpy(), np.asarray(ref["reconstruction"]), atol=1e-4, rtol=1e-4)


def test_norm_pix_target_uses_population_variance():
    """With norm_pix_loss a target patch is (x − mean)/sqrt(var + 1e-6)
    with the population variance: the loss of a prediction equal to that
    normalized target is 0, and the unbiased variance would not give 0."""
    from jumbo_mae_tpu_tpu_torch.ops.patches import extract_patches, patch_mse_loss_per_sample
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images

    images = random_images(np.random.default_rng(8), 2, SIZE)
    target = extract_patches(normalize_images(torch.from_numpy(images)), 8)
    mean = target.mean(-1, keepdim=True)
    pop = (target - mean) / torch.sqrt(target.var(-1, keepdim=True, correction=0) + 1e-6)
    unbiased = (target - mean) / torch.sqrt(target.var(-1, keepdim=True) + 1e-6)
    np.testing.assert_allclose(pop.numpy(), np.asarray(
        (jnp.asarray(target.numpy()) - jnp.asarray(mean.numpy()))
        / jnp.sqrt(jnp.asarray(target.numpy()).var(axis=-1, keepdims=True) + 1e-6)), atol=1e-5)
    assert (pop - unbiased).abs().max() > 1e-3
    assert patch_mse_loss_per_sample(pop, pop).abs().max() == 0


def test_bf16_loss_close_to_flax():
    """bfloat16 compute: the loss within 2 % of the flax model's (the two
    frameworks round at different places; the loss itself is float32)."""
    enc, dec = dict(dtype="bfloat16"), dict(dtype="bfloat16")
    fmodel, params, tmodel, images = build_pair(9, enc=enc, dec=dec)
    noise = mask_noise("shared", 3, 10)
    ref = jax.jit(lambda p, x, n: fmodel.apply({"params": p}, x, True, mask_noise=n))(
        params, jnp.asarray(images), jnp.asarray(noise))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), mask_noise=torch.from_numpy(noise))
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=2e-2)


def test_mae_tree_maps_every_parameter_and_refuses_unknown_keys():
    fmodel, params, tmodel, _ = build_pair(11, enc=dict(layerscale=True), dec=dict(layerscale=True))
    sd = mae_state_dict_from_jax(params)
    assert set(sd) == {n for n, _ in tmodel.named_parameters()}
    assert "decoder.blocks.1.ls2" in sd and "mask_token" in sd and "pixel_proj.weight" in sd
    bad = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        mae_state_dict_from_jax(bad)
    bad_dec = dict(params, decoder=dict(params["decoder"], block_0=dict(params["decoder"]["block_0"], ln3={})))
    with pytest.raises(KeyError, match="ln3"):
        mae_state_dict_from_jax(bad_dec)


def test_decoder_config_matches_flax_fields_and_defaults():
    import dataclasses

    a = {f.name: f.default for f in dataclasses.fields(FlaxDecoderConfig)}
    b = {f.name: f.default for f in dataclasses.fields(DecoderConfig)}
    assert a == b
    assert DecoderConfig().head_dim == 32 and DecoderConfig().compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="divisible"):
        DecoderConfig(dim=30, heads=4)
