"""The port's remat policies against the JAX package's, on the CPU.

``remat_policy`` ``"none"``, ``"dots"`` and ``"dots_no_batch"`` under
``grad_ckpt`` (``models/config.py`` ``checkpoint_policy``, a selective
checkpoint in ``models/layers.py`` ``maybe_remat``) on an MAE model of
2 encoder layers at head_dim 80 (dim 160, 2 heads; the ViT-H/14 head_dim)
and a 1-layer decoder at head_dim 80, float32, the weights drawn at O(1)
from a seeded numpy generator:

- every parameter's gradient under each policy equals the gradient
  without remat bit for bit (the recompute runs the same ops on the same
  values), on the einsum path and on the flash path (its plain versions
  on the CPU);
- and equals the JAX model's gradient under the same ``nn.remat`` policy,
  at atol 1e-5 + 1e-4 of the largest entry (the tolerance of
  tests/test_torch_mae.py: the same float32 math summed in other orders);
- the matmul outputs a block saves: ``jax.ad_checkpoint.
  print_saved_residuals`` lists the dot outputs the JAX backward reads;
  the port's policy marks every matmul output of the block for the
  selective checkpoint. With LayerScale every one of them is read by the
  backward and the counts are equal (10 under ``"dots"``, 8 under
  ``"dots_no_batch"``). Without it, JAX keeps neither MLP's ``fc2``
  output (each feeds a residual add whose backward reads nothing), while
  PyTorch's selective checkpoint caches what the policy marks when the
  forward runs, before it can know: the port saves those two more.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.ad_checkpoint import print_saved_residuals

from jumbo_mae_tpu_tpu.models import DecoderConfig as FlaxDecoderConfig
from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FlaxMAE
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.models.config import checkpoint_policy as jax_policy
from jumbo_mae_tpu_tpu.models.layers import JumboBlock as FlaxJumboBlock
from jumbo_mae_tpu_tpu.models.layers import make_jumbo_mlp as flax_jumbo_mlp
from jumbo_mae_tpu_tpu_torch.interop import mae_state_dict_from_jax, state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, config as tconfig, layers as tlayers, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from torch_port_util import random_images, random_jumbo_params

SIZE, N = 32, 16
ENC = dict(labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32",
           layers=2, dim=160, heads=2)
DEC = dict(layers=1, dim=160, heads=2, dtype="float32")
POLICIES = ["none", "dots", "dots_no_batch"]


def build(seed, policy, attn, ckpt=True, layerscale=False):
    enc = dict(ENC, attn_impl=attn, grad_ckpt=ckpt, remat_policy=policy, layerscale=layerscale)
    dec = dict(DEC, attn_impl=attn, grad_ckpt=ckpt, remat_policy=policy, layerscale=layerscale)
    fmodel = FlaxMAE(flax_preset("vit_t16", **enc), FlaxDecoderConfig(**dec), norm_pix_loss=True)
    init = fmodel.init(jax.random.key(0), np.zeros((1, SIZE, SIZE, 3), np.uint8), True,
                       mask_noise=np.zeros((N,), np.float32))
    rng = np.random.default_rng(seed)
    params = random_jumbo_params(jax.tree_util.tree_map(np.asarray, init["params"]), rng)
    tmodel = MAEPretrainModel(preset("vit_t16", **enc), DecoderConfig(**dec), True, device="cpu", seed=1)
    tmodel.load_state_dict(mae_state_dict_from_jax(params))
    return fmodel, params, tmodel, random_images(rng, 3, SIZE)


def port_grads(tmodel, images, noise):
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(images), mask_noise=torch.from_numpy(noise))
    out["loss"].backward()
    return out["loss"].detach(), {n: p.grad.clone() for n, p in tmodel.named_parameters()}


def jax_grads(fmodel, params, images, noise):
    def loss_fn(p):
        return fmodel.apply({"params": p}, jnp.asarray(images), True, mask_noise=jnp.asarray(noise))["loss"]

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params))


@pytest.mark.parametrize("attn", ["einsum", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_equal_no_remat_and_jax(policy, attn):
    noise = np.random.default_rng(3).random((N,)).astype(np.float32)
    fmodel, params, tmodel, images = build(0, policy, attn)
    loss, grads = port_grads(tmodel, images, noise)
    _, _, plain, _ = build(0, policy, attn, ckpt=False)
    loss0, grads0 = port_grads(plain, images, noise)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
    ref = state_dict_from_jax(jax_grads(fmodel, params, images, noise))
    assert set(ref) == set(grads)
    for name, g in grads.items():
        r = ref[name].numpy()
        scale = float(np.abs(r).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 1e-4 * scale, rtol=0, err_msg=name)


def jax_saved_dots(policy: str, layerscale: bool) -> int:
    """The dot outputs ``print_saved_residuals`` lists for one JumboBlock
    under ``policy`` (einsum attention, as the CPU runs it)."""
    cfg = flax_preset("vit_t16", **dict(ENC, labels=None, layerscale=layerscale, attn_impl="einsum"))

    class One(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return FlaxJumboBlock(cfg, flax_jumbo_mlp(cfg))(x, True)

    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 3 + 4, cfg.dim)), jnp.float32)
    m = One()
    p = m.init(jax.random.key(0), x)
    f = jax.checkpoint(lambda p, x: m.apply(p, x).sum(), policy=jax_policy(policy))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(f, p, x)
    lines = buf.getvalue().splitlines()
    assert any("from the argument x" in ln for ln in lines), lines
    return sum("output of" in ln for ln in lines)


@pytest.mark.parametrize("layerscale", [True, False])
@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_saved_matmuls_per_block_match_jax(policy, layerscale, monkeypatch):
    marked = [0]  # MUST_SAVE decisions of the forward passes
    real = tconfig.checkpoint_policy

    def counting(name):
        inner = real(name)

        def policy_fn(ctx, op, *args, **kwargs):
            out = inner(ctx, op, *args, **kwargs)
            if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                marked[0] += 1
            return out

        return policy_fn

    monkeypatch.setattr(tlayers, "checkpoint_policy", counting)
    enc = dict(ENC, attn_impl="einsum", grad_ckpt=True, remat_policy=policy, layerscale=layerscale)
    tmodel = MAEPretrainModel(preset("vit_t16", **enc), DecoderConfig(**DEC), True, device="cpu", seed=1)
    images = random_images(np.random.default_rng(0), 2, SIZE)
    port_grads(tmodel, images, np.random.default_rng(1).random((N,)).astype(np.float32))
    per_block = marked[0] / ENC["layers"]
    want = jax_saved_dots(policy, layerscale)
    assert want == {("dots", True): 10, ("dots_no_batch", True): 8,
                    ("dots", False): 8, ("dots_no_batch", False): 6}[(policy, layerscale)]
    assert per_block == (want if layerscale else want + 2), (per_block, want)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tconfig.checkpoint_policy("everything")
