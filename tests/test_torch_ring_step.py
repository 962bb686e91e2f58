"""The sequence-parallel model and MAE step against the JAX package, on
the CPU.

- A JumboViT forward with ``attn_impl="ring"`` (einsum inner, the uneven
  3 + 16-token sequence) on ``StackedRing(4)`` against JAX's ring model
  on a (data=2, seq=4) mesh (``tests/test_ring_attention.py:78-98``'s
  setup): float32, atol/rtol 1e-4, the tolerance of the port's ViT
  parity tests.
- Two MAE steps with the encoder on the flash ring and the decoder on
  the einsum ring (``StackedRing(4)``) against JAX's ``make_train_step``
  on a (data=1, fsdp=1, seq=4) mesh, the same weights and mask noise. Off
  the TPU the JAX layer's flash inner takes its einsum hop
  (``ring_attention.py:60-73``) while the port's runs K4's plain
  version: the same attention by another route. Loss at rtol 1e-5 and
  parameters at 1e-2 of the learning rate, the tolerances of
  ``tests/test_torch_train.py`` and for its reasons (attention key biases
  have a zero true gradient, so Adam steps them by round-off and they are
  held to Adam's bound of one learning rate per step).
- The port's ring step against its own step without the ring, and the
  gradient-checkpoint recompute on a thread with no ambient mesh.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jumbo_mae_tpu_tpu.models import DecoderConfig as FlaxDecoderConfig
from jumbo_mae_tpu_tpu.models import JumboViT as FlaxJumboViT
from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FlaxMAE
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.parallel import MeshConfig as FlaxMeshConfig
from jumbo_mae_tpu_tpu.parallel import create_mesh as flax_create_mesh
from jumbo_mae_tpu_tpu.train import OptimConfig as FlaxOptimConfig
from jumbo_mae_tpu_tpu.train import create_sharded_state
from jumbo_mae_tpu_tpu.train import make_optimizer as flax_make_optimizer
from jumbo_mae_tpu_tpu.train import make_train_step as flax_make_train_step
from jumbo_mae_tpu_tpu.utils import compat
from jumbo_mae_tpu_tpu_torch.interop import mae_state_dict_from_jax, state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, JumboViT, layers, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, ambient_mesh, create_mesh, set_mesh
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step
from torch_port_util import random_images, random_jumbo_params


def stacked_mesh(seq: int):
    return create_mesh(MeshConfig(data=1, fsdp=1, seq=seq), device="cpu", one_process_seq=True)



def test_vit_forward_ring_matches_jax_ring_model(devices):
    """tests/test_ring_attention.py:78-98's setup: an uneven 3+16-token
    sequence on the einsum ring; the port on StackedRing(4), JAX on a
    (data=2, seq=4) mesh; both against their einsum models too."""
    cfg = dict(image_size=32, patch_size=8, labels=10, dtype="float32")
    images = random_images(np.random.default_rng(0), 4, 32)
    x = jnp.asarray(images, jnp.float32) / 255.0
    fein = FlaxJumboViT(flax_preset("vit_t16", attn_impl="einsum", **cfg))
    init = jax.tree_util.tree_map(np.asarray, fein.init(jax.random.key(0), x))
    params = random_jumbo_params(init["params"], np.random.default_rng(1))
    want = fein.apply({"params": params}, x)
    fring = FlaxJumboViT(flax_preset("vit_t16", attn_impl="ring", **cfg))
    with compat.set_mesh(flax_create_mesh(FlaxMeshConfig(data=2, fsdp=1, seq=4))):
        ref = jax.jit(fring.apply)({"params": params}, x)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(want), rtol=2e-4, atol=2e-4)

    tring = JumboViT(preset("vit_t16", attn_impl="ring", **cfg), device="cpu")
    tring.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad(), set_mesh(stacked_mesh(4)):
        got = tring(torch.from_numpy(np.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


SIZE = 32
# 16 patches at mask 0.6875 keep 5: 3 CLS + 5 = 8 encoder tokens divide
# over seq 4 (the flash inner needs an even split); the decoder's 19 pad
ENC = dict(labels=None, mask_ratio=0.6875, image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32")
DEC = dict(layers=1, dim=32, heads=2, dtype="float32")
RING_ENC = dict(attn_impl="ring", ring_inner="flash")
RING_DEC = dict(attn_impl="ring", ring_inner="einsum")
OPT = dict(learning_rate=1e-3, lr_scaling="none", warmup_steps=1, training_steps=10, weight_decay=0.05)


class _PinnedNoiseMAE(FlaxMAE):
    """The flax MAE model with its mask noise pinned (a tuple: the module
    must stay hashable for jit)."""

    noise: tuple = ()

    def __call__(self, images, deterministic=True, **kw):
        return super().__call__(images, deterministic, mask_noise=jnp.asarray(self.noise, jnp.float32), **kw)


class _PinnedNoise(MAEPretrainModel):
    """The port's MAE model with its mask noise pinned."""

    def __init__(self, *args, noise: torch.Tensor, **kw):
        super().__init__(*args, **kw)
        self.noise = noise

    def forward(self, images, **kw):
        return super().forward(images, mask_noise=self.noise, **kw)


def test_seq_parallel_mae_step_matches_jax_seq_mesh(devices):
    """Two MAE steps, encoder on the flash ring and decoder on the einsum
    ring: the port on StackedRing(4) against JAX's ``make_train_step`` on
    a (data=1, fsdp=1, seq=4) mesh, the same weights and mask noise."""
    noise = np.random.default_rng(7).random(16).astype(np.float32)
    fmodel = _PinnedNoiseMAE(
        flax_preset("vit_t16", **ENC, **RING_ENC), FlaxDecoderConfig(**DEC, **RING_DEC), True,
        noise=tuple(noise.tolist()),
    )
    images = random_images(np.random.default_rng(8), 4, SIZE)
    batch = {"images": jnp.asarray(images)}
    fmesh = flax_create_mesh(FlaxMeshConfig(data=1, fsdp=1, seq=4))
    tx = flax_make_optimizer(FlaxOptimConfig(**OPT), global_batch_size=256)
    with compat.set_mesh(fmesh):
        state, sharding = create_sharded_state(fmodel, tx, batch, fmesh, mode="pretrain")
        params = random_jumbo_params(jax.tree_util.tree_map(np.asarray, state.params), np.random.default_rng(9))
        state = jax.device_put(state.replace(params=params, opt_state=tx.init(params)), sharding)
        step = flax_make_train_step(fmesh, sharding, mode="pretrain")
        ref_losses = []
        for _ in range(2):
            state, m = step(state, batch)
            ref_losses.append(float(m["loss"]))
    ref = mae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))

    tmodel = _PinnedNoise(preset("vit_t16", **ENC, **RING_ENC), DecoderConfig(**DEC, **RING_DEC), True,
                          device="cpu", noise=torch.from_numpy(noise))
    tmodel.load_state_dict(mae_state_dict_from_jax(params))
    tstate = create_state(tmodel, topt.OptimConfig(**OPT), device="cpu", global_batch_size=256)
    tstep = make_train_step()
    with set_mesh(stacked_mesh(4)):
        for want in ref_losses:
            tstate, m = tstep(tstate, {"images": images})
            np.testing.assert_allclose(m["loss"].item(), want, rtol=1e-5)
    for n, p in tstate.model.named_parameters():
        # k biases have a zero true gradient: Adam steps them by round-off
        atol = 2 * 2 * 1e-3 if n.endswith("attn.k.bias") else 1e-2 * 1e-3
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=atol, rtol=0, err_msg=n)


def _ring_and_plain_states(grad_ckpt=False):
    """The same tiny MAE model, weights and pinned noise, once with ring
    attention (encoder flash, decoder einsum) and once without."""
    noise = torch.from_numpy(np.random.default_rng(5).random(16).astype(np.float32))
    states = []
    for enc_kw, dec_kw in ((RING_ENC, RING_DEC), ({"attn_impl": "flash"}, {"attn_impl": "einsum"})):
        model = _PinnedNoise(preset("vit_t16", **ENC, **enc_kw, grad_ckpt=grad_ckpt, droppath=0.25),
                             DecoderConfig(**DEC, **dec_kw), True, device="cpu", seed=3, noise=noise)
        states.append(create_state(model, topt.OptimConfig(**OPT), device="cpu", global_batch_size=256))
    return states


def test_ring_step_equals_plain_step():
    """The port's own check: two ring steps on StackedRing(4) equal two
    steps without the ring (DropPath on, the same draws)."""
    ring, plain = _ring_and_plain_states()
    batch = {"images": random_images(np.random.default_rng(6), 4, SIZE)}
    step = make_train_step()
    for _ in range(2):
        with set_mesh(stacked_mesh(4)):
            ring, m_ring = step(ring, batch)
        plain, m_plain = step(plain, batch)
        np.testing.assert_allclose(m_ring["loss"].item(), m_plain["loss"].item(), rtol=1e-6)
    for (n, a), b in zip(ring.model.named_parameters(), plain.model.parameters()):
        atol = 2 * 2 * 1e-3 if n.endswith("attn.k.bias") else 1e-2 * 1e-3
        torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=n)


def test_checkpoint_recompute_keeps_the_mesh_on_another_thread(monkeypatch):
    """A CUDA backward runs on a thread of PyTorch's own, where no mesh is
    set; the checkpoint recompute must still take the ring. Here the
    backward runs on a fresh thread, and every ring call must see the mesh
    (forward and recompute: 2 per encoder block), with the gradients of a
    backward on the calling thread."""
    seen = []
    real = layers.ring_self_attention

    def spy(q, k, v, **kw):
        seen.append(ambient_mesh() is not None)
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "ring_self_attention", spy)
    batch = torch.from_numpy(random_images(np.random.default_rng(6), 4, SIZE))
    grads = []
    for threaded in (False, True):
        ring, _ = _ring_and_plain_states(grad_ckpt=True)
        model = ring.model.train()
        gens = ring.step_generators()
        seen.clear()
        with set_mesh(stacked_mesh(4)):
            loss = model(batch, generators=gens)["loss"]
            if threaded:
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join(timeout=60)
                assert not t.is_alive()
            else:
                loss.backward()
        enc_layers = model.encoder_cfg.layers
        assert seen == [True] * (2 * enc_layers + model.decoder_cfg.layers)
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
