"""The port's dropout draws from the step's own streams, on the CPU.

Every dropout site (the embedding dropout, the attention probabilities
and output, both dense layers of each MLP and of the shared jumbo MLP)
draws from a generator of its own, derived from the step's ``"dropout"``
stream, for the global batch (``parallel.mesh.batch_rand``), as DropPath
does. So a training forward leaves torch's default generator alone, and
(seed, step, micro) replays every mask bit for bit. Bit parity with
flax's masks is not possible (the RNGs differ); the data = 2 run against
one process is ``tests/test_torch_gloo.py``. No JAX here: these are the
port's own contracts.
"""

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models import layers
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

SIZE = 32
OPT = topt.OptimConfig(learning_rate=1e-3, lr_scaling="none", warmup_steps=1, training_steps=10)


def dropout_state(rate: float = 0.1, seed: int = 0):
    """A tiny MAE state on the einsum path (head_dim 16 on the CPU) with
    dropout at ``rate`` in the encoder and the decoder."""
    enc = preset("vit_t16", labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8,
                 posemb="sincos2d", dtype="float32", dropout=rate)
    dec = DecoderConfig(layers=1, dim=32, heads=2, dtype="float32", dropout=rate)
    return create_state((enc, dec, True), OPT, device="cpu", init_seed=seed, rng_seed=seed, global_batch_size=4)


def images():
    return torch.from_numpy(next(synthetic_batches(4, SIZE, seed=1))["images"])


def test_training_forward_leaves_the_default_generator_alone():
    """A training forward at dropout 0.1 draws nothing from torch's
    default generator, and two forwards from the same step generators are
    bit-identical (the masks replay from (seed, step, micro))."""
    state = dropout_state()
    model, x = state.model.train(), images()
    before = torch.random.get_rng_state()
    a = model(x, generators=state.step_generators())
    b = model(x, generators=state.step_generators())
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["loss_per_sample"], b["loss_per_sample"])
    # another micro-batch draws other masks; eval draws none and is deterministic
    c = model(x, generators=state.step_generators(micro=1))
    assert not torch.equal(a["loss_per_sample"], c["loss_per_sample"])


def test_dropout_changes_the_training_forward_only():
    """At rate 0.1 the training forward differs from the forward at rate
    0 on the same weights and mask noise; in eval mode the rate is inert."""
    noise = torch.from_numpy(np.random.default_rng(2).random(16).astype(np.float32))
    x = images()
    out = {}
    for rate in (0.0, 0.1):
        state = dropout_state(rate)
        gens = state.step_generators()
        out[("train", rate)] = state.model.train()(x, mask_noise=noise, generators=gens)["loss"]
        out[("eval", rate)] = state.model.eval()(x, mask_noise=noise)["loss"]
    assert not torch.equal(out[("train", 0.0)], out[("train", 0.1)])
    assert torch.equal(out[("train", 0.0)], out[("eval", 0.0)])
    assert torch.equal(out[("eval", 0.0)], out[("eval", 0.1)])


def test_train_steps_replay_from_the_seed():
    """Two runs from the same seed take bit-identical steps at dropout 0.1,
    and leave the default generator alone."""
    runs = [(dropout_state(seed=5), make_train_step()) for _ in range(2)]
    before = torch.random.get_rng_state()  # after the models' construction
    losses = []
    for state, step in runs:
        batches = synthetic_batches(4, SIZE, seed=3)
        run = []
        for _ in range(2):
            state, m = step(state, next(batches))
            run.append(m["loss"].item())
        losses.append(run)
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
    assert torch.equal(torch.random.get_rng_state(), before)


def test_dropout_module_contract():
    """Each entry kept with probability 1 − rate and scaled by 1/(1 − rate);
    inert in eval and at rate 0; a positive rate in training without a
    generator raises; DropPath draws once per sample."""
    x = torch.ones((64, 8, 16))
    drop = layers.Dropout(0.25).train()
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.equal(drop(x, torch.Generator().manual_seed(0)), y)
    with pytest.raises(ValueError, match="dropout in training needs an explicit generator"):
        drop(x)
    assert drop.eval()(x) is x
    assert layers.Dropout(0.0).train()(x) is x
    path = layers.DropPath(0.5).train()(x, torch.Generator().manual_seed(1))
    per_sample = path.reshape(64, -1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == 2).all(1))
    with pytest.raises(ValueError, match="droppath in training needs an explicit generator"):
        layers.DropPath(0.5).train()(x)


def test_dropout_sites_draw_from_their_own_streams():
    """The sites of a block draw other masks from one block seed, and the
    same seed replays them; training with a positive rate and no seed
    raises."""
    cfg = preset("vit_t16", dtype="float32", dropout=0.5)
    mlp = layers.Mlp(cfg.dim, cfg.hidden_dim, cfg.dropout, torch.float32).train()
    x = torch.randn((4, 5, cfg.dim), generator=torch.Generator().manual_seed(0))
    a, b = mlp(x, 7), mlp(x, 7)
    assert torch.equal(a, b) and not torch.equal(a, mlp(x, 8))
    with pytest.raises(ValueError, match="need a seed"):
        mlp(x)
    assert torch.equal(mlp.eval()(x), mlp(x, 7))
    gens = layers.site_generators(mlp.train(), 0.5, 7, torch.device("cpu"), 2)
    draws = [torch.rand(8, generator=g) for g in gens]
    assert not torch.equal(draws[0], draws[1])
