"""The port's optimizer and train step against the JAX package's, on the CPU.

- AdamW and its schedule against ``make_optimizer`` (optax) on the same
  parameters and gradients over 6 steps: f32 moments, bf16 ``mu_dtype``,
  bf16 ``nu_dtype``; the learning rate at every count, across the warmup
  boundary; the weight-decay set against the JAX ``kernel_mask``.
- A 3-step trajectory: the flax MAE model with optax against the port's
  model with its AdamW, the same weights and the same mask noise each step.
- ``make_train_step`` on its own: gradient accumulation, the NaN guard,
  the inject seam, the eval step's ``valid`` weighting, DropPath under
  gradient checkpointing.

Tolerances: the parameters after the optimizer steps at atol 1e-7 + rtol
1e-5 with float32 moments (the same float32 update; optax and PyTorch
round ``b1**count`` and fuse multiply-adds differently), and at atol
1e-2 of the peak learning rate with bf16 moments (a one-ulp float32
difference can round a stored bf16 moment the other way, 2^-8 of it,
which moves that step's update by up to 2^-8 of a step; over 8 steps);
the trajectory's loss at rtol 1e-5 and parameters at atol 1e-2 of the
learning rate (Adam divides each gradient entry by its own RMS, so an
entry whose float32 gradient is a near-cancelled sum, and differs
between XLA and PyTorch by up to a percent, moves its weight by up to a
percent of a step). The attention key biases are left out of that
comparison: their true gradient is exactly zero (a key bias adds the
same amount to every score of a query), so both frameworks step them
by Adam-normalized round-off, and they are held only to Adam's bound
of one learning rate per step. The port-only comparisons at float32 round-off or
bit-exact, as each test says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jumbo_mae_tpu_tpu.models import DecoderConfig as FlaxDecoderConfig
from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FlaxMAE
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.train.optim import OptimConfig as FlaxOptimConfig
from jumbo_mae_tpu_tpu.train.optim import kernel_mask as flax_kernel_mask
from jumbo_mae_tpu_tpu.train.optim import make_optimizer as flax_make_optimizer
from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.interop import mae_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.state import EVAL_DOMAIN, TrainState
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_eval_step, make_train_step
from torch_port_util import random_images, random_jumbo_params

SIZE = 32
ENC = dict(labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32")
DEC = dict(layers=1, dim=32, heads=2, dtype="float32")
N = 16  # patches


def flax_pair(seed, norm_pix=True, **enc):
    ekw = dict(ENC, **enc)
    fmodel = FlaxMAE(flax_preset("vit_t16", **ekw), FlaxDecoderConfig(**DEC), norm_pix_loss=norm_pix)
    init = fmodel.init(jax.random.key(0), np.zeros((1, SIZE, SIZE, 3), np.uint8), True,
                       mask_noise=np.zeros((N,), np.float32))
    params = random_jumbo_params(jax.tree_util.tree_map(np.asarray, init["params"]), np.random.default_rng(seed))
    tmodel = MAEPretrainModel(preset("vit_t16", **ekw), DecoderConfig(**DEC), norm_pix, device="cpu", seed=1)
    tmodel.load_state_dict(mae_state_dict_from_jax(params))
    return fmodel, params, tmodel


def random_grads(params, rng):
    return jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32) * 0.1, params)


OPT_CASES = {
    "f32": dict(),
    "mu_bf16": dict(mu_dtype="bfloat16"),
    "nu_bf16": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_and_schedule_match_optax(case):
    kw = dict(learning_rate=1e-3, warmup_steps=2, training_steps=6, init_lr=1e-4, end_lr=2e-4, **OPT_CASES[case])
    _, params, tmodel = flax_pair(0)
    tx = flax_make_optimizer(FlaxOptimConfig(**kw), global_batch_size=512)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)  # as the JAX train step runs it
    port = topt.make_optimizer(topt.OptimConfig(**kw), global_batch_size=512)
    state = port.init(tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    tparams = list(tmodel.parameters())
    rng = np.random.default_rng(1)
    assert state.learning_rate == pytest.approx(float(opt_state.hyperparams["learning_rate"]), rel=1e-7)
    for step in range(8):  # past training_steps: the schedule holds end_lr
        grads = random_grads(params, rng)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = mae_state_dict_from_jax(grads)
        port.update(state, tparams, [tgrads[n] for n in names])
        assert state.count == step + 1
        np.testing.assert_allclose(state.learning_rate, float(opt_state.hyperparams["learning_rate"]), rtol=1e-6)
        ref = mae_state_dict_from_jax(params)
        atol = 1e-2 * 2e-3 if "mu_dtype" in OPT_CASES[case] else 1e-7  # peak lr 1e-3·512/256
        for n, p in zip(names, tparams):
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=atol, rtol=1e-5, err_msg=n)
    want_mu = torch.bfloat16 if "mu_dtype" in OPT_CASES[case] else torch.float32
    want_nu = torch.bfloat16 if "nu_dtype" in OPT_CASES[case] else torch.float32
    assert {m.dtype for m in state.mu} == {want_mu} and {n.dtype for n in state.nu} == {want_nu}


def test_schedule_values_at_warmup_boundaries():
    cfg = dict(learning_rate=1e-3, warmup_steps=3, training_steps=10, init_lr=1e-5, end_lr=1e-4)
    sched = topt.make_schedule(topt.OptimConfig(**cfg), 256)
    import jumbo_mae_tpu_tpu.train.optim as jopt

    jsched = jopt.make_schedule(FlaxOptimConfig(**cfg), 256)
    for count in range(0, 13):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6)
    assert sched(0) == pytest.approx(1e-5, rel=1e-5) and sched(3) == pytest.approx(1e-3, rel=1e-6)
    assert sched(10) == pytest.approx(1e-4, rel=1e-6) and sched(12) == sched(10)
    with pytest.raises(ValueError, match="training_steps"):
        topt.make_schedule(topt.OptimConfig(warmup_steps=5, training_steps=5), 256)


def test_weight_decay_set_equals_jax_kernel_mask():
    """The port decays exactly the parameters flax names ``kernel``: the
    JAX package's own mask, carried through the interop names."""
    _, params, tmodel = flax_pair(2, layerscale=True)
    mask_tree = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), flax_kernel_mask(params), params
    )
    mapped = mae_state_dict_from_jax(mask_tree)
    want = {n for n, t in mapped.items() if bool(t.all())}
    assert all(bool(t.all()) or not bool(t.any()) for t in mapped.values())
    got = {n for n, d in topt.kernel_mask(tmodel).items() if d}
    assert got == want
    for n in ("mask_token", "encoder.cls_tokens", "encoder.blocks.0.ls1", "encoder.ln.weight", "decoder_proj.bias"):
        assert n not in got
    for n in ("encoder.embed.proj.weight", "encoder.jumbo_mlp.fc1.weight", "pixel_proj.weight"):
        assert n in got


def test_optimizer_and_step_options_not_ported_raise():
    for kw in (dict(name="lamb"), dict(name="lars"), dict(name="sgd"), dict(layer_decay=0.75),
               dict(clip_grad=1.0), dict(param_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="A4"):
            topt.make_optimizer(topt.OptimConfig(**kw), 256)
    with pytest.raises(NotImplementedError, match="A4"):
        make_train_step(mode="classify")
    with pytest.raises(NotImplementedError, match="A7"):
        make_train_step(diag=True)
    with pytest.raises(NotImplementedError, match="A6"):
        make_train_step(pipe_microbatches=2)
    with pytest.raises(NotImplementedError, match="A3"):
        MAEPretrainModel(preset("vit_t16", **dict(ENC, grad_ckpt=True, remat_policy="dots")),
                         DecoderConfig(**DEC), device="cpu")


def test_three_step_trajectory_matches_flax_and_optax():
    kw = dict(learning_rate=1e-3, warmup_steps=1, training_steps=10, weight_decay=0.05, mu_dtype="bfloat16")
    fmodel, params, tmodel = flax_pair(3)
    tx = flax_make_optimizer(FlaxOptimConfig(**kw), global_batch_size=256)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, images, noise):
        def loss_fn(p):
            return fmodel.apply({"params": p}, images, True, mask_noise=noise)["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    port = topt.make_optimizer(topt.OptimConfig(**kw), global_batch_size=256)
    state = port.init(tmodel)
    tparams = list(tmodel.parameters())
    rng = np.random.default_rng(4)
    tmodel.train()
    for _ in range(3):
        images = random_images(rng, 4, SIZE)
        noise = rng.random((N,)).astype(np.float32)
        params, opt_state, loss = jax_step(params, opt_state, jnp.asarray(images), jnp.asarray(noise))
        tmodel.zero_grad(set_to_none=True)
        out = tmodel(torch.from_numpy(images), mask_noise=torch.from_numpy(noise))
        out["loss"].backward()
        port.update(state, tparams, [p.grad for p in tparams])
        np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5)
    ref = mae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for n, p in tmodel.named_parameters():
        # k biases have a zero true gradient: Adam steps them by round-off
        atol = 2 * 3 * 1e-3 if n.endswith("attn.k.bias") else 1e-2 * 1e-3
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=atol, rtol=0, err_msg=n)


# ------------------------------------------------------------ the train step

OPT = topt.OptimConfig(learning_rate=1e-3, lr_scaling="none", warmup_steps=2, training_steps=20)


def tiny_state(seed=0, **enc):
    return create_state(
        (preset("vit_t16", **dict(ENC, **enc)), DecoderConfig(**DEC), True),
        OPT, device="cpu", init_seed=seed, rng_seed=seed, global_batch_size=8,
    )


def pin_generators(state: TrainState, seed: int = 11):
    """Every micro-batch draws the same shared-mode permutation."""
    state.step_generators = lambda micro=0, domain=0: {
        "noise": torch.Generator().manual_seed(seed), "dropout": torch.Generator().manual_seed(seed + 1)
    }


def snapshot(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_grad_accum_equals_one_double_batch():
    batch = next(synthetic_batches(8, SIZE, seed=1))
    split = next(synthetic_batches(8, SIZE, seed=1, grad_accum=2))
    full, acc = tiny_state(), tiny_state()
    pin_generators(full), pin_generators(acc)
    full, m_full = make_train_step()(full, batch)
    acc, m_acc = make_train_step(grad_accum=2)(acc, split)
    # one mean over 8 samples vs the mean of two means over 4: float32 order
    np.testing.assert_allclose(m_acc["loss"].item(), m_full["loss"].item(), rtol=1e-6)
    for a, f in zip(snapshot(acc), snapshot(full)):
        torch.testing.assert_close(a, f, atol=1e-6, rtol=1e-5)
    assert acc.step == full.step == 1 and acc.opt_state.count == 1


def test_guard_skips_an_injected_nan_and_keeps_the_lr_index():
    state = tiny_state()
    step = make_train_step(guard_nonfinite=True)
    it = synthetic_batches(4, SIZE, seed=2)
    state, m0 = step(state, next(it))
    assert m0["skipped"] == 0.0 and np.isfinite(m0["grad_norm"].item())
    before, count, lr = snapshot(state), state.opt_state.count, state.opt_state.learning_rate
    mu_before = [m.clone() for m in state.opt_state.mu]
    for inject in ([np.nan, 1.0], [1.0, np.inf]):
        state, m = step(state, next(it), inject=inject)
        assert m["skipped"] == 1.0
        assert all(torch.equal(a, b) for a, b in zip(snapshot(state), before))
        assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, mu_before))
        assert state.opt_state.count == count and m["learning_rate"] == lr
    assert state.step == 3
    # the next good step uses the optimizer's count, one behind ``step``
    state, m = step(state, next(it))
    assert m["skipped"] == 0.0 and state.opt_state.count == count + 1
    assert m["learning_rate"] == pytest.approx(state.tx.schedule(count))
    assert m["learning_rate"] != pytest.approx(state.tx.schedule(state.step - 1))


def test_inject_ones_changes_no_bit():
    batch = next(synthetic_batches(4, SIZE, seed=3))
    a, b = tiny_state(), tiny_state()
    a, ma = make_train_step()(a, batch)
    b, mb = make_train_step()(b, batch, inject=np.ones(2, np.float32))
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(snapshot(a), snapshot(b)))
    assert set(ma) == {"loss", "learning_rate"}


def test_loss_falls_on_a_repeated_batch():
    state = create_state(
        (preset("vit_t16", **ENC), DecoderConfig(**DEC), True),
        topt.OptimConfig(learning_rate=1e-2, lr_scaling="none", warmup_steps=0, training_steps=50),
        device="cpu", global_batch_size=4,
    )
    batch = next(synthetic_batches(4, SIZE, seed=4, distinct=1))
    pin_generators(state)
    step = make_train_step()
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_eval_step_weights_by_valid():
    state = tiny_state()
    batch = dict(next(synthetic_batches(4, SIZE, seed=5)))
    batch["valid"] = np.array([True, False, True, False])
    out = make_eval_step()(state, batch, batch_idx=2)
    assert out["num_samples"].item() == 2
    with torch.no_grad():
        ref = state.model(torch.from_numpy(batch["images"]),
                          generators=state.step_generators(micro=2, domain=EVAL_DOMAIN))
    per = ref["loss_per_sample"]
    torch.testing.assert_close(out["loss"], per[0] + per[2], rtol=1e-6, atol=0)
    assert not state.model.training


def test_step_streams_are_reproducible_and_domain_separated():
    state = tiny_state()
    draw = lambda g: torch.rand(4, generator=g["noise"])  # noqa: E731
    a = draw(state.step_generators(micro=0))
    assert torch.equal(a, draw(state.step_generators(micro=0)))
    assert not torch.equal(a, draw(state.step_generators(micro=1)))
    assert not torch.equal(a, draw(state.step_generators(micro=0, domain=EVAL_DOMAIN)))
    state.step += 1
    assert not torch.equal(a, draw(state.step_generators(micro=0)))


def test_droppath_under_checkpointing_draws_the_same_masks():
    """DropPath draws from per-block seeds, so the checkpoint recompute
    sees the same masks: checkpointed and plain steps give equal weights."""
    batch = next(synthetic_batches(4, SIZE, seed=6))
    out = []
    for ckpt in (False, True):
        state = tiny_state(droppath=0.5, grad_ckpt=ckpt)
        state, m = make_train_step()(state, batch)
        out.append((m["loss"], snapshot(state)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_create_state_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_state((preset("vit_t16", **ENC), DecoderConfig(**DEC)), OPT, global_batch_size=8)
    with pytest.raises(ValueError, match="global_batch_size"):
        create_state((preset("vit_t16", **ENC), DecoderConfig(**DEC)), OPT, device="cpu")
