"""The port's per-layer-group diagnostics (``obs/modelstats.py`` and the
train step's ``diag=True``) against the JAX package's, on the CPU.

- ``group_layout`` of the port's models (``named_parameters`` names)
  equals JAX's of the flax trees for the MAE model, the plain-ViT
  encoder, the classifier and the linear probe, at a few layers; no
  parameter falls into ``other``;
- ``group_stats`` on the same numpy (old, grads, new) equals JAX's to
  rtol 1e-6; ``stats_dict``, ``publish_group_stats`` (family names and
  help) and ``first_nonfinite_group`` equal JAX's;
- the step with ``diag=True`` and the guard on against
  ``jumbo_mae_tpu_tpu/train/steps.py``'s over 3 steps from the same
  weights, masks pinned through ``mask_noise``: the grad and param norms
  to rtol 1e-5 (two frameworks' float32 gradients), the update ratio to
  rtol 1e-3 (the norm of a difference of nearby float32 parameters;
  Adam's first steps move an entry whose gradient is round-off by up to
  a learning rate in either framework), ``finite_frac`` equal; an
  injected NaN gives ``first_nonfinite_group == names[0]``, update ratio
  0 and ``skipped == 1`` in both;
- ``diag=True`` leaves the loss and the parameters bit-equal to
  ``diag=False`` over 3 steps, with the call's ``diag=False`` too;
- a linear-probe step's trunk groups have grad norm 0, as JAX's
  ``stop_gradient`` gives.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.models import DecoderConfig as FlaxDecoderConfig
from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FlaxMAE
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.models.classifier import ClassificationModel as FlaxClassifier
from jumbo_mae_tpu_tpu.models.vit import JumboViT as FlaxViT
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu.obs import modelstats as jstats
from jumbo_mae_tpu_tpu.parallel import MeshConfig, create_mesh
from jumbo_mae_tpu_tpu.train import OptimConfig as FlaxOptimConfig
from jumbo_mae_tpu_tpu.train import create_sharded_state
from jumbo_mae_tpu_tpu.train import make_optimizer as flax_make_optimizer
from jumbo_mae_tpu_tpu.train import make_train_step as flax_make_train_step
from jumbo_mae_tpu_tpu_torch.interop import classifier_state_dict_from_jax, mae_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT
from jumbo_mae_tpu_tpu_torch.obs import metrics as tmetrics
from jumbo_mae_tpu_tpu_torch.obs import modelstats as tstats
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step
from torch_port_util import flax_init_shapes, random_images, random_jumbo_params

SIZE, N, LABELS = 32, 16, 10
ENC = dict(image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32")
MAE_ENC = dict(ENC, labels=None, mask_ratio=0.75)
DEC = dict(layers=1, dim=32, heads=2, dtype="float32")
OPT = dict(name="adamw", learning_rate=1e-3, lr_scaling="none", warmup_steps=1, training_steps=20)


def flax_mae(seed=0, **enc):
    fmodel = FlaxMAE(flax_preset("vit_t16", **dict(MAE_ENC, **enc)), FlaxDecoderConfig(**DEC))
    init = flax_init_shapes(fmodel, np.zeros((1, SIZE, SIZE, 3), np.uint8), True,
                            mask_noise=np.zeros((N,), np.float32))
    return fmodel, random_jumbo_params(init["params"], np.random.default_rng(seed))


def port_mae(params, **enc):
    model = MAEPretrainModel(preset("vit_t16", **dict(MAE_ENC, **enc)), DecoderConfig(**DEC), device="cpu", seed=1)
    model.load_state_dict(mae_state_dict_from_jax(params))
    return model


def flax_classifier(linear: bool):
    kw = dict(ENC, labels=LABELS, linear_probing=linear, batch_norm=linear)
    fmodel = FlaxClassifier(flax_preset("vit_t16", **kw))
    init = flax_init_shapes(fmodel, np.zeros((2, SIZE, SIZE, 3), np.uint8), np.zeros((2,), np.int32), True)
    return fmodel, init, ClassificationModel(preset("vit_t16", **kw), device="cpu", seed=1)


# ------------------------------------------------------------ the grouping


@pytest.mark.parametrize("which", ["mae", "vit", "classifier", "linear_probe"])
def test_group_layout_equals_jax(which):
    if which == "mae":
        _, params = flax_mae(layers=3)
        model = port_mae(params, layers=3)
    elif which == "vit":
        cfg = dict(ENC, labels=None, layers=3)
        params = flax_init_shapes(FlaxViT(flax_preset("vit_t16", **cfg)), np.zeros((1, SIZE, SIZE, 3), np.float32))
        params = params["params"]
        model = JumboViT(preset("vit_t16", **cfg), device="cpu")
    else:
        _, init, model = flax_classifier(linear=which == "linear_probe")
        params = init["params"]
    want = jstats.group_layout(params)
    got = tstats.group_layout(model)
    assert got == want and "other" not in got
    assert got == tstats.group_layout(dict(model.named_parameters()))
    if which == "mae":
        assert got == ("patch_embed", "cls", "blocks.0", "blocks.1", "blocks.2", "jumbo_mlp", "norm", "decoder")
    if which in ("classifier", "linear_probe"):
        assert got[-1] == "head"
    # every port name maps where its flax path does
    for name, _ in model.named_parameters():
        assert tstats.group_of(name) != "other", name


def test_group_of_both_spellings():
    pairs = [("encoder.embed.proj.weight", ["encoder", "embed", "kernel"]),
             ("encoder.blocks.3.attn.q.weight", ["encoder", "block_3", "attn", "q", "kernel"]),
             ("encoder.cls_tokens", ["encoder", "cls_tokens"]),
             ("encoder.jumbo_mlp.fc1.weight", ["encoder", "jumbo_mlp", "fc1"]),
             ("encoder.ln.weight", ["encoder", "ln", "scale"]),
             ("decoder.blocks.0.mlp.fc1.bias", ["decoder", "block_0", "mlp"]),
             ("decoder_proj.weight", ["decoder_proj", "kernel"]), ("mask_token", ["mask_token"]),
             ("pixel_proj.bias", ["pixel_proj", "bias"]), ("model.head.fc.weight", ["model", "head", "kernel"]),
             ("model.blocks.0.ln1.weight", ["model", "block_0", "ln1"]), ("something_else", ["something_else"])]
    for name, path in pairs:
        assert tstats.group_of(name) == tstats.group_of(path) == jstats.group_of(path), name


def test_group_stats_equals_jax():
    _, old = flax_mae(3, layers=2)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda p: (0.1 * rng.standard_normal(np.shape(p))).astype(np.float32), old)
    new = jax.tree_util.tree_map(lambda p, g: (p - 0.01 * g).astype(np.float32), old, grads)
    want = np.asarray(jax.jit(jstats.group_stats)(old, grads, new))
    model = port_mae(old, layers=2)
    names = [n for n, _ in model.named_parameters()]
    sd = {k: mae_state_dict_from_jax(t) for k, t in (("old", old), ("grads", grads), ("new", new))}
    pick = {k: {n: v[n] for n in names} for k, v in sd.items()}
    got = tstats.group_stats(pick["old"], pick["grads"], pick["new"]).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (len(tstats.group_layout(model)), 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # lists with their names, and a missing gradient counts as zero
    lists = tstats.group_stats(list(pick["old"].values()), [None] * len(names), list(pick["new"].values()),
                               names=names).numpy()
    np.testing.assert_array_equal(lists[:, 0], 0.0)
    np.testing.assert_allclose(lists[:, 1:], want[:, 1:], rtol=1e-6)
    # a NaN stays in its own group
    bad = dict(pick["grads"])
    bad["encoder.blocks.1.mlp.fc1.weight"] = torch.full_like(bad["encoder.blocks.1.mlp.fc1.weight"], math.nan)
    arr = tstats.group_stats(pick["old"], bad, pick["new"]).numpy()
    layout = tstats.group_layout(model)
    assert tstats.first_nonfinite_group(layout, arr) == "blocks.1"
    assert np.isfinite(np.delete(arr[:, 0], layout.index("blocks.1"))).all()


def test_stats_dict_publish_and_first_nonfinite_equal_jax():
    names = ("patch_embed", "blocks.0", "decoder")
    arr = np.array([[1.0, 2.0, 0.5], [np.nan, 1.0, 0.1], [np.inf, 3.0, 0.0]], np.float32)
    assert tstats.stats_dict(names, arr) == jstats.stats_dict(names, arr)
    assert tstats.stats_dict(names, arr)["blocks.0"]["grad_norm"] == "nan"
    for a in (arr, np.ones((3, 3)), arr[::-1]):
        assert tstats.first_nonfinite_group(names, a) == jstats.first_nonfinite_group(names, a)
    assert tstats.STAT_NAMES == jstats.STAT_NAMES
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    tstats.publish_group_stats(names, arr, registry=regs[0])
    jstats.publish_group_stats(names, arr, registry=regs[1])
    snaps = [r.snapshot() for r in regs]
    assert snaps[0].keys() == snaps[1].keys() == {f"model_{s}" for s in tstats.STAT_NAMES}
    for fam in snaps[1]:
        assert snaps[0][fam].keys() == snaps[1][fam].keys()
        for key, v in snaps[1][fam].items():
            assert (math.isnan(v) and math.isnan(snaps[0][fam][key])) or snaps[0][fam][key] == v
    texts = [r.render() for r in regs]
    helps = [sorted(ln for ln in t.splitlines() if ln.startswith("# HELP")) for t in texts]
    assert helps[0] == helps[1] and len(helps[0]) == 3


# ------------------------------------------------------------ the diag step


def test_diag_step_matches_the_jax_step():
    fmodel, params = flax_mae(7)
    mesh = create_mesh(MeshConfig(data=1, fsdp=-1))
    tx = flax_make_optimizer(FlaxOptimConfig(**OPT), global_batch_size=256)
    rng = np.random.default_rng(8)
    images = random_images(rng, 8, SIZE)
    jbatch = {"images": jnp.asarray(images)}
    jstate, sharding = create_sharded_state(fmodel, tx, jbatch, mesh, mode="pretrain", init_seed=0, rng_seed=0)
    noise = rng.random((N,)).astype(np.float32)
    pinned = functools.partial(fmodel.apply, mask_noise=jnp.asarray(noise))  # a static field of both trees
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
                            apply_fn=pinned)
    sharding = sharding.replace(apply_fn=pinned)
    jstep = flax_make_train_step(mesh, sharding, mode="pretrain", guard_nonfinite=True, diag=True)

    model = port_mae(params)
    model.forward = functools.partial(model.forward, mask_noise=torch.from_numpy(noise))
    state = create_state(model, topt.make_optimizer(topt.OptimConfig(**OPT), 256), device="cpu")
    step = make_train_step(guard_nonfinite=True, diag=True)
    names = jstats.group_layout(params)
    assert tstats.group_layout(model) == names
    tbatch = {"images": images}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        want, got = np.asarray(jm["diag"]), m["diag"].numpy()
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-5, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=0, err_msg=f"step {i + 1}")
        assert float(m["finite_frac"]) == float(jm["finite_frac"]) == 1.0
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert (want[:, 2] > 0).all()  # every group moved
    nan = (math.nan, math.nan)
    _, jm = jstep(jstate, jbatch, np.asarray(nan, np.float32))
    _, m = step(state, tbatch, nan)
    for arr, skipped in ((np.asarray(jm["diag"]), jm["skipped"]), (m["diag"].numpy(), m["skipped"])):
        assert tstats.first_nonfinite_group(names, arr) == names[0] and float(skipped) == 1.0
        np.testing.assert_array_equal(arr[:, 2], 0.0)
        assert np.isnan(arr[:, 0]).all()


def test_diag_leaves_the_step_bit_equal():
    _, params = flax_mae(2)
    rng = np.random.default_rng(3)
    batches = [{"images": random_images(rng, 8, SIZE)} for _ in range(3)]
    runs = []
    for diag, call in ((False, {}), (True, {}), (True, {"diag": False})):
        state = create_state(port_mae(params), topt.make_optimizer(topt.OptimConfig(**OPT), 256), device="cpu")
        step = make_train_step(guard_nonfinite=True, diag=diag)
        losses = []
        for b in batches:
            state, m = step(state, b, **call)
            losses.append(m["loss"].item())
            assert ("diag" in m) == (diag and not call) and ("finite_frac" in m) == diag
        runs.append((losses, [p.detach().clone() for p in state.model.parameters()]))
    for losses, ps in runs[1:]:
        assert losses == runs[0][0]
        for a, b in zip(ps, runs[0][1], strict=True):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_linear_probe_trunk_groups_have_zero_grad_norm():
    fmodel, init, model = flax_classifier(linear=True)
    rng = np.random.default_rng(4)
    variables = {"params": random_jumbo_params(init["params"], rng), "batch_stats": init["batch_stats"]}
    model.load_state_dict(classifier_state_dict_from_jax(variables["params"], variables["batch_stats"]))
    images, labels = random_images(rng, 8, SIZE), rng.integers(0, LABELS, 8).astype(np.int32)

    def loss_fn(p):
        out, _ = fmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(images), labels,
                              False, rngs={"mixup": jax.random.key(0), "dropout": jax.random.key(0)},
                              mutable=["batch_stats"])
        return out["loss"].mean()

    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
    want = np.asarray(jax.jit(jstats.group_stats)(variables["params"], jgrads, variables["params"]))
    names = jstats.group_layout(variables["params"])
    state = create_state(model, topt.make_optimizer(topt.OptimConfig(**OPT), 256), device="cpu")
    state, m = make_train_step(mode="classify", guard_nonfinite=True, diag=True)(
        state, {"images": images, "labels": labels})
    got = m["diag"].numpy()
    assert tstats.group_layout(model) == names and names[-1] == "head"
    trunk = [i for i, g in enumerate(names) if g != "head"]
    np.testing.assert_array_equal(want[trunk, 0], 0.0)
    np.testing.assert_array_equal(got[trunk, 0], 0.0)
    np.testing.assert_allclose(got[-1, :2], want[-1, :2], rtol=1e-5)
    assert got[-1, 0] > 0 and float(m["finite_frac"]) == 1.0
