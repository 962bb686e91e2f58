"""The port's classifier (``models/classifier.py``) against the JAX
package's ``ClassificationModel``, on the CPU, in float32.

Both models get the same O(1)-scale weights (``interop/from_jax.py``) and
the same uint8 images and labels; the Mixup/CutMix draws are JAX's from
the same key, handed to the port through ``mixup_draws=``. Checked:

- eval-mode loss, top-1 and top-5 (rtol 1e-5; the accuracies exactly);
- training-mode loss and every gradient against ``jax.value_and_grad``
  (loss rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 of the largest
  entry: the same float32 math, sums ordered differently), for CE and
  BCE, with and without label smoothing, with and without mixup;
- linear probing (F1): the trunk gets no gradient (JAX's are exactly
  zero), the head's equal JAX's; the BatchNorm statistics after one
  training step equal flax's ``batch_stats`` to 1e-6 (F2: flax keeps the
  biased batch variance, ``nn.BatchNorm1d`` the unbiased one);
- the step refuses BatchNorm and Mixup on a data axis above 1 (A6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jumbo_mae_tpu_tpu.models.classifier as flax_classifier
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.models.classifier import ClassificationModel as FlaxClassifier
from jumbo_mae_tpu_tpu_torch.interop import classifier_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import preset
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel, one_hot
from jumbo_mae_tpu_tpu_torch.parallel.mesh import Mesh, set_mesh
from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step
from torch_port_util import flax_init_shapes, jax_mixup_draws, random_images, random_jumbo_params

SIZE, B, LABELS = 32, 8, 10
ENC = dict(image_size=SIZE, patch_size=8, posemb="sincos2d", dtype="float32", labels=LABELS)


def build_pair(seed=0, mixup=0.0, cutmix=0.0, smoothing=0.0, criterion="ce", **enc):
    kw = dict(ENC, **enc)
    fmodel = FlaxClassifier(flax_preset("vit_t16", **kw), mixup_alpha=mixup, cutmix_alpha=cutmix,
                            label_smoothing=smoothing, criterion=criterion)
    init = flax_init_shapes(fmodel, np.zeros((2, SIZE, SIZE, 3), np.uint8), np.zeros((2,), np.int32), True)
    rng = np.random.default_rng(seed)
    variables = {"params": random_jumbo_params(init["params"], rng)}
    if "batch_stats" in init:
        variables["batch_stats"] = init["batch_stats"]
    tmodel = ClassificationModel(preset("vit_t16", **kw), mixup, cutmix, smoothing, criterion, device="cpu", seed=1)
    tmodel.load_state_dict(classifier_state_dict_from_jax(variables["params"], variables.get("batch_stats")))
    images = random_images(rng, B, SIZE)
    labels = rng.integers(0, LABELS, B).astype(np.int32)
    return fmodel, variables, tmodel, images, labels


def test_eval_forward_matches_jax():
    fmodel, variables, tmodel, images, labels = build_pair()
    want = jax.jit(lambda v: fmodel.apply(v, images, labels, True))(variables)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(images), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-5)
    for k in ("acc1", "acc5"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["acc5"].sum() >= got["acc1"].sum()


CASES = {
    "ce": dict(),
    "ce_smooth": dict(smoothing=0.1),
    "ce_smooth_mix": dict(smoothing=0.1, mixup=0.8, cutmix=1.0),
    "ce_mixup_only": dict(mixup=0.8),
    "bce": dict(criterion="bce"),
    "bce_mix": dict(criterion="bce", mixup=0.8, cutmix=1.0, smoothing=0.1),
}


@pytest.fixture
def mixup_keys(monkeypatch):
    """The keys the flax model hands ``mixup_cutmix`` (its ``make_rng``
    derives them from the ``"mixup"`` stream), recorded as it runs."""
    keys = []
    real = flax_classifier.mixup_cutmix

    def recording(key, *args, **kw):
        keys.append(jax.random.key_data(key))  # a tracer under jit: returned out of the traced function
        return real(key, *args, **kw)

    monkeypatch.setattr(flax_classifier, "mixup_cutmix", recording)
    return keys


def _grads_close(got: dict, want: dict, names):
    for n in names:
        w = want[n].numpy()
        g = got[n]
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(w).max()), err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_loss_and_gradients_match_jax(case, mixup_keys):
    kw = CASES[case]
    fmodel, variables, tmodel, images, labels = build_pair(seed=1, **kw)
    key = jax.random.key(11)

    def loss_fn(params):
        out = fmodel.apply({"params": params}, jnp.asarray(images), labels, False, rngs={"mixup": key, "dropout": key})
        return out["loss"].mean(), out

    @jax.jit
    def grads_and_key(params):
        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, grads, (mixup_keys[-1] if mixup_keys else None)

    jout, jgrads, mkey = grads_and_key(variables["params"])
    draws = None
    if mkey is not None:
        draws = jax_mixup_draws(jax.random.wrap_key_data(mkey), B, kw.get("mixup", 0.0), kw.get("cutmix", 0.0))
    out = tmodel.train()(torch.from_numpy(images), torch.from_numpy(labels).long(), mixup_draws=draws)
    out["loss"].mean().backward()
    np.testing.assert_allclose(out["loss"].detach().numpy(), np.asarray(jout["loss"]), rtol=1e-5)
    for k in ("acc1", "acc5"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    want = classifier_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    _grads_close(got, want, want)


def test_one_hot_out_of_range_is_a_zero_row():
    got = one_hot(torch.tensor([0, 3, -1, 4]), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.nn.one_hot(jnp.array([0, 3, -1, 4]), 4)))


def linear_pair(seed=2, pooling="cls"):
    fmodel, variables, tmodel, images, labels = build_pair(seed, linear_probing=True, batch_norm=True, pooling=pooling)
    return fmodel, variables, tmodel, images, labels


@pytest.mark.parametrize("pooling", ["cls", "gap"])
def test_linear_probe_freezes_the_trunk(pooling):
    """F1: with ``linear_probing`` the trunk runs without autograd, so its
    parameters get no gradient, as JAX's ``stop_gradient`` hands them
    zeros; the head's gradients equal JAX's."""
    fmodel, variables, tmodel, images, labels = linear_pair(pooling=pooling)

    def loss_fn(params):
        out, _ = fmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(images), labels, False,
                              rngs={"mixup": jax.random.key(0), "dropout": jax.random.key(0)},
                              mutable=["batch_stats"])
        return out["loss"].mean()

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))
    want = classifier_state_dict_from_jax(jgrads, {"model": {"head": {"bn": {
        "mean": np.zeros(1), "var": np.zeros(1)}}}})
    tmodel.train()(torch.from_numpy(images), torch.from_numpy(labels).long())["loss"].mean().backward()
    params = dict(tmodel.named_parameters())
    trunk = [n for n in params if not n.startswith("model.head.")]
    assert trunk and all(params[n].grad is None for n in trunk)
    assert all(not want[n].any() for n in trunk)  # JAX: exact zeros
    _grads_close({n: params[n].grad for n in params}, want, [n for n in params if n.startswith("model.head.")])


def test_linear_probe_batch_stats_match_flax():
    """F2: one training forward moves the BatchNorm statistics as flax's
    (momentum 0.99, the biased batch variance); the normalized features
    use the batch's biased variance too, so the loss agrees."""
    fmodel, variables, tmodel, images, labels = linear_pair()
    out, updated = jax.jit(lambda v: fmodel.apply(v, jnp.asarray(images), labels, False,
                                                  rngs={"mixup": jax.random.key(0), "dropout": jax.random.key(0)},
                                                  mutable=["batch_stats"]))(variables)
    got = tmodel.train()(torch.from_numpy(images), torch.from_numpy(labels).long())
    bn = tmodel.model.head.bn
    stats = jax.tree_util.tree_map(np.asarray, updated["batch_stats"])["model"]["head"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-6, rtol=0)
    assert not np.allclose(stats["var"], 1.0)  # the step moved them
    np.testing.assert_allclose(got["loss"].detach().numpy(), np.asarray(out["loss"]), rtol=1e-5)
    # eval normalizes with the running statistics
    vars2 = {"params": variables["params"], "batch_stats": updated["batch_stats"]}
    want_eval = jax.jit(lambda v: fmodel.apply(v, images, labels, True))(vars2)
    with torch.no_grad():
        got_eval = tmodel.eval()(torch.from_numpy(images), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got_eval["loss"].numpy(), np.asarray(want_eval["loss"]), rtol=1e-5)


@pytest.mark.parametrize("what,kw", [
    ("BatchNorm", dict(linear_probing=True, batch_norm=True)),
    ("Mixup", dict(mixup=0.8, cutmix=1.0)),
])
def test_data_axis_above_one_refuses_global_batch_ops(what, kw):
    mixup, cutmix = kw.pop("mixup", 0.0), kw.pop("cutmix", 0.0)
    model = ClassificationModel(preset("vit_t16", **ENC, **kw), mixup, cutmix, device="cpu")
    state = create_state(model, OptimConfig(name="sgd"), device="cpu", global_batch_size=B)
    batch = {"images": np.zeros((B, SIZE, SIZE, 3), np.uint8), "labels": np.zeros((B,), np.int32)}
    step = make_train_step(mode="classify")
    with set_mesh(Mesh({"data": 2, "fsdp": 1, "tensor": 1, "seq": 1})):
        with pytest.raises(NotImplementedError, match=f"A6.*") as err:
            step(state, batch)
    assert what in str(err.value)
    step(state, batch)  # one process holds the global batch: runs
