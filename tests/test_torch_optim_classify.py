"""The port's finetuning and probing optimizers against the JAX
package's ``make_optimizer`` (optax), on the CPU.

A classifier's parameters (the JAX ``ClassificationModel`` tree and the
port's ``ClassificationModel`` through ``interop/from_jax.py``) take 3
updates from the same random gradients: LAMB (the trust ratio on kernels
only), LARS, SGD with momentum, AdamW with layer-wise lr decay, clipping
by the global norm (on and off), and low-precision parameters with
float32 master weights. The parameters (and master weights) agree at
rtol 1e-6, atol 1e-7 (the same float32 operations; the norms under the
trust ratios and the clip sum in another order); bf16 parameters are
the exact casts of the port's masters and within one bf16 step of JAX's.

Also: every port parameter's layer index equals JAX's ``layer_index`` of
its flax path; ``flax_path`` inverts the weight bridge; a trunk whose
gradients are ``None`` (the port's linear probe) steps as JAX's zero
gradients do, and stays bit-unchanged under LARS and SGD; each
optimizer's state goes through a checkpoint and back.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.models.classifier import ClassificationModel as FlaxClassifier
from jumbo_mae_tpu_tpu.train import optim as jopt
from jumbo_mae_tpu_tpu_torch.interop import classifier_state_dict_from_jax, flax_path, mae_state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from jumbo_mae_tpu_tpu_torch.train.steps import create_state
from torch_port_util import flax_init_shapes, random_jumbo_params

SIZE, LABELS = 32, 10
ENC = dict(image_size=SIZE, patch_size=8, posemb="learnable", dtype="float32", labels=LABELS, layers=3)
BATCH = 256
TOL = dict(rtol=1e-6, atol=1e-7)


def classifier_pair(seed=0, **enc):
    kw = dict(ENC, **enc)
    fmodel = FlaxClassifier(flax_preset("vit_t16", **kw))
    size = kw["image_size"]
    init = flax_init_shapes(fmodel, np.zeros((2, size, size, 3), np.uint8), np.zeros((2,), np.int32), True)
    params = random_jumbo_params(init["params"], np.random.default_rng(seed))
    tmodel = ClassificationModel(preset("vit_t16", **kw), device="cpu", seed=1)
    tmodel.load_state_dict(classifier_state_dict_from_jax(params, init.get("batch_stats")))
    return params, tmodel, init.get("batch_stats")


CASES = {
    "lamb": dict(name="lamb", weight_decay=0.05),
    "lars": dict(name="lars", momentum=0.9),
    "sgd": dict(name="sgd", momentum=0.9),
    "adamw_layer_decay": dict(name="adamw", layer_decay=0.75),
    "lamb_layer_decay_clip": dict(name="lamb", layer_decay=0.65, clip_grad=1.0),
    "sgd_clip_off": dict(name="sgd", momentum=0.9, clip_grad=1e6),
    "lars_master_bf16": dict(name="lars", param_dtype="bfloat16"),
    "adamw_master_bf16_layer_decay": dict(name="adamw", param_dtype="bfloat16", layer_decay=0.75),
}


def _bf16_step_close(got: torch.Tensor, want: np.ndarray, name: str):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match_optax(case):
    kw = dict(learning_rate=3e-2, warmup_steps=1, training_steps=10, **CASES[case])
    params, tmodel, _ = classifier_pair()
    low = "param_dtype" in kw
    cfg = jopt.OptimConfig(**kw)
    tx = jopt.make_optimizer(cfg, BATCH, num_layers=ENC["layers"])
    jparams = jax.tree_util.tree_map(lambda p: p.astype(jax.numpy.bfloat16), params) if low else params
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    port = topt.make_optimizer(topt.OptimConfig(**kw), BATCH, num_layers=ENC["layers"])
    if low:
        # the masters copy the parameters as given: give JAX's bf16 values
        with torch.no_grad():
            for p in tmodel.parameters():
                p.copy_(p.to(torch.bfloat16))
    state = create_state(tmodel, port, device="cpu")
    names = [n for n, _ in tmodel.named_parameters()]
    tparams = list(tmodel.parameters())
    rng = np.random.default_rng(1)
    scale = 3.0 if "clip_grad" in kw else 0.1  # the clip at 1.0 triggers
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda p: (rng.standard_normal(np.shape(p)) * scale).astype(np.float32), params)
        if low:
            grads = jax.tree_util.tree_map(lambda g: g.astype(jax.numpy.bfloat16), grads)
        updates, opt_state = update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = classifier_state_dict_from_jax(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads))
        port.update(state.opt_state, tparams, [tg[n].to(p.dtype) for n, p in zip(names, tparams)])
        np.testing.assert_allclose(state.opt_state.learning_rate,
                                   float(opt_state.hyperparams["learning_rate"]), rtol=1e-7)
        if low:
            master = classifier_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, opt_state.inner_state.master))
            want = classifier_state_dict_from_jax(jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32), jparams))
            for n, p, m in zip(names, tparams, state.opt_state.master):
                np.testing.assert_allclose(m.numpy(), master[n].numpy(), **TOL, err_msg=n)
                assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(torch.bfloat16)), n
                _bf16_step_close(p.detach(), want[n].numpy(), n)
        else:
            want = classifier_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
            for n, p in zip(names, tparams):
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), **TOL, err_msg=n)
    assert state.opt_state.count == 3


def _label_tree(params, fn):
    return jax.tree_util.tree_map_with_path(lambda kp, p: np.full(np.shape(p), float(fn(kp)), np.float32), params)


def test_layer_index_of_every_parameter_equals_jax():
    params, tmodel, _ = classifier_pair()
    n = ENC["layers"]
    want = classifier_state_dict_from_jax(_label_tree(params, lambda kp: jopt.layer_index(kp, num_layers=n)))
    got = {name: topt.layer_index(flax_path(name), n) for name, _ in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, idx in got.items():
        assert np.all(want[name].numpy() == idx), name
    assert {got["model.embed.proj.weight"], got["model.blocks.0.attn.q.weight"], got["model.blocks.2.ln3.weight"]} == {0, 1, 3}
    for name in ("model.head.fc.weight", "model.ln.weight", "model.cls_tokens", "model.jumbo_mlp.fc1.weight"):
        assert got[name] == n
    scales = topt.layer_scales(tmodel, 0.5, n)
    assert scales[[nm for nm, _ in tmodel.named_parameters()].index("model.embed.proj.weight")] == 0.5 ** 3


def test_flax_path_inverts_the_bridge():
    """Every state_dict name the bridge writes maps back to the flax leaf
    it came from: classifier (with a BatchNorm head) and MAE trees."""
    params, _, stats = classifier_pair(linear_probing=True, batch_norm=True)
    tree = {"params": params, "batch_stats": stats}
    marked = jax.tree_util.tree_map_with_path(
        lambda kp, p: np.full(np.shape(p), hash(jax.tree_util.keystr(kp[1:])) % 997, np.float32), tree)
    sd = classifier_state_dict_from_jax(marked["params"], marked["batch_stats"])
    for name, t in sd.items():
        path = flax_path(name)
        coll = "batch_stats" if name.endswith(("running_mean", "running_var")) else "params"
        leaf = tree[coll]
        for k in path:
            leaf = leaf[k]
        assert np.shape(leaf) == tuple(t.shape) or np.size(leaf) == t.numel(), name
        want = hash(jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in path))) % 997
        assert float(t.flatten()[0]) == want, name
    from jumbo_mae_tpu_tpu.models import DecoderConfig as FDec
    from jumbo_mae_tpu_tpu.models import MAEPretrainModel as FMAE
    fm = FMAE(flax_preset("vit_t16", **dict(ENC, labels=None, mask_ratio=0.75)), FDec(layers=1, dim=32, heads=2))
    mparams = flax_init_shapes(fm, np.zeros((1, SIZE, SIZE, 3), np.uint8), True,
                               mask_noise=np.zeros((16,), np.float32))["params"]
    for name in mae_state_dict_from_jax(random_jumbo_params(mparams, np.random.default_rng(0))):
        leaf = mparams
        for k in flax_path(name):
            leaf = leaf[k]


@pytest.mark.parametrize("name", ["lars", "sgd", "adamw"])
def test_frozen_trunk_none_grads_step_as_jax_zeros(name):
    """A linear probe's trunk has ``None`` gradients in the port and zero
    ones in JAX: the updates agree; LARS and SGD leave it bit-unchanged
    (AdamW's weight decay moves it in both)."""
    kw = dict(name=name, learning_rate=0.1, warmup_steps=0, training_steps=10)
    params, tmodel, _ = classifier_pair(linear_probing=True, batch_norm=True)
    tx = jopt.make_optimizer(jopt.OptimConfig(**kw), BATCH, num_layers=ENC["layers"])
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    port = topt.make_optimizer(topt.OptimConfig(**kw), BATCH, num_layers=ENC["layers"])
    state = port.init(tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    tparams = list(tmodel.parameters())
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = _head_only_grads(params, rng)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = classifier_state_dict_from_jax(grads, _zero_stats())
        port.update(state, tparams, [tg[n] if n.startswith("model.head.") else None for n in names])
    want = classifier_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), _zero_stats())
    for n, p in zip(names, tparams):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), **TOL, err_msg=n)
        if name != "adamw" and not n.startswith("model.head."):
            assert torch.equal(p.detach(), before[n]), n
    assert not torch.equal(before["model.head.fc.weight"], tmodel.model.head.fc.weight.detach())


def _head_only_grads(params, rng):
    out = jax.tree_util.tree_map(np.zeros_like, params)
    out["model"]["head"] = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(np.shape(p)) * 0.1).astype(np.float32), params["model"]["head"])
    return out


def _zero_stats():
    return {"model": {"head": {"bn": {"mean": np.zeros(1, np.float32), "var": np.zeros(1, np.float32)}}}}


@pytest.mark.parametrize("kw", [dict(name="lars"), dict(name="sgd"), dict(name="lamb", mu_dtype="bfloat16"),
                                dict(name="adamw", param_dtype="bfloat16")], ids=lambda k: "_".join(k.values()))
def test_optimizer_state_goes_through_a_checkpoint(tmp_path, kw):
    """``host_state`` saves every slot of the optimizer's state (trace,
    moments, master weights) and ``restore`` puts each back."""
    kw = dict(kw, learning_rate=1e-2, warmup_steps=0, training_steps=10)

    def fresh():
        _, tmodel, _ = classifier_pair(linear_probing=True, batch_norm=True)
        return create_state(tmodel, topt.OptimConfig(**kw), device="cpu", global_batch_size=BATCH)

    state = fresh()
    params = list(state.model.parameters())
    rng = np.random.default_rng(0)
    for _ in range(2):
        state.tx.update(state.opt_state, params, [torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32)).to(p.dtype) for p in params])
    state.step = 2
    with torch.no_grad():
        state.model.model.head.bn.running_var.mul_(3.0)
    ck = Checkpointer(CheckpointConfig(str(tmp_path), async_save=False))
    ck.save(2, state)
    other = fresh()
    ck.restore(other)
    slots = state.opt_state.slots()
    assert slots.keys() == other.opt_state.slots().keys() and slots
    for k, ts in slots.items():
        assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(ts, other.opt_state.slots()[k])), k
    for (n, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert (other.opt_state.count, other.step) == (2, 2)
    wrong = create_state(classifier_pair(linear_probing=True, batch_norm=True)[1], topt.OptimConfig(name="lamb" if kw["name"] in ("lars", "sgd") else "sgd"),
                         device="cpu", global_batch_size=BATCH)
    with pytest.raises(ValueError, match="optimizer"):
        ck.restore(wrong)
