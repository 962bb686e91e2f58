"""Int8 weight-only quantization (infer/quant.py) against the JAX package's,
on the CPU; mirrors tests/test_quant.py.

- the round trip is bounded by half a step, and a zero channel is safe;
- the rule is structural and the same as JAX's: on the same tree, mapped
  through interop/from_jax.py, ``q`` and ``scale`` are bit-equal to JAX
  ``quantize_params``'s, and the report's counts and bytes agree;
- the int8 engine serves what the JAX int8 engine serves (float32, atol /
  rtol 1e-4), holds the parity gates against the float32 engine, keeps
  padding inert and holds int8 buffers in place of the weights.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.infer.quant import is_quantized as jax_is_quantized
from jumbo_mae_tpu_tpu.infer.quant import quantize_params as jax_quantize_params
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, QuantizedTensor, parity_report
from jumbo_mae_tpu_tpu_torch.infer.quant import (
    FEATURE_COSINE_MIN,
    TOP1_AGREEMENT_MIN,
    dequantize_tree,
    feature_cosine,
    is_quantized,
    quantize_module,
    quantize_params,
    quantize_tensor,
    top1_agreement,
)
from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_jax
from torch_port_util import port_tree, random_images, random_jumbo_params

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
SETS = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
TOL = dict(atol=1e-4, rtol=1e-4)


def images(n, seed=0):
    return random_images(np.random.default_rng(seed), n, 32)


@pytest.fixture(scope="module")
def trees():
    """Flax trees at O(1) scale: the logits model's and the MAE model's."""
    jeng = JaxEngine(jax_load_config(RECIPE, SETS), max_batch=4, labels=13, warm_cache=False)
    rng = np.random.default_rng(5)
    out = {}
    for task in ("logits", "reconstruct"):
        init = jax.tree_util.tree_map(np.asarray, jeng._task(task)["variables"]["params"])
        out[task] = random_jumbo_params(init, rng)
    out["features"] = {k: v for k, v in out["logits"].items() if k != "head"}
    return out


# ------------------------------------------------------------ tensor level


def test_quantize_tensor_round_trip_bound():
    w = torch.from_numpy(np.random.RandomState(0).randn(32, 64).astype(np.float32))
    qt = quantize_tensor(w, axes=(1,))
    assert qt.q.dtype == torch.int8 and qt.scale.shape == (32, 1)
    err = (qt.dequantize() - w).abs()
    assert (err <= qt.scale / 2 + 1e-7).all()


def test_quantize_tensor_zero_channel_safe():
    w = torch.from_numpy(np.random.RandomState(1).randn(4, 16).astype(np.float32))
    w[2] = 0.0
    qt = quantize_tensor(w, axes=(1,))
    assert float(qt.scale[2, 0]) == 1.0
    assert torch.equal(qt.dequantize()[2], torch.zeros(16))


@pytest.mark.parametrize(
    "name,shape,axes",
    [("fc", (64, 32), (0,)), ("q", (8, 4, 16), (0,)), ("out", (4, 16, 8), (0, 1)), ("proj", (4, 4, 3, 8), (0, 1, 2))],
)
def test_quantize_tensor_bit_equal_to_jax(name, shape, axes):
    """One weight in its flax layout: the port's quantize_tensor over the
    axes the JAX rule reduces gives JAX's q and scale bit for bit."""
    w = np.random.RandomState(2).randn(*shape).astype(np.float32) * 3
    ref = jax.tree_util.tree_leaves(jax_quantize_params({name: {"kernel": w}})[0], is_leaf=jax_is_quantized)[0]
    got = quantize_tensor(torch.from_numpy(w), axes=axes)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


# -------------------------------------------------------------- tree level


def _map_quantized(jax_tree: dict, field: str) -> dict[str, torch.Tensor]:
    """A JAX quantized tree's ``q`` (or its ``scale`` broadcast to the
    weight's shape) as float32 in the port's layout, through the same
    bridge that maps the weights."""
    def leaf(x):
        if not jax_is_quantized(x):
            return np.asarray(x)
        v = np.asarray(x.q, np.float32) if field == "q" else np.broadcast_to(np.asarray(x.scale), x.q.shape)
        return np.array(v, np.float32)

    return state_dict_from_jax(jax.tree_util.tree_map(leaf, jax_tree, is_leaf=jax_is_quantized))


@pytest.mark.parametrize("task", ["features", "logits", "reconstruct"])
def test_quantize_params_is_bit_equal_to_jax(trees, task):
    """The structural rule on the same tree: the same weights quantize,
    with the same q and scale (mapped through from_jax), and the same
    report."""
    tree = trees[task]
    jq, jreport = jax_quantize_params(tree)
    params = state_dict_from_jax(tree)
    qtree, report = quantize_params(params)
    want_q, want_scale = _map_quantized(jq, "q"), _map_quantized(jq, "scale")
    flags = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(jax_is_quantized(x)), np.float32),
        jq, is_leaf=jax_is_quantized))
    assert {n for n, v in qtree.items() if is_quantized(v)} == {n for n, f in flags.items() if bool(f.all())}
    for name, v in qtree.items():
        if is_quantized(v):
            assert v.q.dtype == torch.int8 and v.scale.shape == (v.q.shape[0],) + (1,) * (v.q.dim() - 1)
            assert torch.equal(v.q.float(), want_q[name]), name
            assert torch.equal(v.scale.expand_as(v.q), want_scale[name]), name
        else:
            assert v is params[name], name
    assert report["n_quantized"] > 0
    for key in ("n_quantized", "n_kept", "bytes_before", "bytes_after", "compression"):
        assert report[key] == jreport[key], key
    deq = dequantize_tree(qtree)
    assert set(deq) == set(params) and all(t.dtype == torch.float32 for t in deq.values())


def test_quantize_params_refuses_its_own_output(trees):
    qtree, _ = quantize_params(state_dict_from_jax(trees["features"]))
    with pytest.raises(ValueError, match="already quantized"):
        quantize_params(qtree)


def test_quantize_module_holds_int8(trees):
    """The module keeps int8 buffers and a float32 scale in place of each
    quantized weight, and ``weight`` is their product."""
    eng = InferenceEngine(load_config(RECIPE, SETS), labels=13, quant="int8", max_batch=4, device="cpu")
    eng.swap_weights(*port_tree(trees["logits"]))
    model = eng.model("logits")
    report = eng.quant_reports["logits"]
    names = {n for n, _ in model.named_parameters()}
    assert "blocks.0.attn.q.weight" not in names and "head.fc.weight" not in names
    assert "blocks.0.ln1.weight" in names and "cls_tokens" in names
    q_bufs = {n: b for n, b in model.named_buffers() if n.endswith("weight_q")}
    assert len(q_bufs) == report["n_quantized"] and all(b.dtype == torch.int8 for b in q_bufs.values())
    fc = model.head.fc
    assert torch.equal(fc.weight, fc.weight_q.float() * fc.weight_scale)
    assert report["int8_bytes"] == sum(b.numel() + b.shape[0] * 4 for b in q_bufs.values())
    assert isinstance(QuantizedTensor(fc.weight_q, fc.weight_scale).dequantize(), torch.Tensor)
    with pytest.raises(ValueError, match="already quantized"):
        quantize_params({"w": QuantizedTensor(fc.weight_q, fc.weight_scale)})
    assert quantize_module(torch.nn.Sequential())["n_quantized"] == 0


# ------------------------------------------------------------ engine level


@pytest.mark.parametrize("task", ["features", "logits"])
def test_int8_engine_matches_jax_int8_engine(trees, task):
    jeng = JaxEngine(jax_load_config(RECIPE, SETS), max_batch=4, labels=13, quant="int8", warm_cache=False)
    jeng.swap_weights(trees["logits"])
    eng = InferenceEngine(load_config(RECIPE, SETS), labels=13, quant="int8", max_batch=4, device="cpu")
    eng.swap_weights(*port_tree(trees["logits"]))
    x = images(6, seed=6)
    np.testing.assert_allclose(eng.predict(x, task=task), jeng.predict(x, task=task), **TOL)


def test_int8_reconstruct_matches_jax_int8_engine(trees, monkeypatch):
    from jumbo_mae_tpu_tpu_torch.infer import engine as engine_mod

    jeng = JaxEngine(jax_load_config(RECIPE, SETS), max_batch=4, quant="int8", warm_cache=False)
    jeng.swap_weights(trees["reconstruct"])
    x = images(3, seed=8)
    ref = jeng.reconstruct(x, seed=2)
    noise = torch.from_numpy(ref["mask"][0] + np.arange(64, dtype=np.float32) / 64 * 1e-3)
    monkeypatch.setattr(engine_mod, "reconstruct_noise", lambda seed, n: noise.clone())
    eng = InferenceEngine(load_config(RECIPE, SETS), quant="int8", max_batch=4, device="cpu")
    eng.swap_weights(*port_tree(trees["reconstruct"]))
    np.testing.assert_allclose(eng.reconstruct(x, seed=2)["reconstruction"], ref["reconstruction"], **TOL)


def test_engine_int8_parity_within_tolerance(trees):
    cfg = load_config(RECIPE, SETS)
    ref = InferenceEngine(cfg, labels=13, max_batch=4, device="cpu")
    q = InferenceEngine(cfg, labels=13, quant="int8", max_batch=4, device="cpu")
    for eng in (ref, q):
        eng.swap_weights(*port_tree(trees["logits"]))
    x = images(8, seed=6)
    feats = parity_report(ref, q, x, task="features", pool="cls")
    assert feats["within_tolerance"] and feats["cosine_min"] >= FEATURE_COSINE_MIN, feats
    logits = parity_report(ref, q, x, task="logits")
    assert logits["within_tolerance"] and logits["top1_agreement"] >= TOP1_AGREEMENT_MIN, logits
    assert set(logits) == {"task", "images", "top1_agreement", "max_abs_logit_delta", "tolerance", "within_tolerance"}
    with pytest.raises(ValueError, match="parity"):
        parity_report(ref, q, x, task="reconstruct")


def test_engine_int8_padding_inert(trees):
    eng = InferenceEngine(load_config(RECIPE, SETS), max_batch=8, quant="int8", device="cpu")
    eng.swap_weights(*port_tree(trees["features"]))
    x = images(8, seed=7)
    np.testing.assert_array_equal(eng.features(x[:5]), eng.features(x)[:5])


def test_engine_rejects_unknown_quant():
    with pytest.raises(ValueError, match="quant"):
        InferenceEngine(load_config(RECIPE, SETS), max_batch=2, quant="int4", device="cpu")


def test_parity_helpers():
    a = np.eye(4, dtype=np.float32)
    assert feature_cosine(a, a).min() >= 1.0 - 1e-12
    logits = np.asarray([[0.1, 0.9], [0.8, 0.2]], np.float32)
    assert top1_agreement(logits, logits) == 1.0
    assert top1_agreement(logits, logits[:, ::-1]) == 0.0
