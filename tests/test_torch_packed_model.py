"""Token-packed serving in the port against the JAX package, on the CPU.

- **The packed forward against JAX.** ``encode_packed``, ``pool_packed``
  and ``serve_packed`` of the port's ``JumboViT`` against the flax
  model's on the same weights (drawn at O(1) from a numpy seed, carried
  over by ``interop/from_jax.py``), the same patch tokens and the same
  plan, in float32: within rtol 1e-5 / atol 1e-5.
- **Packed against unpacked in the port.** Each segment's pooled output
  and logits equal ``serve_full`` of its image alone, at its resolution,
  within 1e-5.
- **Segment isolation.** With one plan, new pixels in one request leave
  every other segment's output bit-equal; garbage in the pad tokens
  changes nothing.
- **The engine.** ``predict_packed`` and ``packed_parity`` of the port's
  ``InferenceEngine`` against the JAX engine's on the same tree and the
  same mixed-resolution list; the typed errors of the packed path.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu.models import JumboViT as FlaxJumboViT
from jumbo_mae_tpu_tpu.models import preset as flax_preset
from jumbo_mae_tpu_tpu.ops.preprocess import normalize_images as flax_normalize
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, ResolutionMismatchError
from jumbo_mae_tpu_tpu_torch.infer import packing
from jumbo_mae_tpu_tpu_torch.infer.bucketing import ceil_pow2
from jumbo_mae_tpu_tpu_torch.interop import state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models import JumboViT, preset
from jumbo_mae_tpu_tpu_torch.models.layers import resolve_attn_impl, segment_attention_mask
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from torch_port_util import port_tree, random_batch_stats, random_jumbo_params

TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = (32, 24, 16, 32, 8, 24)  # patch 4: 64, 36, 16, 64, 4, 36 patches
CASES = [
    dict(labels=None, pooling="cls", layers=2),
    dict(labels=7, pooling="cls", batch_norm=True, layers=3),
    dict(labels=5, pooling="gap", layers=4),
]


def _ids(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


def build_pair(seed: int, **kw):
    """A flax JumboViT and the port's, both float32 sincos2d at 32 px, with
    the same O(1) weights."""
    cfg = dict(image_size=32, patch_size=4, dtype="float32", posemb="sincos2d", layerscale=True, **kw)
    fmodel = FlaxJumboViT(flax_preset("vit_t16", **cfg))
    init = jax.tree_util.tree_map(np.asarray, fmodel.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32)))
    rng = np.random.default_rng(seed)
    variables = {"params": random_jumbo_params(init["params"], rng)}
    if "batch_stats" in init:
        variables["batch_stats"] = random_batch_stats(init["batch_stats"], rng)
    tmodel = JumboViT(preset("vit_t16", **cfg), device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables["params"], variables.get("batch_stats")))
    return fmodel, variables, tmodel


def images(sizes, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (s, s, 3), dtype=np.uint8) for s in sizes]


def port_tokens(tmodel, imgs):
    with torch.inference_mode():
        return [tmodel.embed_patches(normalize_images(torch.from_numpy(im[None])))[0].numpy() for im in imgs]


def plan_arrays(imgs, k: int, budget: int = 256):
    lengths = [k + (im.shape[0] // 4) ** 2 for im in imgs]
    _, plan = packing.choose_budget(lengths, packing.budget_rungs(budget))
    rows, smax = ceil_pow2(plan.rows), ceil_pow2(plan.max_segments)
    return plan, rows, packing.build_arrays(plan, k, rows=rows, max_segments=smax)


def port_packed(tmodel, buf, arrays, pooling):
    args = [torch.from_numpy(a) for a in (buf, arrays["segment_ids"], arrays["cls_pos"], arrays["cls_index"])]
    with torch.inference_mode():
        return {k: v.numpy() for k, v in tmodel.serve_packed(*args, pooling=pooling).items()}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_packed_forward_equals_jax(case):
    fmodel, variables, tmodel = build_pair(11, **case)
    k = tmodel.cfg.num_cls_tokens
    imgs = images(SIZES, seed=1)
    # the patch embedding at each request's own resolution, in both packages
    toks = port_tokens(tmodel, imgs)
    for im, t in zip(imgs, toks):
        model_r = FlaxJumboViT(fmodel.cfg.replace(image_size=im.shape[0]))
        ref = model_r.apply({"params": variables["params"]}, flax_normalize(jnp.asarray(im[None])),
                            method=FlaxJumboViT.patchify)
        np.testing.assert_allclose(t, np.asarray(ref)[0], **TOL)
    plan, rows, arrays = plan_arrays(imgs, k)
    buf = packing.place_tokens(plan, toks, k, rows=rows)
    pooling = case["pooling"]
    got = port_packed(tmodel, buf, arrays, pooling)
    jargs = (buf, arrays["segment_ids"], arrays["cls_pos"], arrays["cls_index"])
    want = fmodel.apply(variables, *jargs, True, pooling=pooling, method=FlaxJumboViT.serve_packed)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    # encode_packed and pool_packed on their own
    targs = [torch.from_numpy(a) for a in jargs]
    with torch.inference_mode():
        enc = tmodel.encode_packed(*targs)
        pooled_gap = tmodel.pool_packed(enc, *targs[1:], "gap").numpy()
    jenc = fmodel.apply(variables, *jargs, True, method=FlaxJumboViT.encode_packed)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    jgap = fmodel.apply(variables, jenc, *jargs[1:], "gap", method=FlaxJumboViT.pool_packed)
    np.testing.assert_allclose(pooled_gap, np.asarray(jgap), **TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_packed_equals_unpacked_per_segment(case):
    _, _, tmodel = build_pair(12, **case)
    k = tmodel.cfg.num_cls_tokens
    imgs = images(SIZES, seed=2)
    plan, rows, arrays = plan_arrays(imgs, k)
    pooling = case["pooling"]
    got = port_packed(tmodel, packing.place_tokens(plan, port_tokens(tmodel, imgs), k, rows=rows), arrays, pooling)
    for key in got:
        per_request = packing.unpack_rows(plan, got[key])
        for im, row in zip(imgs, per_request):
            with torch.inference_mode():
                ref = tmodel.serve_full(normalize_images(torch.from_numpy(im[None])), pooling=pooling)[key][0]
            np.testing.assert_allclose(row, ref.numpy(), **TOL)


def test_segment_isolation_bit_exact():
    _, _, tmodel = build_pair(13, labels=6, pooling="cls")
    k = tmodel.cfg.num_cls_tokens
    imgs = images(SIZES, seed=3)
    plan, rows, arrays = plan_arrays(imgs, k)
    base = port_packed(tmodel, packing.place_tokens(plan, port_tokens(tmodel, imgs), k, rows=rows), arrays, "cls")
    moved = list(imgs)
    moved[2] = images([imgs[2].shape[0]], seed=99)[0]
    out = port_packed(tmodel, packing.place_tokens(plan, port_tokens(tmodel, moved), k, rows=rows), arrays, "cls")
    for key in base:
        a, b = packing.unpack_rows(plan, base[key]), packing.unpack_rows(plan, out[key])
        for i in range(len(imgs)):
            assert np.array_equal(a[i], b[i]) != (i == 2), f"{key} of request {i}"
    # garbage in the pad tokens (segment id 0) moves nothing
    buf = packing.place_tokens(plan, port_tokens(tmodel, imgs), k, rows=rows)
    pad = arrays["segment_ids"] == 0
    buf[pad] = np.random.default_rng(4).standard_normal((int(pad.sum()), buf.shape[-1])) * 50
    noisy = port_packed(tmodel, buf, arrays, "cls")
    for key in base:
        for a, b in zip(packing.unpack_rows(plan, base[key]), packing.unpack_rows(plan, noisy[key])):
            np.testing.assert_array_equal(a, b)


def test_segment_mask_and_masked_attention_path():
    seg = torch.tensor([[1, 1, 2, 0], [0, 0, 0, 0]], dtype=torch.int32)
    m = segment_attention_mask(seg)
    assert m.shape == (2, 1, 4, 4) and m.dtype == torch.bool
    np.testing.assert_array_equal(m[0, 0].numpy(), [[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.testing.assert_array_equal(m[1, 0].numpy(), np.eye(4, dtype=bool))  # all-pad rows attend to themselves
    from jumbo_mae_tpu_tpu.models.layers import segment_attention_mask as jax_mask

    np.testing.assert_array_equal(m.numpy(), np.asarray(jax_mask(jnp.asarray(seg.numpy()))))
    # a mask never reaches the kernels, whatever the device
    for dev in ("cuda", "cpu"):
        assert resolve_attn_impl("auto", device_type=dev, dropout=0.0, deterministic=True, head_dim=64,
                                 dtype=torch.bfloat16, masked=True) == "einsum"


def test_learnable_posemb_serves_only_its_grid():
    tmodel = JumboViT(preset("vit_t16", image_size=32, patch_size=4, posemb="learnable", dtype="float32"),
                      device="cpu")
    with pytest.raises(ValueError, match="sincos2d"):
        tmodel.embed_patches(torch.zeros(1, 24, 24, 3))


# ---------------------------------------------------------------- engine

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
OVERRIDES = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
             "model.dec_dtype=float32"]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the smoke recipe (32 px, patch 4,
    sincos2d, float32) serving the same O(1) weights with an 11-way head."""
    jeng = JaxEngine(jax_load_config(RECIPE, OVERRIDES), max_batch=8, max_tokens=512, labels=11, warm_cache=False)
    init = jax.tree_util.tree_map(np.asarray, jeng._task("logits")["variables"])
    params = random_jumbo_params(init["params"], np.random.default_rng(5))
    jeng.swap_weights(params)
    peng = InferenceEngine(load_config(RECIPE, OVERRIDES), max_batch=8, max_tokens=512, labels=11, device="cpu")
    peng.swap_weights(*port_tree(params))
    return jeng, peng


MIXES = [
    ("features", "cls"),
    ("features", "gap"),
    ("logits", "cls"),
    (["features", "logits", "features", "logits", "logits", "features", "features"], "cls"),
]


@pytest.mark.parametrize("tasks,pool", MIXES, ids=["features-cls", "features-gap", "logits", "mixed"])
def test_engine_predict_packed_equals_jax(engines, tasks, pool):
    jeng, peng = engines
    imgs = images((32, 24, 16, 32, 8, 28, 32), seed=6)
    got = peng.predict_packed(imgs, tasks, pool=pool)
    want = jeng.predict_packed(imgs, tasks, pool=pool)
    assert len(got) == len(want) == len(imgs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)
    assert peng.last_breakdown()["pad_fraction"] == jeng.last_breakdown()["pad_fraction"]
    assert peng.last_breakdown()["bucket"] == jeng.last_breakdown()["bucket"]
    # the same executables (per-resolution embeds, one packed key), named alike
    assert set(peng.compile_counts) == set(jeng.compile_counts)
    assert any(".packed:" in k for k, _ in peng.compile_counts)


def test_engine_packed_parity_equals_jax(engines):
    jeng, peng = engines
    imgs = images((32, 16, 24, 32), seed=7)
    for tasks in ("features", ["logits", "features", "logits", "features"]):
        got = peng.packed_parity(imgs, tasks)
        want = jeng.packed_parity(imgs, tasks)
        assert got["pass"] and want["pass"]
        assert {k: got[k] for k in ("n", "pool", "logits_top1_agree")} == \
            {k: want[k] for k in ("n", "pool", "logits_top1_agree")}
        assert [r["task"] for r in got["requests"]] == [r["task"] for r in want["requests"]]
        if got["feature_cosine_min"] is not None:
            assert got["feature_cosine_min"] == pytest.approx(want["feature_cosine_min"], abs=1e-6)
    assert set(peng.compile_counts) == set(jeng.compile_counts)
    assert any(".full:" in k for k, _ in peng.compile_counts)


def test_engine_warmup_packed_counts_like_jax():
    cfg_j, cfg_p = jax_load_config(RECIPE, OVERRIDES), load_config(RECIPE, OVERRIDES)
    jeng = JaxEngine(cfg_j, max_batch=8, max_tokens=512, warm_cache=False)
    peng = InferenceEngine(cfg_p, max_batch=8, max_tokens=512, device="cpu")
    mix = [32, 24, 24, 16]
    n = peng.warmup_packed(mix)
    assert n == jeng.warmup_packed(mix) == 4
    assert set(peng.compile_counts) == set(jeng.compile_counts)
    before = dict(peng.compile_counts)
    peng.predict_packed(images(mix, seed=8))
    assert peng.compile_counts == before  # the warmed mix runs no first run


def test_engine_packed_errors(engines):
    _, peng = engines
    with pytest.raises(ValueError, match="square"):
        peng.predict_packed([np.zeros((32, 24, 3), np.uint8)])
    with pytest.raises(ValueError, match="patch-aligned"):
        peng.predict_packed([np.zeros((30, 30, 3), np.uint8)])
    with pytest.raises(ValueError, match="features/logits"):
        peng.predict_packed(images((32,)), "reconstruct")
    with pytest.raises(ValueError, match="pool"):
        peng.predict_packed(images((32,)), pool="tokens")
    with pytest.raises(ValueError, match="tasks"):
        peng.predict_packed(images((32, 16)), ["features"])
    with pytest.raises(ValueError, match="rung ladder"):
        peng.predict_packed(images((96,)))  # 579 tokens > max_tokens 512
    assert peng.predict_packed([]) == []
    with pytest.raises(ResolutionMismatchError, match="predict_packed") as err:
        peng.features(images((24,))[0])
    assert err.value.expected == 32 and err.value.got == (24, 24)
    learn = InferenceEngine(load_config(RECIPE, OVERRIDES + ["model.overrides.posemb=learnable"]), device="cpu")
    with pytest.raises(ValueError, match="resolution-locked"):
        learn.predict_packed(images((24,)))
    assert peng.seq_len(32) == 3 + 64
