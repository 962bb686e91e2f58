"""The port's InferenceEngine against the JAX InferenceEngine, on the CPU.

The JAX engine is built as tests/test_infer_engine.py builds it (the
smoke_cpu recipe at float32, no warm cache); both engines then serve the
same weights, drawn at O(1) scale from a seeded numpy generator, and the
same uint8 images. float32, atol 1e-4 / rtol 1e-4 (sum order only).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu_torch.infer import (
    InferenceEngine,
    OversizedBatchError,
    ResolutionMismatchError,
    bucket_for,
    pow2_rungs,
)
from jumbo_mae_tpu_tpu_torch.models import preset
from torch_port_util import random_batch_stats, random_images, random_jumbo_params, rel_err

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
RECIPE_OVERRIDES = [
    "model.overrides.dtype=float32",
    "model.dec_layers=1",
    "model.dec_dim=32",
    "model.dec_heads=2",
    "model.dec_dtype=float32",
]
# the port's config of the same model: recipes/smoke_cpu.yaml's model section
PORT_CFG = preset(
    "vit_t16", mask_ratio=0.75, posemb="sincos2d", image_size=32, patch_size=4, dtype="float32"
)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def engines():
    """(jax engine, port engine) serving the same random weights, with a
    BatchNorm head so the logits path carries running statistics."""
    jeng = JaxEngine(
        load_config(RECIPE, RECIPE_OVERRIDES), max_batch=8, labels=10,
        batch_norm=True, warm_cache=False,
    )
    init = jax.tree_util.tree_map(np.asarray, jeng._task("logits")["variables"])
    rng = np.random.default_rng(0)
    params = random_jumbo_params(init["params"], rng)
    stats = random_batch_stats(init["batch_stats"], rng)
    jeng.swap_weights(params, stats)
    peng = InferenceEngine(
        PORT_CFG, labels=10, batch_norm=True, params=params, batch_stats=stats,
        max_batch=8, device="cpu",
    )
    return jeng, peng, params


def images(n, seed=1, size=32):
    return random_images(np.random.default_rng(seed), n, size)


@pytest.mark.parametrize("n", [1, 3, 9])
def test_logits_match_jax(engines, n):
    jeng, peng, _ = engines
    x = images(n)
    got = peng.logits(x)
    assert got.shape == (n, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, jeng.logits(x), **TOL)


@pytest.mark.parametrize("n", [1, 3, 9])
@pytest.mark.parametrize("pool", ["cls", "gap", "tokens"])
def test_features_match_jax(engines, pool, n):
    jeng, peng, _ = engines
    x = images(n, seed=2)
    got = peng.features(x, pool=pool)
    ref = jeng.features(x, pool=pool)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


def test_padding_is_inert(engines):
    """Valid rows are bit-identical whatever the pad rows hold."""
    _, peng, _ = engines
    x = images(5, seed=3)
    zero_pad = np.concatenate([x, np.zeros((3, 32, 32, 3), np.uint8)])
    rand_pad = np.concatenate([x, images(3, seed=4)])
    for task, pool in (("logits", None), ("features", "cls"), ("features", "gap"), ("features", "tokens")):
        a = peng.dispatch(task, zero_pad, pool=pool)[:5]
        b = peng.dispatch(task, rand_pad, pool=pool)[:5]
        assert np.array_equal(a, b), (task, pool)
        # and predict() serves exactly the zero-padded bucket's rows
        kw = {} if pool is None else {"pool": pool}
        assert np.array_equal(peng.predict(x, task=task, **kw), a)


def test_buckets_follow_the_ladder(engines, monkeypatch):
    _, peng, _ = engines
    seen = []
    real = peng.dispatch

    def spy(task, imgs, *, pool=None):
        seen.append(imgs.shape[0])
        return real(task, imgs, pool=pool)

    monkeypatch.setattr(peng, "dispatch", spy)
    for n in (1, 2, 3, 5, 8, 9, 17):
        peng.logits(images(n, seed=5))
    # 9 → 8 + 1 and 17 → 8 + 8 + 1: chunks of max_batch, each padded
    assert seen == [1, 2, 4, 8, 8, 8, 1, 8, 8, 1]
    assert pow2_rungs(8) == (1, 2, 4, 8) and pow2_rungs(6) == (1, 2, 4, 6)
    assert [bucket_for(n, 8) for n in (1, 2, 3, 4, 5, 7, 8)] == [1, 2, 4, 4, 8, 8, 8]
    assert bucket_for(5, 6) == 6 and bucket_for(4, 6) == 4


def test_chunked_request_equals_its_chunks(engines):
    _, peng, _ = engines
    x = images(9, seed=6)
    whole = peng.features(x)
    np.testing.assert_array_equal(whole[:8], peng.features(x[:8]))
    np.testing.assert_array_equal(whole[8:], peng.features(x[8:]))


def test_oversized_batch_error():
    with pytest.raises(OversizedBatchError):
        bucket_for(9, 8)
    with pytest.raises(ValueError):
        bucket_for(0, 8)
    assert issubclass(OversizedBatchError, ValueError)


def test_request_validation(engines):
    _, peng, _ = engines
    with pytest.raises(ResolutionMismatchError) as exc:
        peng.features(images(2, size=16))
    assert exc.value.expected == 32 and exc.value.got == (16, 16)
    with pytest.raises(ValueError):
        peng.features(np.zeros((2, 32, 32, 4), np.uint8))
    with pytest.raises(ValueError):
        peng.features(images(2), pool="max")
    with pytest.raises(ValueError):
        peng.predict(images(2), task="reconstruct")
    # a single HWC image is a batch of one
    assert peng.features(images(1)[0]).shape == (1, 3 * 64)


def test_dtype_override_and_init_seed():
    x = images(3, seed=7)
    f32 = InferenceEngine(PORT_CFG, labels=10, init_seed=3, max_batch=4, device="cpu")
    again = InferenceEngine(PORT_CFG, labels=10, init_seed=3, max_batch=4, device="cpu")
    other = InferenceEngine(PORT_CFG, labels=10, init_seed=4, max_batch=4, device="cpu")
    bf16 = InferenceEngine(PORT_CFG, labels=10, init_seed=3, max_batch=4, dtype="bfloat16", device="cpu")
    assert bf16.cfg.compute_dtype == torch.bfloat16 and f32.cfg.compute_dtype == torch.float32
    ref = f32.features(x)
    assert np.array_equal(again.features(x), ref)
    assert not np.allclose(other.features(x), ref)
    got = bf16.features(x)
    assert got.dtype == np.float32 and rel_err(got, ref) <= 3e-2
    # serving forces the stochastic and MAE knobs off
    assert f32.cfg.mask_ratio is None and f32.cfg.dropout == 0.0 and f32.cfg.droppath == 0.0


def test_logits_need_labels_and_params_must_fit():
    eng = InferenceEngine(PORT_CFG, labels=0, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="label"):
        eng.logits(images(1))
    with pytest.raises(KeyError):
        InferenceEngine(PORT_CFG, params={"cls_tokens": np.zeros((1, 3, 64), np.float32)}, device="cpu")


def test_trunk_only_params_serve_features_and_keep_the_head_at_init(engines):
    """A features checkpoint has no head: the trunk loads, the head keeps
    its init (the JAX engine's graft does the same)."""
    jeng, _, params = engines
    trunk = {k: v for k, v in params.items() if k != "head"}
    eng = InferenceEngine(PORT_CFG, labels=10, params=trunk, init_seed=5, max_batch=8, device="cpu")
    fresh = InferenceEngine(PORT_CFG, labels=10, init_seed=5, max_batch=8, device="cpu")
    x = images(3, seed=8)
    np.testing.assert_allclose(eng.features(x), jeng.features(x), **TOL)
    assert torch.equal(eng.model.head.fc.weight, fresh.model.head.fc.weight)
