"""MAE reconstruction through the port's engine against the JAX engine,
and the encoder-once cache, on the CPU.

The port draws the shared-mode mask from ``reconstruct_noise`` (a host
``torch.Generator``), the JAX engine from ``jax.random.key(seed)``: one
seed gives two masks. After the unshuffle the reconstruction depends only
on which tokens were kept (posemb is added before the shuffle and the
encoder is permutation-equivariant over the visible tokens), so the
parity test pins the port's noise to the JAX engine's returned mask
(``mask + arange(N)/N·1e-3``: masked tokens sort last). float32, atol /
rtol 1e-4, from a port MAE save and the same flax tree. The cache cases
mirror tests/test_infer_engine.py.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.config import load_config as jax_load_config
from jumbo_mae_tpu_tpu.infer import InferenceEngine as JaxEngine
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.infer import engine as engine_mod
from torch_port_util import port_save, random_images, random_jumbo_params

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
SETS = ["model.overrides.dtype=float32", "model.dec_layers=1", "model.dec_dim=32", "model.dec_heads=2",
        "model.dec_dtype=float32"]
TOL = dict(atol=1e-4, rtol=1e-4)
N = 64  # patches of the smoke recipe (32 px, patch 4)


def images(n, seed=0):
    return random_images(np.random.default_rng(seed), n, 32)


@pytest.fixture(scope="module")
def mae(tmp_path_factory):
    jeng = JaxEngine(jax_load_config(RECIPE, SETS), max_batch=4, warm_cache=False)
    init = jax.tree_util.tree_map(np.asarray, jeng._task("reconstruct")["variables"]["params"])
    params = random_jumbo_params(init, np.random.default_rng(3))
    jeng.swap_weights(params)
    directory = tmp_path_factory.mktemp("mae")
    port_save(directory, load_config(RECIPE, SETS), params)
    return jeng, directory


def engine(mae, extra=(), **kw):
    kw.setdefault("max_batch", 4)
    return InferenceEngine(load_config(RECIPE, [*SETS, *extra]), ckpt=str(mae[1]), device="cpu", **kw)


def pin_noise(monkeypatch, jax_mask: np.ndarray) -> None:
    """The port's mask noise from the JAX engine's shared mask."""
    noise = torch.from_numpy(jax_mask[0].astype(np.float32) + np.arange(N, dtype=np.float32) / N * 1e-3)
    monkeypatch.setattr(engine_mod, "reconstruct_noise", lambda seed, n: noise.clone())


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("n", [1, 3, 6])
def test_reconstruct_matches_jax(mae, monkeypatch, n, cached):
    jeng, _ = mae
    x = images(n, seed=n)
    ref = jeng.reconstruct(x, seed=5)
    pin_noise(monkeypatch, ref["mask"])
    got = engine(mae, encoder_cache=8 if cached else 0).reconstruct(x, seed=5)
    assert got["reconstruction"].shape == (n, N, 48) and got["reconstruction"].dtype == np.float32
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["reconstruction"], ref["reconstruction"], **TOL)


def test_split_is_the_fused_forward(mae):
    """``mae_encode`` then ``mae_decode`` are the training forward's ops:
    its reconstruction and mask, bit for bit, on the same noise."""
    model = engine(mae).model("reconstruct")
    x = torch.from_numpy(images(3, seed=7))
    noise = engine_mod.reconstruct_noise(11, N)
    with torch.no_grad():
        fused = model(x, mask_noise=noise, return_reconstruction=True)
        tokens, mask, ids = model.mae_encode(x, mask_noise=noise)
        pred = model.mae_decode(tokens, ids)
    assert torch.equal(pred, fused["reconstruction"]) and torch.equal(mask, fused["mask"])
    # the cache's per-row ids gather what the shared ids gather
    with torch.no_grad():
        rows = model.mae_decode(tokens, ids.expand(3, -1))
    assert torch.equal(rows, pred)


def test_reconstruct_noise_is_a_host_draw():
    a = engine_mod.reconstruct_noise(3, N)
    assert a.device.type == "cpu" and a.dtype == torch.float32 and a.shape == (N,)
    assert torch.equal(a, engine_mod.reconstruct_noise(3, N))
    assert not torch.equal(a, engine_mod.reconstruct_noise(4, N))


def test_encoder_cache_matches_fused_reconstruct(mae):
    fused = engine(mae)
    cached = engine(mae, encoder_cache=8)
    x = images(3, seed=12)
    ref = fused.reconstruct(x, seed=0)
    out1 = cached.reconstruct(x, seed=0)
    np.testing.assert_array_equal(out1["reconstruction"], ref["reconstruction"])
    np.testing.assert_array_equal(out1["mask"], ref["mask"])
    st = cached.encoder_cache_stats()
    assert st["misses"] == 3 and st["size"] == 3
    out2 = cached.reconstruct(x, seed=0)  # every row from the cache
    np.testing.assert_array_equal(out2["reconstruction"], out1["reconstruction"])
    st = cached.encoder_cache_stats()
    assert st["hits"] == 3 and st["misses"] == 3
    # another seed is another mask: new entries, another output
    out3 = cached.reconstruct(x, seed=1)
    assert not np.array_equal(out1["mask"], out3["mask"])
    assert cached.encoder_cache_stats()["misses"] == 6


def test_encoder_cache_first_runs_and_chunks(mae):
    """A request larger than max_batch encodes and decodes in chunks; the
    decoder's first runs are counted apart from the encoder's."""
    eng = engine(mae, encoder_cache=16)
    x = images(6, seed=13)
    ref = engine(mae).reconstruct(x, seed=2)
    out = eng.reconstruct(x, seed=2)
    np.testing.assert_allclose(out["reconstruction"], ref["reconstruction"], **TOL)
    assert set(eng.compile_counts) == {("reconstruct.enc", 4), ("reconstruct.enc", 2),
                                       ("reconstruct.dec", 4), ("reconstruct.dec", 2)}


def test_encoder_cache_evicts_lru(mae):
    eng = engine(mae, encoder_cache=2)
    a, b, c = (images(1, seed=s) for s in (20, 21, 22))
    eng.reconstruct(a, seed=0)
    eng.reconstruct(b, seed=0)  # {a, b}
    eng.reconstruct(c, seed=0)  # evicts a → {b, c}
    st = eng.encoder_cache_stats()
    assert st["size"] == 2 and st["misses"] == 3
    eng.reconstruct(b, seed=0)  # hit
    eng.reconstruct(a, seed=0)  # a miss again
    st = eng.encoder_cache_stats()
    assert st["hits"] == 1 and st["misses"] == 4


def test_encoder_cache_byte_cap_evicts_before_entry_cap(mae):
    probe = engine(mae, encoder_cache=8)
    probe.reconstruct(images(1, seed=30), seed=0)
    row_bytes = probe.encoder_cache_bytes()
    # tokens (3 CLS + 16 kept, 32 wide, f32), the mask (f32) and ids (int32)
    assert row_bytes == (3 + 16) * 32 * 4 + N * 4 + N * 4
    eng = engine(mae, encoder_cache=64, encoder_cache_bytes=int(row_bytes * 1.5))
    for s in (30, 31, 32):
        eng.reconstruct(images(1, seed=s), seed=0)
    st = eng.encoder_cache_stats()
    assert st["capacity"] == 64 and st["capacity_bytes"] == int(row_bytes * 1.5)
    assert st["size"] == 1 and st["misses"] == 3
    assert 0 < st["bytes"] <= st["capacity_bytes"] and eng.encoder_cache_bytes() == row_bytes
    eng.reconstruct(images(1, seed=32), seed=0)  # the survivor is the newest row
    assert eng.encoder_cache_stats()["hits"] == 1


def test_encoder_cache_dedupes_within_batch(mae):
    eng = engine(mae, encoder_cache=8)
    img = images(1, seed=23)
    out = eng.reconstruct(np.concatenate([img, img, img]), seed=0)
    assert out["reconstruction"].shape[0] == 3
    np.testing.assert_array_equal(out["reconstruction"][0], out["reconstruction"][2])
    assert eng.encoder_cache_stats()["misses"] == 1


def test_encoder_cache_refuses_per_sample_masks(mae):
    with pytest.raises(ValueError, match="shared"):
        engine(mae, ["model.overrides.mask_mode=per_sample"], encoder_cache=8)


def test_reconstruct_padding_is_inert(mae, monkeypatch):
    """Pad rows of the encode and of the decode cannot reach valid rows."""
    eng = engine(mae, encoder_cache=8)
    fused = engine(mae)
    x = images(3, seed=40)
    a = fused.reconstruct(x, seed=1)  # bucket 4, one zero pad row
    b = fused._dispatch("reconstruct", None, 4, (np.concatenate([x, images(1, seed=41)]), 1), 3)[0]
    np.testing.assert_array_equal(a["reconstruction"], b["reconstruction"])
    np.testing.assert_array_equal(eng.reconstruct(x, seed=1)["reconstruction"], a["reconstruction"])
