"""The port's patch and masking ops against the JAX package's, on the CPU.

Inputs are drawn from a seeded numpy generator and handed to both
packages; masks are pinned through the injected noise. Reshapes,
gathers and argsorts are exact, so those comparisons are exact
(``np.testing.assert_array_equal``); the per-sample loss is a float32
mean over patch elements, summed in another order by XLA and by
PyTorch, so it is held at rtol 1e-6 (a few float32 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.ops import masking as jm
from jumbo_mae_tpu_tpu.ops import patches as jp
from jumbo_mae_tpu_tpu_torch.ops import masking as tm
from jumbo_mae_tpu_tpu_torch.ops import patches as tp


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("size,p", [(64, 8), (32, 16), (48, 16)])
def test_extract_and_merge_patches_equal_jax(size, p):
    imgs = _rng(0).standard_normal((3, size, size, 3)).astype(np.float32)
    ref = np.asarray(jp.extract_patches(jnp.asarray(imgs), p))
    got = tp.extract_patches(torch.from_numpy(imgs), p).numpy()
    np.testing.assert_array_equal(got, ref)
    back = tp.merge_patches(torch.from_numpy(got), p).numpy()
    np.testing.assert_array_equal(back, np.asarray(jp.merge_patches(jnp.asarray(ref), p)))
    np.testing.assert_array_equal(back, imgs)


@pytest.mark.parametrize("with_mask", [True, False])
def test_patch_mse_loss_per_sample_matches_jax(with_mask):
    rng = _rng(1)
    out = rng.standard_normal((4, 64, 192)).astype(np.float32)
    tgt = rng.standard_normal((4, 64, 192)).astype(np.float32)
    mask = (rng.random((4, 64)) < 0.75).astype(np.float32) if with_mask else None
    ref = np.asarray(jp.patch_mse_loss_per_sample(
        jnp.asarray(out), jnp.asarray(tgt), None if mask is None else jnp.asarray(mask)))
    got = tp.patch_mse_loss_per_sample(
        torch.from_numpy(out), torch.from_numpy(tgt), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    scalar = tp.patch_mse_loss(
        torch.from_numpy(out), torch.from_numpy(tgt), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(scalar.item(), float(np.asarray(ref).mean()), rtol=1e-6)


def test_masked_loss_is_the_mean_over_masked_patches():
    """Dividing by the masked ratio makes the loss the mean squared error
    over masked patches only: visible patches do not move it."""
    rng = _rng(2)
    out = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    tgt = torch.zeros_like(out)
    mask = torch.zeros(2, 16)
    mask[:, :12] = 1.0
    got = tp.patch_mse_loss_per_sample(out, tgt, mask)
    want = out[:, :12].square().mean(dim=(1, 2))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    out2 = out.clone()
    out2[:, 12:] += 100.0
    torch.testing.assert_close(tp.patch_mse_loss_per_sample(out2, tgt, mask), got, rtol=0, atol=0)


def _noise(mode, batch, length, seed, ties=False):
    shape = (length,) if mode == "shared" else (batch, length)
    noise = _rng(seed).random(shape).astype(np.float32)
    if ties:  # coarse noise: many equal values, so the sort's tie order shows
        noise = np.round(noise * 4) / 4
    return noise


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["shared", "per_sample"])
def test_random_masking_equals_jax(mode, ties):
    b, n, d, keep = 3, 64, 5, 16
    x = _rng(3).standard_normal((b, n, d)).astype(np.float32)
    noise = _noise(mode, b, n, 4, ties)
    rk, rm, rr = jm.random_masking(jnp.asarray(x), None, keep, mode=mode, noise=jnp.asarray(noise))
    kept, mask, restore = tm.random_masking(torch.from_numpy(x), keep, mode=mode, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(restore.numpy(), np.asarray(rr))
    assert mask.dtype == torch.float32 and mask.shape == (b, n)
    assert (mask.sum(-1) == n - keep).all()

    token = _rng(5).standard_normal((1, 1, d)).astype(np.float32)
    ref = jm.unshuffle_with_mask_tokens(rk, jnp.asarray(token), rr)
    got = tm.unshuffle_with_mask_tokens(kept, torch.from_numpy(token), restore)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # visible rows return to their places; masked rows hold the token
    vis = mask.numpy() == 0
    np.testing.assert_array_equal(got.numpy()[vis], x[vis])
    np.testing.assert_array_equal(got.numpy()[~vis], np.broadcast_to(token[0], ((~vis).sum(), d)))


@pytest.mark.parametrize("ids_shape", [(7,), (3, 7)])
def test_index_sequence_equals_jax(ids_shape):
    x = _rng(6).standard_normal((3, 10, 2, 4)).astype(np.float32)
    ids = _rng(7).integers(0, 10, ids_shape)
    ref = np.asarray(jm.index_sequence(jnp.asarray(x), jnp.asarray(ids)))
    got = tm.index_sequence(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_masking_checks_noise_shape_and_refuses_onehot():
    x = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="noise shape"):
        tm.random_masking(x, 2, mode="shared", noise=torch.zeros(2, 8))
    with pytest.raises(ValueError, match="noise shape"):
        tm.random_masking(x, 2, mode="per_sample", noise=torch.zeros(8))
    with pytest.raises(ValueError, match="mode"):
        tm.random_masking(x, 2, mode="rows", noise=torch.zeros(8))
    with pytest.raises(ValueError, match="generator"):
        tm.random_masking(x, 2)
    with pytest.raises(NotImplementedError, match="TPU"):
        tm.random_masking(x, 2, noise=torch.rand(8), gather_impl="onehot")
    with pytest.raises(NotImplementedError, match="TPU"):
        tm.unshuffle_with_mask_tokens(x[:, :2], torch.zeros(1, 1, 3), torch.arange(8), impl="onehot")


@pytest.mark.parametrize("mode", ["shared", "per_sample"])
def test_generator_draws_are_seeded(mode):
    """Without injected noise the draw comes from the generator: one seed
    gives one mask, another seed another."""
    x = torch.randn(4, 64, 3)

    def draw(seed):
        return tm.random_masking(x, 16, mode=mode, generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])
    if mode == "per_sample":
        assert not torch.equal(a[1][0], a[1][1])  # one permutation per sample


def test_mask_algebra_equals_jax():
    rng = _rng(8)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    m1 = (rng.random((2, 6)) < 0.5).astype(np.float32)
    m2 = rng.random((2, 6)).astype(np.float32) * (rng.random((2, 6)) < 0.5)
    a, b = rng.standard_normal((2, 6, 3)).astype(np.float32), rng.standard_normal((2, 6, 3)).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    pairs = [
        (jm.no_mask(J(x)), tm.no_mask(T(x))),
        (jm.all_mask(J(x)), tm.all_mask(T(x))),
        (jm.mask_not(J(m2)), tm.mask_not(T(m2))),
        (jm.mask_union(J(m1), J(m2)), tm.mask_union(T(m1), T(m2))),
        (jm.mask_intersection(J(m1), J(m2)), tm.mask_intersection(T(m1), T(m2))),
        (jm.mask_select(J(m1), J(a), J(b)), tm.mask_select(T(m1), T(a), T(b))),
    ]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
