"""Mixup/CutMix (``ops/mixup.py``) against the JAX package's, on the CPU.

JAX's draws are reproduced from the same key (``jax_mixup_draws`` splits
it as ``mixup_cutmix`` does) and handed to the port through ``draws=``;
the mixed images and labels then agree to 1e-6 in all four branches
(mixup alone, CutMix alone, both with the coin taking mixup, both with it
taking CutMix). The bounding box is the JAX one bit for bit, its
half-open interval included. Without ``draws=`` the port draws from the
seed of the step's ``"mixup"`` generator, the same on every device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.ops import mixup as jmix
from jumbo_mae_tpu_tpu_torch.ops import mixup as tmix
from torch_port_util import jax_mixup_draws

B, H, W, K = 6, 12, 16, 5
TOL = dict(atol=1e-6, rtol=1e-6)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, B)] * 0.9 + 0.1 / K
    return images, labels


def key_with_coin(take_mixup: bool) -> jax.Array:
    """A key whose coin picks mixup (``> 0.5``) or CutMix."""
    for seed in range(100):
        key = jax.random.key(seed)
        if (float(jax_mixup_draws(key, B, 0.8, 1.0)["coin"]) > 0.5) == take_mixup:
            return key
    raise AssertionError("no key found")


BRANCHES = {
    "mixup": (0.8, 0.0, lambda: jax.random.key(3)),
    "cutmix": (0.0, 1.0, lambda: jax.random.key(4)),
    "both_coin_mixup": (0.8, 1.0, lambda: key_with_coin(True)),
    "both_coin_cutmix": (0.8, 1.0, lambda: key_with_coin(False)),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branches_match_jax(branch):
    ma, ca, make_key = BRANCHES[branch]
    key = make_key()
    images, labels = inputs()
    want_x, want_y = jmix.mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels), ma, ca)
    draws = jax_mixup_draws(key, B, ma, ca)
    got_x, got_y = tmix.mixup_cutmix(torch.from_numpy(images), torch.from_numpy(labels), ma, ca, draws=draws)
    assert got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    if ca > 0 and (ma == 0 or float(draws["coin"]) <= 0.5):
        # CutMix pasted a box: some pixels come from the permuted rows
        assert not np.allclose(got_x.numpy(), images)


@pytest.mark.parametrize("ratio,center,h,w", [
    (0.75, (0.5, 0.5), 5, 5),     # box edges on grid points: [0.25, 0.75)
    (0.3, (0.1, 0.9), 12, 16),
    (0.9, (0.0, 1.0), 7, 9),
    (0.05, (0.37, 0.61), 224, 224),
])
def test_bounding_box_is_jax_bit_for_bit(ratio, center, h, w):
    got = tmix.bounding_box_mask(np.float32(ratio), np.asarray(center, np.float32), h, w)
    want = np.asarray(jmix._bounding_box_mask(jax.random.key(0), jnp.float32(ratio), h, w))
    # _bounding_box_mask draws its own centre: reproduce that draw
    cx, cy = np.asarray(jax.random.uniform(jax.random.key(0), (2,)))
    want_own = tmix.bounding_box_mask(np.float32(ratio), (cx, cy), h, w)
    np.testing.assert_array_equal(want_own, want[0, :, :, 0])
    assert got.shape == (h, w) and set(np.unique(got)) <= {0.0, 1.0}
    if (ratio, h) == (0.75, 5):
        # the half-open interval cx - s/2 <= x < cx + s/2 over linspace(0, 1, 5)
        np.testing.assert_array_equal(got[2], [1, 0, 0, 1, 1])


@pytest.mark.parametrize("n", [1, 2, 7, 16, 64, 224])
def test_linspace_is_jax_bit_for_bit(n):
    np.testing.assert_array_equal(tmix._linspace01(n), np.asarray(jnp.linspace(0, 1, n)))


def test_identity_without_alphas():
    images, labels = inputs()
    x, y = tmix.mixup_cutmix(torch.from_numpy(images), torch.from_numpy(labels), 0.0, 0.0)
    assert torch.equal(x, torch.from_numpy(images)) and torch.equal(y, torch.from_numpy(labels))


def test_draws_come_from_the_generator_seed():
    """The same seed draws the same mix (on any device); another seed
    another; bf16 images mix in float32, as JAX's float32 ratio promotes
    them."""
    images, labels = inputs()
    x, y = torch.from_numpy(images), torch.from_numpy(labels)

    def mix(seed, xs=x):
        return tmix.mixup_cutmix(xs, y, 0.8, 1.0, generator=torch.Generator().manual_seed(seed))

    a, b, c = mix(5), mix(5), mix(6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert mix(5, x.bfloat16())[0].dtype == torch.float32
    with pytest.raises(ValueError, match="generator"):
        tmix.mixup_cutmix(x, y, 0.8, 1.0)
    rng = np.random.default_rng(1)
    d = tmix.sample_draws(rng, B, 0.8, 1.0)
    assert sorted(d) == ["coin", "cutmix_center", "cutmix_perm", "cutmix_ratio", "mixup_perm", "mixup_ratio"]
    assert sorted(d["mixup_perm"]) == list(range(B)) and 0 < d["mixup_ratio"] < 1
