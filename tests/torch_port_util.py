"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Every parameter and input is drawn from a seeded ``np.random.default_rng``
and handed to both packages as numpy arrays. Parameters are drawn at O(1)
scale on purpose: at the JAX init LayerScale is 1e-4 and the CLS tokens
are zero, so a parity test at init would barely exercise the blocks or the
jumbo MLP.
"""

from __future__ import annotations

import numpy as np


def random_jumbo_params(tree: dict, rng: np.random.Generator, path: tuple = ()) -> dict:
    """A flax ``JumboViT`` params tree of the same structure as ``tree``
    with every leaf redrawn: dense, conv and attention kernels scaled by
    1/sqrt(fan_in), biases and norm offsets around 0, norm scales around
    1, LayerScale, CLS tokens and learnable positions at O(1)."""
    out = {}
    for key, val in tree.items():
        here = (*path, key)
        if isinstance(val, dict):
            out[key] = random_jumbo_params(val, rng, here)
            continue
        shape = np.shape(val)
        if key == "kernel":
            # q/k/v DenseGeneral (D, H, hd) contract over axis 0 only
            fan_in = shape[0] if path[-1] in ("q", "k", "v") else int(np.prod(shape[:-1]))
            leaf = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif key == "scale":
            leaf = 1.0 + 0.2 * rng.standard_normal(shape)
        elif key == "bias":
            leaf = 0.2 * rng.standard_normal(shape)
        elif key.startswith("ls"):
            leaf = rng.uniform(0.5, 1.5, shape)
        else:  # cls_tokens, pos_embed
            leaf = rng.standard_normal(shape)
        out[key] = leaf.astype(np.float32)
    return out


def random_batch_stats(tree: dict, rng: np.random.Generator) -> dict:
    """BatchNorm running statistics of the same structure: means around
    0, variances in [0.5, 2]."""
    bn = tree["head"]["bn"]
    n = np.shape(bn["mean"])
    return {"head": {"bn": {
        "mean": (0.5 * rng.standard_normal(n)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, n).astype(np.float32),
    }}}


def random_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """‖got − ref‖ / ‖ref‖ over the whole array."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def jax_mixup_draws(key, batch: int, mixup_alpha: float, cutmix_alpha: float) -> dict:
    """The draws ``jumbo_mae_tpu_tpu.ops.mixup.mixup_cutmix`` makes from
    ``key``, split as it splits it, in the port's ``draws=`` layout."""
    import jax

    km, kc, kflip = jax.random.split(key, 3)
    draws = {}
    if mixup_alpha > 0:
        k1, k2 = jax.random.split(km)
        draws["mixup_ratio"] = np.asarray(jax.random.beta(k1, mixup_alpha, mixup_alpha))
        draws["mixup_perm"] = np.asarray(jax.random.permutation(k2, batch))
    if cutmix_alpha > 0:
        k1, k2, k3 = jax.random.split(kc, 3)
        draws["cutmix_ratio"] = np.asarray(jax.random.beta(k1, cutmix_alpha, cutmix_alpha))
        draws["cutmix_center"] = np.asarray(jax.random.uniform(k2, (2,)))
        draws["cutmix_perm"] = np.asarray(jax.random.permutation(k3, batch))
    if mixup_alpha > 0 and cutmix_alpha > 0:
        draws["coin"] = np.asarray(jax.random.uniform(kflip))
    return draws


def flax_init_shapes(module, *args, **kwargs) -> dict:
    """The variables ``module.init(*args, **kwargs)`` makes, without running
    it (``jax.eval_shape``): numpy zeros of its shapes, the BatchNorm
    ``var`` ones as flax initializes it. The parameters are placeholders
    for ``random_jumbo_params`` to redraw."""
    import jax

    key = jax.random.key(0)
    rngs = {"params": key, "mixup": key, "dropout": key}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))
    return jax.tree_util.tree_map_with_path(
        lambda kp, s: (np.ones if kp[-1].key == "var" else np.zeros)(s.shape, s.dtype), shapes
    )
