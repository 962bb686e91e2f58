"""Procedural labeled image dataset for end-to-end runs without a dataset.

Counterpart of ``jumbo_mae_tpu_tpu/data/toy.py`` (numpy; PIL to write
PNG): the same class bank, nuisances and draws, so :func:`toy_examples`
gives the same arrays in both packages. Each class is a fixed texture (a
sum of plane waves); each sample applies a random translation, colour gain
and bias, contrast jitter and noise. :func:`write_toy_shards` writes them
as lossless PNG tar shards, which decode back to the same pixels.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["toy_examples", "toy_pretrain_hparams", "write_toy_shards"]


def _class_bank(classes: int, waves: int, rng: np.random.Generator):
    """Per-class plane-wave parameters, shapes (classes, waves).

    The PRIMARY wave's frequency pair is enumerated from a fixed list so no
    two classes share it — the per-sample translation absorbs phase, so
    phase/amplitude can never carry class identity; the frequency signature
    must, and it must be distinct by construction (random draws collide).
    Secondary waves add class-conditional texture at lower amplitude.
    """
    # HIGH-frequency signatures (4–12 cycles/image ≈ wavelength 2.7–8 px at
    # 32px, comparable to the 4px patch): a smooth low-frequency field is
    # locally interpolatable, so MAE inpainting never needs class identity
    # and the probe margin collapses (measured) — at texture scale, masked
    # patches can only be reconstructed by recognizing WHICH grating this
    # is, which is exactly the class.
    pairs = [
        (0.0, 4.0), (4.0, 0.0), (4.0, 4.0), (4.0, -4.0),
        (0.0, 8.0), (8.0, 0.0), (8.0, 8.0), (8.0, -8.0),
        (4.0, 8.0), (8.0, 4.0), (8.0, -4.0), (4.0, -8.0),
        (0.0, 12.0), (12.0, 0.0), (12.0, 12.0), (12.0, -12.0),
    ]
    if classes > len(pairs):
        raise ValueError(f"at most {len(pairs)} classes, got {classes}")
    fx = np.empty((classes, waves))
    fy = np.empty((classes, waves))
    fx[:, 0] = [pairs[i][0] for i in range(classes)]
    fy[:, 0] = [pairs[i][1] for i in range(classes)]
    if waves > 1:
        # low-amplitude low-frequency clutter shared across classes
        fx[:, 1:] = rng.integers(1, 3, size=(classes, waves - 1))
        fy[:, 1:] = rng.integers(1, 3, size=(classes, waves - 1)) * rng.choice(
            [-1.0, 1.0], size=(classes, waves - 1)
        )
    amp = np.full((classes, waves), 0.35)
    amp[:, 0] = 1.0  # the distinct texture wave dominates
    phase = rng.uniform(0, 2 * np.pi, size=(classes, waves))
    return fx, fy, amp, phase


def toy_examples(
    n: int,
    *,
    image_size: int = 32,
    classes: int = 10,
    seed: int = 0,
    waves: int = 2,
    noise: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Return ``(images uint8 (n,S,S,3), labels int32 (n,))``, deterministic
    in all arguments. Generate one array and slice train/val from it (as
    :func:`write_toy_shards` does) so the splits share a class bank without
    sharing samples."""
    bank_rng = np.random.default_rng(seed ^ 0xC1A55)
    fx, fy, amp, phase = _class_bank(classes, waves, bank_rng)

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    grid = np.arange(image_size, dtype=np.float64) * (2 * np.pi / image_size)
    gx = grid[None, :, None]  # broadcast over (y, x)
    gy = grid[None, None, :]

    # nuisances, drawn per sample
    shift = rng.uniform(0, 2 * np.pi, size=(n, 2))
    gain = rng.uniform(0.6, 1.4, size=(n, 3))
    bias = rng.uniform(-0.25, 0.25, size=(n, 3))
    contrast = rng.uniform(0.7, 1.3, size=(n,))
    eps = rng.normal(0, noise, size=(n, image_size, image_size, 3))

    images = np.empty((n, image_size, image_size, 3), np.uint8)
    for i in range(n):
        k = labels[i]
        field = np.zeros((1, image_size, image_size))
        for w in range(waves):
            field = field + amp[k, w] * np.sin(
                fx[k, w] * (gy + shift[i, 0])
                + fy[k, w] * (gx + shift[i, 1])
                + phase[k, w]
            )
        field = field[0] / np.sqrt(waves)  # (S, S), roughly unit scale
        x = contrast[i] * field[..., None] * gain[i] + bias[i]
        x = x + eps[i]
        images[i] = np.clip((x + 2.0) * (255.0 / 4.0), 0, 255).astype(np.uint8)
    return images, labels


def write_toy_shards(
    root,
    *,
    n_train: int = 2048,
    n_val: int = 512,
    shard_size: int = 512,
    image_size: int = 32,
    classes: int = 10,
    seed: int = 0,
) -> dict:
    """Materialize train/val tar shards (PNG payloads — lossless, the class
    signal is low-frequency but the probe margin shouldn't ride on JPEG
    behavior). Returns the brace-pattern URLs for DataConfig."""
    from pathlib import Path

    from PIL import Image

    from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    images, labels = toy_examples(
        n_train + n_val, image_size=image_size, classes=classes, seed=seed
    )

    def encode(idx: int) -> dict:
        buf = io.BytesIO()
        Image.fromarray(images[idx], "RGB").save(buf, format="PNG")
        return {
            "__key__": f"toy{idx:06d}",
            "png": buf.getvalue(),
            "cls": str(int(labels[idx])).encode(),
        }

    def write_split(name: str, lo: int, hi: int) -> str:
        count = hi - lo
        n_shards = max(1, -(-count // shard_size))
        for s in range(n_shards):
            a = lo + s * shard_size
            b = min(lo + (s + 1) * shard_size, hi)
            write_tar_samples(
                str(root / f"{name}-{s:04d}.tar"),
                [encode(i) for i in range(a, b)],
            )
        return f"{root}/{name}-{{0000..{n_shards - 1:04d}}}.tar"

    return {
        "train": write_split("train", 0, n_train),
        "val": write_split("val", n_train, n_train + n_val),
        "classes": classes,
    }


def toy_pretrain_hparams(
    steps: int,
    *,
    dec_heads: int = 4,
    seed: int = 0,
    nu_dtype: str | None = None,
) -> list[str]:
    """CLI ``--set`` list for the canonical toy MAE pretrain — the
    learning proof's operating point (600 steps, t16 @32px/4px patches,
    2×64×4h decoder, lr 1.5e-3 / b2 0.95 / wd 0.05).

    The JAX package's operating point, copied; ``dec_heads`` /
    ``nu_dtype`` are its convergence-A/B knobs."""
    out = [
        "run.mode=pretrain",
        f"run.seed={seed}",
        f"run.init_seed={seed}",
        f"run.training_steps={steps}",
        "run.train_batch_size=64",
        "run.valid_batch_size=64",
        f"run.eval_interval={steps}",
        "run.log_interval=200",
        "model.overrides={image_size: 32, patch_size: 4, layers: 4, "
        "posemb: sincos2d, dtype: float32, mask_ratio: 0.75}",
        "model.dec_layers=2",
        "model.dec_dim=64",
        f"model.dec_heads={dec_heads}",
        "model.dec_dtype=float32",
        "optim.learning_rate=1.5e-3",
        "optim.lr_scaling=none",
        "optim.warmup_steps=40",
        f"optim.training_steps={steps}",
        "optim.b2=0.95",
        "optim.weight_decay=0.05",
    ]
    if nu_dtype:
        out.append(f"optim.nu_dtype={nu_dtype}")
    return out
