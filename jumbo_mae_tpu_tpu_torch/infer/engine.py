"""The batched inference engine: bucket-padded forwards on one device.

Counterpart of ``jumbo_mae_tpu_tpu/infer/engine.py`` for the ``features``
and ``logits`` tasks. The contracts kept from the JAX engine:

- **Buckets.** A request pads up to a power-of-two bucket capped at
  ``max_batch`` (``infer/bucketing.py``); larger requests are chunked.
  The model sees log2(max_batch)+1 batch shapes, not one per request.
- **Padding is inert.** Every op is row-independent in eval mode
  (per-token norms, attention within a sample, stored BatchNorm
  statistics), so a pad row cannot change a valid row; the engine slices
  the valid rows on the host and callers never see padding.
- **Outputs are float32** numpy arrays, whatever the compute dtype.
- ``dtype`` overrides the compute dtype (default: the config's, bf16 on
  the card; ``"float32"`` is the exact path); ``init_seed`` seeds the
  random init when no weights are given.

Weights arrive as a flax params tree of numpy arrays (``params`` /
``batch_stats``, through ``interop/from_jax.py``) or are drawn from
``init_seed``. Reading checkpoints, int8, packing, reconstruction, the
warm cache and metrics are later slices (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.infer.bucketing import bucket_for
from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_jax
from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig
from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT, pool_tokens
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

POOLS = ("cls", "gap", "tokens")


class ResolutionMismatchError(ValueError):
    """Input resolution differs from the engine's native square size.
    ``expected`` is that size; ``got`` the offending (H, W)."""

    def __init__(self, expected: int, got: tuple[int, int]):
        self.expected = int(expected)
        self.got = (int(got[0]), int(got[1]))
        super().__init__(
            f"engine serves {expected}px inputs, got {got[0]}x{got[1]} — "
            f"resize upstream"
        )


class InferenceEngine:
    """Build the model once; serve bucket-padded forwards.

    ``cfg`` is the encoder config. ``labels`` (default: ``cfg.labels``)
    gives the model its head, which the ``logits`` task needs;
    ``batch_norm`` adds the linear-probe BatchNorm to it. ``params`` /
    ``batch_stats`` are a flax ``JumboViT`` tree as numpy arrays; without
    them the weights are a random init from ``init_seed``. Serving is
    deterministic: dropout, droppath and MAE masking are forced off.
    """

    def __init__(
        self,
        cfg: JumboViTConfig,
        *,
        labels: int | None = None,
        batch_norm: bool = False,
        params: dict | None = None,
        batch_stats: dict | None = None,
        dtype: str | None = None,
        max_batch: int = 64,
        init_seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        labels = cfg.labels if labels is None else labels
        overrides = dict(
            labels=labels or None,
            batch_norm=bool(batch_norm) and bool(labels),
            mask_ratio=None,
            dropout=0.0,
            droppath=0.0,
            grad_ckpt=False,
        )
        if dtype is not None:
            overrides["dtype"] = dtype
        self.cfg = cfg.replace(**overrides)
        self.image_size = self.cfg.image_size
        self.dispatches = 0  # device calls made, one per padded bucket
        self.model = JumboViT(self.cfg, device=self.device, seed=init_seed)
        if params is not None:
            self._load(params, batch_stats)

    def _load(self, params: dict, batch_stats: dict | None) -> None:
        sd = state_dict_from_jax(params, batch_stats)
        missing, unexpected = self.model.load_state_dict(sd, strict=False)
        # a trunk-only tree (a features checkpoint) may leave the head at
        # its init, as the JAX engine's graft does; anything else must load
        trunk_missing = [k for k in missing if not k.startswith("head.")]
        if unexpected or trunk_missing:
            raise KeyError(
                f"params do not fit this model: missing {trunk_missing}, "
                f"unexpected {unexpected}"
            )

    def _check_images(self, images) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (n, H, W, 3) uint8 images, got {images.shape}")
        if images.shape[1] != self.image_size or images.shape[2] != self.image_size:
            raise ResolutionMismatchError(self.image_size, (images.shape[1], images.shape[2]))
        return images.astype(np.uint8, copy=False)

    @staticmethod
    def _pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
        n = arr.shape[0]
        if n == bucket:
            return arr
        pad = np.zeros((bucket - n, *arr.shape[1:]), arr.dtype)
        return np.concatenate([arr, pad])

    def _forward(self, task: str, pool: str | None, images: torch.Tensor) -> torch.Tensor:
        x = normalize_images(images, dtype=self.cfg.compute_dtype)
        if task == "logits":
            return self.model(x)
        tokens = self.model.encode(x)
        return tokens if pool == "tokens" else pool_tokens(tokens, self.cfg.num_cls_tokens, pool)

    def dispatch(self, task: str, images: np.ndarray, *, pool: str | None = None) -> np.ndarray:
        """Run one already-padded bucket (uint8 NHWC, len <= max_batch) and
        return every row, float32 on the host. ``predict`` is the padded,
        sliced, chunked entry; this is its one device call."""
        self.dispatches += 1
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
            return self._forward(task, pool, x).float().cpu().numpy()

    def _run(self, task: str, pool: str | None, images: np.ndarray) -> np.ndarray:
        """Bucket-pad one chunk (len <= max_batch), run, slice."""
        n = images.shape[0]
        bucket = bucket_for(n, self.max_batch)
        return self.dispatch(task, self._pad_rows(images, bucket), pool=pool)[:n]

    def _predict(self, task: str, images, *, pool: str | None = None) -> np.ndarray:
        images = self._check_images(images)
        chunks = [
            self._run(task, pool, images[i : i + self.max_batch])
            for i in range(0, images.shape[0], self.max_batch)
        ]
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def features(self, images, *, pool: str = "cls") -> np.ndarray:
        """Pooled (or full-token) float32 encoder features, one row per image."""
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        return self._predict("features", images, pool=pool)

    def logits(self, images) -> np.ndarray:
        """Float32 classification logits through the head."""
        if self.model.head is None:
            raise ValueError("the logits task needs a label count — pass labels=")
        return self._predict("logits", images)

    def predict(self, images, task: str = "features", **kw) -> np.ndarray:
        if task == "features":
            return self.features(images, **kw)
        if task == "logits":
            return self.logits(images, **kw)
        raise ValueError(f"unknown task {task!r}; this engine serves features and logits")
