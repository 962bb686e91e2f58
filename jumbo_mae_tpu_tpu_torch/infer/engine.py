"""The batched inference engine: restore a recipe's save once, serve
bucket-padded forwards.

Counterpart of ``jumbo_mae_tpu_tpu/infer/engine.py`` without the
token-packed path, the warm cache, the metrics and the publisher (ROADMAP
A5, A7). The contracts kept from the JAX engine:

- **Restore once.** ``ckpt`` is read a single time per process through
  :func:`~jumbo_mae_tpu_tpu_torch.train.checkpoint.restore_inference_state`
  (memory-mapped: the optimizer's bytes are never read), then grafted
  onto each task's model with the warm start's overlap rules
  (``merge_pretrained_params``): a matching shape loads, a positional
  grid of another size is resized, another shape (a head for another
  label count) keeps the fresh init from ``run.init_seed``, and a merge
  that loads nothing is refused (``require_loaded``). ``features`` and
  ``logits`` take the save's encoder (``encoder.*`` of an MAE save,
  ``model.*`` of a classifier, else the whole tree); ``reconstruct``
  takes the whole tree. A linear probe's BatchNorm statistics reach the
  ``logits`` head. Tasks are built lazily, once each.
- **Buckets.** A request pads up to a power-of-two bucket capped at
  ``max_batch`` (``infer/bucketing.py``); larger requests are chunked.
- **Padding is inert.** Every op is row-independent in eval mode
  (per-token norms, attention within a sample, stored BatchNorm
  statistics, the per-sample reconstruction gather, the per-weight int8
  dequantization), so a pad row cannot change a valid row; valid rows
  are sliced on the host and callers never see padding.
- **Outputs are float32** numpy arrays, whatever the compute dtype.
- **First runs.** The JAX engine compiles one executable per (task,
  bucket); here a "compile" is the first run of a (task, bucket), counted
  in ``compile_counts``. That first run builds the kernels the task
  launches (``nvcc`` and the library load, at first use), so after
  :meth:`InferenceEngine.warmup` a request never waits on a build.
- **Hot swap.** :meth:`InferenceEngine.swap_weights` builds new task
  models aside and swaps the task dict under the lock: a request serves
  entirely old or entirely new weights, and live parameters are never
  written in place. :meth:`InferenceEngine.restore_snapshot` rolls back.
- **int8.** ``quant="int8"`` quantizes each task's matmul weights after
  the graft (``infer/quant.py``): the card holds int8 and dequantizes on
  use.
- **Reconstruction.** ``reconstruct`` returns the MAE prediction and mask
  (``models/mae.py``'s ``mae_encode`` then ``mae_decode`` in one
  dispatch). With ``encoder_cache=N`` the encoder's outputs (tokens at
  the decoder width, mask, ``ids_restore``) are kept on the host in an
  N-entry LRU keyed by (image bytes, seed), optionally bounded in bytes
  too; repeats pay only the decoder.

The shared-mode mask of ``reconstruct`` comes from
:func:`reconstruct_noise`: host noise from ``torch.Generator("cpu")``
seeded with ``seed``, so the card and the CPU mask alike. The JAX engine
draws from ``jax.random.key(seed)``, which torch cannot reproduce: one
seed gives another mask in the two packages.

The label count of ``logits`` is ``labels=``, else the recipe's
``model.overrides.labels``, else, for a finetune or linear recipe, the
preset's (1000), the count the trainer built its head with. (The JAX
engine reads the overrides only, and so has no logits for
``recipes/finetune_vit_b16.yaml`` without ``labels=``.)

All public methods are thread-safe; ``torch.inference_mode`` is entered
per dispatch, on the dispatching thread. Entry points run on ``"cuda"``
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.config import TrainConfig
from jumbo_mae_tpu_tpu_torch.infer.bucketing import OversizedBatchError, bucket_for, pow2_rungs
from jumbo_mae_tpu_tpu_torch.infer.quant import quantize_module
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT, pool_tokens
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.train.checkpoint import (
    ENCODER_KEYS,
    merge_pretrained_params,
    require_loaded,
    restore_inference_state,
)
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

POOLS = ("cls", "gap", "tokens")


class ResolutionMismatchError(ValueError):
    """Input resolution differs from the engine's native square size.
    ``expected`` is that size; ``got`` the offending (H, W)."""

    def __init__(self, expected: int, got: tuple[int, int]):
        self.expected = int(expected)
        self.got = (int(got[0]), int(got[1]))
        super().__init__(f"engine serves {expected}px inputs, got {got[0]}x{got[1]} — resize upstream")


def reconstruct_noise(seed: int, num_patches: int) -> torch.Tensor:
    """The shared-mode mask noise of a reconstruction: ``(num_patches,)``
    uniform float32 from ``torch.Generator("cpu").manual_seed(seed)``,
    drawn on the host so every device masks alike."""
    gen = torch.Generator("cpu").manual_seed(int(seed))
    return torch.rand((num_patches,), generator=gen, dtype=torch.float32)


def _subtree(tree: dict, key: str | None) -> dict:
    """The entries of ``tree`` under ``key.``, the prefix dropped (the
    whole tree for ``None``)."""
    if key is None:
        return tree
    p = key + "."
    return {n[len(p):]: v for n, v in tree.items() if n.startswith(p)}


def _encoder_key(tree: dict) -> str | None:
    return next((k for k in ENCODER_KEYS if any(n.startswith(k + ".") for n in tree)), None)


def _fetch(out, n: int, numpy: bool = True):
    """The first ``n`` rows of every output on the host, as numpy arrays or
    (the cached encoder's rows: bf16 has no numpy dtype) torch tensors."""
    def one(a: torch.Tensor):
        a = a[:n].cpu()
        return a.numpy() if numpy else a

    return {k: one(v) for k, v in out.items()} if isinstance(out, dict) else one(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class InferenceEngine:
    """Restore a recipe's checkpoint once; serve bucket-batched forwards.

    ``cfg`` is the recipe (:class:`~jumbo_mae_tpu_tpu_torch.config.TrainConfig`)
    whose model section defines the encoder and decoder; ``ckpt`` a port
    save (omit it for the random init from ``run.init_seed``). ``dtype``
    overrides the compute dtype (default: the recipe's; ``"float32"`` is
    the exact path). ``labels`` and ``batch_norm`` (default: ``run.mode ==
    "linear"``) shape the ``logits`` head. ``quant="int8"`` serves the
    weight-only quantized forward. ``encoder_cache`` /
    ``encoder_cache_bytes`` bound the reconstruction encoder's LRU
    (shared mask mode only)."""

    def __init__(
        self,
        cfg: TrainConfig,
        *,
        ckpt: str = "",
        dtype: str | None = None,
        max_batch: int = 64,
        labels: int | None = None,
        batch_norm: bool | None = None,
        quant: str | None = None,
        encoder_cache: int = 0,
        encoder_cache_bytes: int = 0,
        device: str | torch.device = "cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        m = cfg.model
        overrides = dict(m.overrides)
        if dtype is not None:
            overrides["dtype"] = dtype
        # serving is deterministic: the stochastic knobs are forced off
        # last, so a recipe's overrides cannot turn them back on
        self._enc = preset(
            m.preset,
            **{**overrides, "labels": None, "mask_ratio": None, "dropout": 0.0, "droppath": 0.0, "grad_ckpt": False},
        )
        if labels is None:
            labels = overrides.get("labels", None if cfg.run.mode == "pretrain" else preset(m.preset).labels)
        self._labels = labels
        self._batch_norm = batch_norm if batch_norm is not None else cfg.run.mode == "linear"
        self._dec = DecoderConfig(**{
            "layers": m.dec_layers,
            "dim": m.dec_dim,
            "heads": m.dec_heads,
            "dtype": m.dec_overrides.get("dtype", m.dec_dtype) if dtype is None else dtype,
            **{k: v for k, v in m.dec_overrides.items() if k not in ("dtype", "dropout", "droppath")},
        })
        self.image_size = self._enc.image_size

        self._ckpt = str(ckpt)
        self._ckpt_tree: dict | None = None
        self._ckpt_stats: dict | None = None
        self.restore_s = 0.0  # seconds and bytes of the one restore
        self.restore_bytes = 0
        if self._ckpt:
            t0 = time.perf_counter()
            self._ckpt_tree, self._ckpt_stats = restore_inference_state(self._ckpt)
            self.restore_s = time.perf_counter() - t0
            self.restore_bytes = sum(_nbytes(t) for d in (self._ckpt_tree, self._ckpt_stats or {}) for t in d.values())

        self.quant = quant
        if encoder_cache and self._enc.mask_mode != "shared":
            # a per-sample mask depends on the row's place in the batch, so
            # a cached encoder output would change results across batches
            raise ValueError(
                "encoder_cache requires mask_mode='shared' (per-sample masks are batch-position-dependent and "
                "cannot be cached per image)"
            )
        self._enc_cache_size = int(encoder_cache)
        self._enc_cache_bytes_cap = int(encoder_cache_bytes)
        self._enc_cache_nbytes = 0
        self._enc_cache: OrderedDict[str, tuple] = OrderedDict()
        self._enc_cache_lock = threading.Lock()
        self.encoder_cache_hits = 0
        self.encoder_cache_misses = 0

        self.load_stats: dict[str, dict] = {}
        self.quant_reports: dict[str, dict] = {}  # task -> quantize_module's report
        # task -> seconds of its last build: the model, the graft (where
        # the memory-mapped save is read) and the quantization
        self.build_s: dict[str, float] = {}
        self._tasks: dict[str, dict] = {}  # task -> {"model"}
        self.compile_counts: dict[tuple[str, int], int] = {}
        self.dispatches = 0  # device calls made, one per padded bucket
        self.warmup_s = 0.0
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._key_locks: dict[tuple[str, int], threading.Lock] = {}
        self._tls = threading.local()

    # ---------------------------------------------------------------- tasks

    def _grafted(self, task: str, make, *, whole: bool) -> torch.nn.Module:
        """``make(init_weights)``'s model with the restored tree merged onto
        it, in place (the model is new and not yet served). ``whole``
        merges the full tree (reconstruct needs the decoder); otherwise the
        save's encoder lands on the model. The random init is drawn only
        when something keeps it (a fresh or mismatched parameter): a save
        that covers every parameter skips the draws, with the same
        result."""
        tree = self._ckpt_tree
        if tree is None:
            return make(True)
        src = tree if whole else _subtree(tree, _encoder_key(tree))
        model = make(False)
        init = dict(model.named_parameters())
        stats: dict = {}
        merged = merge_pretrained_params(src, init, stats=stats)
        require_loaded(stats, self._ckpt, f"the {task} serving model")
        if stats["new"] or stats["skipped"]:  # these keep the init: draw it
            model = make(True)
            init = dict(model.named_parameters())
            merged = merge_pretrained_params(src, init, verbose=False)
        self.load_stats[task] = stats
        with torch.no_grad():
            for name, p in init.items():
                if merged[name] is not p:
                    p.copy_(merged[name])
        return model

    def _load_batch_stats(self, model: JumboViT) -> None:
        """The save's BatchNorm statistics into the ``logits`` head (a
        classifier save keeps them under ``model.``)."""
        saved = self._ckpt_stats
        if model.head.bn is None or saved is None:
            return
        saved = _subtree(saved, "model") if any(n.startswith("model.") for n in saved) else saved
        bn = model.head.bn
        with torch.no_grad():
            for name in ("running_mean", "running_var"):
                key = f"head.bn.{name}"
                if key not in saved or saved[key].shape != getattr(bn, name).shape:
                    raise KeyError(f"the checkpoint's batch statistics have no {key} of shape "
                                   f"{tuple(getattr(bn, name).shape)} (it has {sorted(saved)})")
                getattr(bn, name).copy_(saved[key])

    def _build_task(self, task: str) -> dict:
        t0 = time.perf_counter()
        kw = dict(device=self.device, seed=self.cfg.run.init_seed)
        if task == "features":
            model = self._grafted(task, lambda init: JumboViT(self._enc, init_weights=init, **kw), whole=False)
        elif task == "logits":
            if not self._labels:
                raise ValueError(
                    "the logits task needs a label count — set model.overrides.labels in the recipe or pass labels="
                )
            enc = self._enc.replace(labels=int(self._labels), batch_norm=self._batch_norm)
            model = self._grafted(task, lambda init: JumboViT(enc, init_weights=init, **kw), whole=False)
            self._load_batch_stats(model)
        elif task == "reconstruct":
            enc = self._enc.replace(mask_ratio=self.cfg.model.overrides.get("mask_ratio", 0.75))
            model = self._grafted(task, lambda init: MAEPretrainModel(
                enc, self._dec, self.cfg.model.norm_pix_loss, init_weights=init, **kw), whole=True)
        else:
            raise ValueError(f"unknown task {task!r}")
        model.eval().requires_grad_(False)
        if self.quant == "int8":
            # after the graft, so the int8 weights are the save's
            self.quant_reports[task] = quantize_module(model)
        self.build_s[task] = time.perf_counter() - t0
        return {"model": model}

    def _task(self, task: str) -> dict:
        t = self._tasks.get(task)
        if t is None:
            with self._lock:
                t = self._tasks.get(task)
                if t is None:
                    t = self._tasks[task] = self._build_task(task)
        return t

    def model(self, task: str) -> torch.nn.Module:
        """The live model of ``task`` (built on first use)."""
        return self._task(task)["model"]

    # ------------------------------------------------------------ hot swap

    def swap_weights(self, params: dict, batch_stats: dict | None = None, *, ckpt: str = "") -> dict:
        """Serve a new tree (``state_dict`` names → tensors, as
        :func:`restore_inference_state` returns it): every built task is
        rebuilt aside (fresh init, graft, quantization) and swapped in
        under the lock, so each request serves entirely old or entirely
        new weights. Returns a snapshot of the previous weights for
        :meth:`restore_snapshot`; raises, leaving the old weights live,
        when the tree does not graft."""
        tree = {n: torch.as_tensor(v) for n, v in params.items()}
        stats = None if batch_stats is None else {n: torch.as_tensor(v) for n, v in batch_stats.items()}
        with self._lock:
            snap = {"ckpt": self._ckpt, "tree": self._ckpt_tree, "stats": self._ckpt_stats,
                    "tasks": dict(self._tasks), "load_stats": dict(self.load_stats)}
            built = sorted(self._tasks)
            self._ckpt, self._ckpt_tree, self._ckpt_stats = str(ckpt), tree, stats
        try:
            rebuilt = {task: self._build_task(task) for task in built}
        except BaseException:
            with self._lock:
                self._ckpt, self._ckpt_tree, self._ckpt_stats = snap["ckpt"], snap["tree"], snap["stats"]
                self.load_stats = snap["load_stats"]
            raise
        with self._lock:
            self._tasks.update(rebuilt)
        self._clear_encoder_cache()  # cached encoder outputs are weight-dependent
        return snap

    def restore_snapshot(self, snap: dict) -> None:
        """Reinstate a :meth:`swap_weights` snapshot (rollback). Tasks first
        built after the swap are dropped, to rebuild from the restored
        tree."""
        with self._lock:
            self._ckpt, self._ckpt_tree, self._ckpt_stats = snap["ckpt"], snap["tree"], snap["stats"]
            self.load_stats = dict(snap["load_stats"])
            for task in list(self._tasks):
                if task in snap["tasks"]:
                    self._tasks[task] = snap["tasks"][task]
                else:
                    del self._tasks[task]
        self._clear_encoder_cache()

    def _clear_encoder_cache(self) -> None:
        with self._enc_cache_lock:
            self._enc_cache.clear()
            self._enc_cache_nbytes = 0

    # ------------------------------------------------------------ dispatch

    @staticmethod
    def _task_key(task: str, pool: str | None) -> str:
        return f"{task}:{pool}" if pool else task

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _forward(self, task: str, pool: str | None, model, args):
        """One padded bucket through ``task``'s model, on the device."""
        if task in ("features", "logits"):
            (images,) = args
            x = normalize_images(self._upload(images), dtype=self._enc.compute_dtype)
            if task == "logits":
                return model(x).float()
            tokens = model.encode(x)
            out = tokens if pool == "tokens" else pool_tokens(tokens, self._enc.num_cls_tokens, pool)
            return out.float()
        if task == "reconstruct.dec":
            tokens, mask, ids = args
            pred = model.mae_decode(self._upload(tokens), self._upload(ids).long())
            return {"reconstruction": pred.float(), "mask": mask}
        images, seed = args
        noise = reconstruct_noise(seed, model.encoder_cfg.num_patches)
        tokens, mask, ids = model.mae_encode(self._upload(images), mask_noise=noise)
        if task == "reconstruct":
            return {"reconstruction": model.mae_decode(tokens, ids).float(), "mask": mask.float()}
        # reconstruct.enc: shared mode's one permutation, materialized per
        # row so a cached row is self-contained
        ids = ids.expand(images.shape[0], -1) if ids.dim() == 1 else ids
        return {"tokens": tokens, "mask": mask.float(), "ids": ids.int()}

    def _execute(self, task: str, pool: str | None, args, n: int):
        """Run and fetch one bucket; returns ``(rows, compute_s, fetch_s)``."""
        model = self._task(task.split(".", 1)[0])["model"]
        with self._count_lock:
            self.dispatches += 1
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = self._forward(task, pool, model, args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            out = _fetch(out, n, numpy=task != "reconstruct.enc")
        return out, t1 - t0, time.perf_counter() - t1

    def _compile_lock(self, key: tuple[str, int]) -> threading.Lock:
        with self._lock:
            return self._key_locks.setdefault(key, threading.Lock())

    def _dispatch(self, task: str, pool: str | None, bucket: int, args, n: int):
        """One padded bucket; the first run of a (task, bucket) holds its
        lock and counts in ``compile_counts``."""
        key = (self._task_key(task, pool), bucket)
        if key not in self.compile_counts:
            self._task(task.split(".", 1)[0])  # built outside the key lock
            with self._compile_lock(key):
                if key not in self.compile_counts:
                    res = self._execute(task, pool, args, n)
                    self.compile_counts[key] = 1
                    return res
        return self._execute(task, pool, args, n)

    def dispatch(self, task: str, images, *, pool: str | None = None) -> np.ndarray:
        """Run one already-padded bucket of ``features`` or ``logits``
        (uint8 NHWC, len <= max_batch) and return every row."""
        images = np.asarray(images)
        return self._dispatch(task, pool, images.shape[0], (images,), images.shape[0])[0]

    def _record(self, bucket: int, n: int, compute_s: float, fetch_s: float) -> None:
        bd = self._tls.bd
        bd["compute_s"] += compute_s
        bd["fetch_s"] += fetch_s
        bd["bucket"] = max(bd["bucket"], bucket)
        bd["pad_rows"] += bucket - n
        bd["bucket_rows"] += bucket

    @staticmethod
    def _pad_rows(arr, bucket: int):
        n = arr.shape[0]
        if n == bucket:
            return arr
        if isinstance(arr, torch.Tensor):
            return torch.cat([arr, arr.new_zeros((bucket - n, *arr.shape[1:]))])
        return np.concatenate([arr, np.zeros((bucket - n, *arr.shape[1:]), arr.dtype)])

    def _run(self, task: str, pool: str | None, rows: tuple, extra: tuple = ()):
        """Bucket-pad one chunk (len <= max_batch), run, slice."""
        n = rows[0].shape[0]
        bucket = bucket_for(n, self.max_batch)
        args = tuple(self._pad_rows(a, bucket) for a in rows) + extra
        out, compute_s, fetch_s = self._dispatch(task, pool, bucket, args, n)
        self._record(bucket, n, compute_s, fetch_s)
        return out

    def _chunks(self, task: str, pool: str | None, rows: tuple, extra: tuple = ()):
        n = rows[0].shape[0]
        parts = [
            self._run(task, pool, tuple(a[i : i + self.max_batch] for a in rows), extra)
            for i in range(0, n, self.max_batch)
        ]
        if len(parts) == 1:
            return parts[0]
        cat = lambda xs: torch.cat(xs) if isinstance(xs[0], torch.Tensor) else np.concatenate(xs)  # noqa: E731
        return {k: cat([p[k] for p in parts]) for k in parts[0]} if isinstance(parts[0], dict) else cat(parts)

    def last_breakdown(self) -> dict | None:
        """The compute/fetch/bucket/pad breakdown of the most recent predict
        on the calling thread (``None`` before any)."""
        bd = getattr(self._tls, "bd", None)
        if bd is None:
            return None
        rows = bd["bucket_rows"]
        return {
            "compute_s": bd["compute_s"],
            "fetch_s": bd["fetch_s"],
            "bucket": bd["bucket"],
            "pad_fraction": (bd["pad_rows"] / rows) if rows else 0.0,
        }

    def _reset_breakdown(self) -> None:
        self._tls.bd = {"compute_s": 0.0, "fetch_s": 0.0, "bucket": 0, "pad_rows": 0, "bucket_rows": 0}

    def _check_images(self, images) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (n, H, W, 3) uint8 images, got {images.shape}")
        if images.shape[1] != self.image_size or images.shape[2] != self.image_size:
            raise ResolutionMismatchError(self.image_size, (images.shape[1], images.shape[2]))
        return images.astype(np.uint8, copy=False)

    # -------------------------------------------------------------- warmup

    def warmup(
        self,
        tasks: tuple[str, ...] = ("features",),
        *,
        pool: str = "cls",
        buckets: tuple[int, ...] | None = None,
        workers: int | None = None,
    ) -> int:
        """Run every (task, bucket) the workload will hit once, on zeros, so
        no request pays a first run: that first run builds the kernels the
        task launches (``nvcc`` and the library load happen at first use).
        Default buckets: :func:`pow2_rungs` of ``max_batch``. Returns the
        number of first runs made; ``warmup_s`` is the ladder's seconds.
        The ladder runs on ``workers`` threads (default up to 4); each
        (task, bucket) runs first exactly once."""
        if buckets is None:
            buckets = pow2_rungs(self.max_batch)
        else:
            bad = [b for b in buckets if b > self.max_batch]
            if bad:
                raise OversizedBatchError(f"warmup buckets {bad} exceed max_batch={self.max_batch}")
        jobs = []
        for task in tasks:
            p = pool if task == "features" else None
            execs = ("reconstruct.enc", "reconstruct.dec") if task == "reconstruct" and self._enc_cache_size else (task,)
            jobs.extend((name, p, b) for name in execs for b in buckets)
        before = sum(self.compile_counts.values())
        t0 = time.perf_counter()
        workers = min(4, len(jobs)) if workers is None else workers
        if workers > 1 and len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="warmup") as px:
                list(px.map(lambda j: self._warm(*j), jobs))
        else:
            for j in jobs:
                self._warm(*j)
        self.warmup_s = time.perf_counter() - t0
        return sum(self.compile_counts.values()) - before

    def _warm(self, task: str, pool: str | None, bucket: int) -> None:
        size = self.image_size
        images = np.zeros((bucket, size, size, 3), np.uint8)
        if task in ("features", "logits"):
            args: tuple = (images,)
        elif task == "reconstruct.dec":
            enc = self.model("reconstruct").encoder_cfg
            seq = enc.num_cls_tokens + enc.keep_len
            args = (torch.zeros((bucket, seq, self._dec.dim), dtype=self._dec.compute_dtype),
                    torch.zeros((bucket, enc.num_patches)), torch.zeros((bucket, enc.num_patches), dtype=torch.int32))
        else:
            args = (images, 0)
        self._dispatch(task, pool, bucket, args, bucket)

    # -------------------------------------------------------------- predict

    def _predict(self, task: str, images, *, pool: str | None = None, extra: tuple = ()):
        self._reset_breakdown()
        return self._chunks(task, pool, (self._check_images(images),), extra)

    def features(self, images, *, pool: str = "cls") -> np.ndarray:
        """Pooled (or full-token) float32 encoder features, one row per image."""
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        return self._predict("features", images, pool=pool)

    def logits(self, images) -> np.ndarray:
        """Float32 classification logits through the head."""
        return self._predict("logits", images)

    def reconstruct(self, images, *, seed: int = 0) -> dict[str, np.ndarray]:
        """MAE reconstruction: ``{"reconstruction": (n, N, p·p·3), "mask":
        (n, N)}`` in (possibly norm-pix) patch space, the mask from
        :func:`reconstruct_noise` of ``seed``. With ``encoder_cache`` the
        encoder runs once per distinct (image, seed)."""
        if self._enc_cache_size > 0:
            return self._reconstruct_cached(images, int(seed))
        return self._predict("reconstruct", images, extra=(int(seed),))

    def predict(self, images, task: str = "features", **kw):
        if task == "features":
            return self.features(images, **kw)
        if task == "logits":
            return self.logits(images, **kw)
        if task == "reconstruct":
            return self.reconstruct(images, **kw)
        raise ValueError(f"unknown task {task!r}")

    # ---------------------------------------------------- encoder cache

    @staticmethod
    def _row_nbytes(row: tuple) -> int:
        """Payload bytes of one cached (tokens, mask, ids) row."""
        return sum(_nbytes(a) for a in row)

    def encoder_cache_stats(self) -> dict:
        with self._enc_cache_lock:
            size, nbytes = len(self._enc_cache), self._enc_cache_nbytes
        return {
            "capacity": self._enc_cache_size,
            "capacity_bytes": self._enc_cache_bytes_cap,
            "size": size,
            "bytes": nbytes,
            "hits": self.encoder_cache_hits,
            "misses": self.encoder_cache_misses,
        }

    def encoder_cache_bytes(self) -> int:
        """Resident payload bytes of the encoder-output LRU."""
        with self._enc_cache_lock:
            return self._enc_cache_nbytes

    def _reconstruct_cached(self, images, seed: int) -> dict[str, np.ndarray]:
        """Encoder once, decoder per request. The key is the image bytes and
        the seed; the shared-mode mask depends on nothing else, so a cached
        row equals a recomputed one: the cache skips work and never changes
        a result. Duplicates within a request encode once."""
        self._reset_breakdown()
        images = self._check_images(images)
        n = images.shape[0]
        keys = [hashlib.sha1(images[i].tobytes()).hexdigest() + f":{seed}" for i in range(n)]
        rows: list[tuple | None] = [None] * n
        miss_idx: dict[str, list[int]] = {}
        with self._enc_cache_lock:
            for i, k in enumerate(keys):
                hit = self._enc_cache.get(k)
                if hit is not None:
                    self._enc_cache.move_to_end(k)
                    rows[i] = hit
                else:
                    miss_idx.setdefault(k, []).append(i)
        hits = n - sum(len(v) for v in miss_idx.values())
        with self._enc_cache_lock:
            self.encoder_cache_hits += hits
            self.encoder_cache_misses += len(miss_idx)
        if miss_idx:
            miss_images = np.stack([images[idxs[0]] for idxs in miss_idx.values()])
            enc = self._chunks("reconstruct.enc", None, (miss_images,), (seed,))
            with self._enc_cache_lock:
                for j, (k, idxs) in enumerate(miss_idx.items()):
                    row = (enc["tokens"][j].clone(), enc["mask"][j].clone(), enc["ids"][j].clone())
                    for i in idxs:
                        rows[i] = row
                    if k not in self._enc_cache:
                        self._enc_cache_nbytes += self._row_nbytes(row)
                    self._enc_cache[k] = row
                    self._enc_cache.move_to_end(k)
                # the entry bound and, when set, the byte bound: whichever
                # trips first evicts the least recently used row
                while self._enc_cache and (
                    len(self._enc_cache) > self._enc_cache_size
                    or (self._enc_cache_bytes_cap > 0 and self._enc_cache_nbytes > self._enc_cache_bytes_cap)
                ):
                    _, old = self._enc_cache.popitem(last=False)
                    self._enc_cache_nbytes -= self._row_nbytes(old)
        tokens, mask, ids = (torch.stack([r[j] for r in rows]) for j in range(3))
        return self._chunks("reconstruct.dec", None, (tokens, mask, ids))

    # ------------------------------------------------------------- packing

    def seq_len(self, size: int) -> int:
        """Token count of one request at a square resolution:
        ``num_cls_tokens + (size/patch)²``. Raises on sizes that are not a
        positive multiple of the patch size."""
        p = self._enc.patch_size
        size = int(size)
        if size < p or size % p:
            raise ValueError(
                f"image size {size} is not a positive multiple of patch_size={p} — packed serving needs "
                "patch-aligned inputs"
            )
        return self._enc.num_cls_tokens + (size // p) ** 2
