"""The batched inference engine: restore a recipe's save once, serve
bucket-padded forwards, one CUDA graph per (task, bucket).

Counterpart of ``jumbo_mae_tpu_tpu/infer/engine.py``, with its metrics
(the list at the end). The contracts kept from the JAX engine:

- **Restore once.** ``ckpt`` is resolved to its step directory and read
  a single time, when the engine is built, through
  :func:`~jumbo_mae_tpu_tpu_torch.train.checkpoint.restore_inference_state`
  (memory-mapped: the optimizer's bytes are never read); a save committed
  later is not served. It is grafted onto each task's model, constructed
  on the device, with the warm start's overlap rules
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
- **One executable per (task key, bucket): a captured CUDA graph.** The
  JAX engine compiles one executable per key and counts compiles in
  ``compile_counts``. Here, on ``"cuda"``, the first dispatch of a key
  runs its forward eagerly once on the capture stream (the kernels'
  ``nvcc`` builds, cuBLAS handles and workspaces, the tensor-map entry
  point, the normalization and positional tables all come into being
  there), then captures it into a ``torch.cuda.CUDAGraph`` over static
  input buffers allocated outside the graph. Each capture adds one to
  ``compile_counts[key]`` and calls ``on_compile(task_key, bucket)``.
  Every dispatch, the first included, copies its padded inputs into
  pinned host staging, then into the static buffers, replays the graph
  and fetches. Keys: ``features:<pool>``, ``logits``, ``reconstruct``,
  ``reconstruct.enc``, ``reconstruct.dec``, and the packed path's
  ``<tree>.embed@<res>``, ``<tree>.full:<pool>@<res>`` and
  ``<tree>.packed:<pool>@r<rows>s<smax>`` (bucket: the token budget).
  :meth:`InferenceEngine.warmup` returns the captures it made; after it
  the request path captures nothing. A failed capture raises: the card
  never serves the eager path. On the CPU (``device="cpu"``) the forward
  runs eagerly and a key's first run counts as its "compile".
- **Kernel launches under replay.** K1's wrapper counts launches in
  Python (``ops/flash/attention.py`` ``LAUNCHES*``), and a replay runs no
  Python. Each graph records the counters' growth while it was captured,
  takes it back out (a capture launches nothing on the card), and adds
  it on every replay, so the counters keep counting kernel launches on
  the card. The counters' lock is held over a capture, so a replay of
  another engine on another thread adds its launches after it, not into
  the graph's count.
- **Concurrency.** Static buffers and the graphs' memory are shared
  state: each engine has one memory pool for all its graphs and one
  replay lock. A request holds the lock from its first copy-in to its
  last fetch (every chunk of it), so two threads, two keys or a weight
  copy never overlap on one engine; the device runs one stream, so the
  lock costs the overlap of host copies only. The pool then holds the
  largest graph's intermediates, not their sum. Captures of all engines
  in the process run one at a time (a module lock) in
  ``thread_local`` capture mode, and no dispatch synchronizes the whole
  device, so replicas replay while another engine captures.
- **Warm restarts.** ``warm_cache`` keeps the built state dict of each
  task whose build costs more than a read of the save: one that drew the
  random init (no save, or a parameter the save lacks) or quantized to
  int8. A task that only copies the save's tensors has no entry: reading
  the memory-mapped save is faster than reading an entry of the same
  bytes. The store is ``infer/warmcache.py``: ``True`` (the default)
  resolves the directory through
  :func:`~jumbo_mae_tpu_tpu_torch.infer.warmcache.default_warmcache_dir`
  (``JUMBO_WARMCACHE=0`` turns it off), a path uses that directory
  whatever the environment says, ``False``/``None`` turns it off. A hit
  loads the entry into the model constructed without its init,
  bit-equal to the cold build. ``warm_hits`` counts hits per task, apart
  from the captures in ``compile_counts`` (a graph is never cached: a
  restart still captures its ladder), and
  ``infer_warmcache_saved_seconds_total`` credits the build seconds the
  entry's sidecar says the first process paid. ``build_split[task]``
  gives a build's seconds in parts: ``construct_s`` (on the device, no
  init), ``graft_s`` (the merge), ``draw_s`` (a model built again on the
  host with its random init, where one is drawn), ``to_device_s`` (the
  copy into the model), ``quant_s``; on a hit ``load_s`` (read, verify,
  map) before ``to_device_s``; and ``put_s`` where a miss wrote its
  entry. ``restore_s`` is the engine's one restore.
- **Hot swap, zero captures.** A graph bakes in its parameters'
  addresses, so :meth:`InferenceEngine.swap_weights` builds each built
  task's model aside (fresh init, graft, quantization: a tree that does
  not graft raises there, leaving the old weights live), then, under the
  replay lock, copies the live models' weights to the host as the
  snapshot and copies the new values into the live models' own storage.
  :meth:`InferenceEngine.restore_snapshot` copies the snapshot back under
  the lock, so a rollback serves bit-equal outputs to before the swap.
  ``compile_counts`` stays flat across both; a request sees entirely old
  or entirely new weights, a cached reconstruction included: both clear
  the encoder-output LRU under the same lock.
- **Costs.** Each capture (each first run on the CPU) fills
  ``cost_reports[(task key, bucket)]`` with the graph's
  :class:`~jumbo_mae_tpu_tpu_torch.obs.costmodel.ProgramCost` (analytic
  FLOPs, the weights' bytes plus the activation model, the pool growth as
  its peak) and publishes it (``publish_cost``); the tenant cost meter
  bills each flush by it.
- **int8.** ``quant="int8"`` quantizes each task's matmul weights after
  the graft (``infer/quant.py``): the card holds int8 and dequantizes on
  use.
- **Reconstruction.** ``reconstruct`` returns the MAE prediction and mask
  (``models/mae.py``'s ``mae_encode`` then ``mae_decode`` in one
  dispatch). With ``encoder_cache=N`` the encoder's outputs (tokens at
  the decoder width, mask, ``ids_restore``) are kept on the host in an
  N-entry LRU keyed by (image bytes, seed), optionally bounded in bytes
  too; repeats pay only the decoder.
- **Token-packed serving.** :meth:`InferenceEngine.predict_packed` serves
  square, patch-aligned images of mixed resolutions (non-native ones
  need ``posemb="sincos2d"``) and the encoder-sharing tasks in one
  dispatch: per-resolution patch embedding, a deterministic
  first-fit-decreasing pack into a power-of-two token-budget rung
  (``infer/packing.py``), one packed forward whose attention is masked
  block-diagonally per segment. Masked attention runs on the einsum
  path, as in the JAX package (the kernels take no mask).
  :meth:`InferenceEngine.packed_parity` holds it against the unpacked
  forward at each request's resolution.

The shared-mode mask of ``reconstruct`` comes from
:func:`reconstruct_noise`: host noise from ``torch.Generator("cpu")``
seeded with ``seed``, a static input of the graph, so the card and the
CPU mask alike. The JAX engine draws from ``jax.random.key(seed)``, which
torch cannot reproduce: one seed gives another mask in the two packages.

The label count of ``logits`` is ``labels=``, else the recipe's
``model.overrides.labels``, else, for a finetune or linear recipe, the
preset's (1000), the count the trainer built its head with. (The JAX
engine reads the overrides only, and so has no logits for
``recipes/finetune_vit_b16.yaml`` without ``labels=``.)

**Metrics** (``registry``, default the process registry), the JAX
engine's names and labels: ``infer_predict_seconds{task}`` and
``infer_images_total{task}`` per predict (``packed`` for a token-packed
dispatch), ``infer_bucket_cache_{hits,misses}_total{task}`` per dispatch
(a miss is a capture), ``infer_compile_seconds{task}`` and
``infer_bucket_compile_seconds{task,bucket}`` (a key's eager first run
plus its capture), ``infer_executable_bytes{task,bucket}`` (the pool's
growth at a capture, where it grew), ``infer_pad_fraction`` per chunk,
``infer_warm_start_seconds`` per warmup ladder,
``infer_encoder_cache_{bytes,events_total}``,
``infer_quant_compression{task}``,
``infer_warmcache_saved_seconds_total{task}`` and the packed path's six
``serve_pack_*``. :meth:`InferenceEngine.executable_cache_bytes` and
:meth:`InferenceEngine.predicted_peak_hbm` feed the memory watcher. The
locks are ``obs.lockwatch``'s: ``engine.master``, ``engine.enc_cache``,
and the port's own ``engine.replay`` (reentrant) and ``engine.capture``.

All public methods are thread-safe; ``torch.inference_mode`` is entered
per dispatch, on the dispatching thread. Entry points run on ``"cuda"``
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from jumbo_mae_tpu_tpu_torch.config import TrainConfig
from jumbo_mae_tpu_tpu_torch.infer import packing
from jumbo_mae_tpu_tpu_torch.infer import warmcache as wc
from jumbo_mae_tpu_tpu_torch.infer.bucketing import OversizedBatchError, bucket_for, ceil_pow2, pow2_rungs
from jumbo_mae_tpu_tpu_torch.infer.quant import int8_layout, quantize_module
from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT, pool_tokens
from jumbo_mae_tpu_tpu_torch.obs.costmodel import ProgramCost, program_cost, publish_cost, task_flops, weight_bytes
from jumbo_mae_tpu_tpu_torch.obs import lockwatch
from jumbo_mae_tpu_tpu_torch.obs.metrics import RATIO_BUCKETS, get_registry
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as flash
from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
from jumbo_mae_tpu_tpu_torch.train.checkpoint import (
    ENCODER_KEYS,
    merge_pretrained_params,
    require_loaded,
    resolve_save,
    restore_inference_state,
    save_digest,
)
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

POOLS = ("cls", "gap", "tokens")

# the kernel launch counters of ops/flash/attention.py, kept true under replay
LAUNCH_COUNTERS = ("LAUNCHES", "LAUNCHES_WITH_LSE", "LAUNCHES_BWD_DQ", "LAUNCHES_BWD_DKV")
_COUNTS_LOCK = threading.Lock()
# one capture at a time in the process: a capture's eager first run and
# its capture never overlap another engine's
_CAPTURE_LOCK = lockwatch.lock("engine.capture")


class ResolutionMismatchError(ValueError):
    """Input resolution differs from the engine's native square size.
    Typed so a scheduler or router can send the request to the
    token-packed path, which takes any patch-aligned resolution.
    ``expected`` is that size; ``got`` the offending (H, W)."""

    def __init__(self, expected: int, got: tuple[int, int]):
        self.expected = int(expected)
        self.got = (int(got[0]), int(got[1]))
        super().__init__(
            f"engine serves {expected}px inputs, got {got[0]}x{got[1]} — resize upstream or route to the "
            "token-packed path (predict_packed)"
        )


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


def _launch_counts() -> dict[str, int]:
    return {name: getattr(flash, name) for name in LAUNCH_COUNTERS}


def _add_launches(delta: dict[str, int], sign: int = 1) -> None:
    with _COUNTS_LOCK:
        for name, d in delta.items():
            if d:
                setattr(flash, name, getattr(flash, name) + sign * d)


def _weights(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The tensors a forward reads and a swap replaces: parameters and
    persistent buffers (int8 weights and scales, BatchNorm statistics)."""
    return model.state_dict(keep_vars=True)


@torch.no_grad()
def _copy_weights(live: torch.nn.Module, new: dict[str, torch.Tensor]) -> None:
    """``new``'s values into ``live``'s own storage (the addresses its
    graphs read)."""
    for name, t in _weights(live).items():
        t.copy_(new[name])


class _Graph:
    """One captured (task key, bucket): the graph, its static inputs (and
    their pinned host staging), its outputs, the launch-counter growth
    one replay stands for, the model whose storage it reads, and what it
    cost: the eager first run's and the capture's seconds, and the bytes
    the engine's pool grew by."""

    def __init__(self, graph, pinned, static, outputs, launches, model, first_run_s, capture_s, pool_bytes):
        self.graph = graph
        self.pinned = pinned
        self.static = static
        self.outputs = outputs
        self.launches = launches
        self.model = model
        self.first_run_s = first_run_s
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def run(self, host: tuple[torch.Tensor, ...]):
        """Copy in, replay, wait for the stream. The caller holds the
        engine's replay lock until it has fetched the outputs."""
        for pin, dev, t in zip(self.pinned, self.static, host):
            pin.copy_(t)
            dev.copy_(pin, non_blocking=True)
        self.graph.replay()
        _add_launches(self.launches)
        torch.cuda.current_stream(self.static[0].device).synchronize()
        return self.outputs


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
    (shared mask mode only). ``max_tokens`` tops the packed path's
    token-budget rungs. ``on_compile(task_key, bucket)`` is called at
    every capture (every first run on the CPU). ``warm_cache``: ``True``
    for the default directory, a path, or ``False``/``None`` (off).
    ``registry`` takes the engine's and the warm cache's metrics (default:
    the process registry)."""

    def __init__(
        self,
        cfg: TrainConfig,
        *,
        ckpt: str = "",
        dtype: str | None = None,
        max_batch: int = 64,
        max_tokens: int = 4096,
        labels: int | None = None,
        batch_norm: bool | None = None,
        quant: str | None = None,
        encoder_cache: int = 0,
        encoder_cache_bytes: int = 0,
        on_compile: Callable[[str, int], None] | None = None,
        warm_cache: str | bool | None = True,
        registry=None,
        device: str | torch.device = "cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        # the packed path's rung ceiling (4096 covers 896 px at patch 16)
        self.max_tokens = int(max_tokens)
        self.on_compile = on_compile
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

        reg = registry if registry is not None else get_registry()
        self._registry = reg
        self._m_predict = reg.histogram("infer_predict_seconds", "engine predict() wall time per batched call",
                                        labels=("task",))
        self._m_images = reg.counter("infer_images_total", "images served", labels=("task",))
        self._m_hits = reg.counter("infer_bucket_cache_hits_total", "bucket-executable cache hits", labels=("task",))
        self._m_misses = reg.counter("infer_bucket_cache_misses_total",
                                     "bucket-executable cache misses (each one is a compile)", labels=("task",))
        self._m_compile = reg.histogram("infer_compile_seconds", "AOT lower+compile time per (task, bucket) executable",
                                        labels=("task",))
        self._m_pad = reg.histogram("infer_pad_fraction", "padding rows / bucket size per dispatched chunk",
                                    buckets=RATIO_BUCKETS)
        self._m_warm_start = reg.gauge("infer_warm_start_seconds",
                                       "wall time of the last warmup() ladder (compiles + cache loads)")
        self._m_enc_cache = reg.counter("infer_encoder_cache_events_total", "reconstruction encoder-output LRU events",
                                        labels=("event",))
        self._m_enc_cache_bytes = reg.gauge("infer_encoder_cache_bytes",
                                            "resident bytes of cached encoder-output rows (tokens+mask+ids)")
        self._m_quant = reg.gauge("infer_quant_compression", "params bytes_before / bytes_after per quantized task",
                                  labels=("task",))
        self._m_bucket_compile = reg.gauge("infer_bucket_compile_seconds",
                                           "lower+compile wall time of each (task, bucket) executable",
                                           labels=("task", "bucket"))
        self._m_exec_bytes = reg.gauge("infer_executable_bytes", "serialized executable size per (task, bucket)",
                                       labels=("task", "bucket"))
        self._m_warm_saved = reg.counter(
            "infer_warmcache_saved_seconds_total",
            "task build seconds avoided by warmcache hits (from entry metadata)",
            labels=("task",),
        )
        # the token-packed path (predict_packed, packed_parity)
        self._m_pack_pad = reg.histogram(
            "serve_pack_token_pad_fraction",
            "padding tokens / device tokens per packed dispatch (row bucketing included)", buckets=RATIO_BUCKETS)
        self._m_pack_segments = reg.histogram("serve_pack_segments_per_dispatch",
                                              "request segments packed into one dispatch",
                                              buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._m_pack_occ = reg.histogram("serve_pack_budget_occupancy",
                                         "occupied tokens / (rows x token budget) per packed dispatch",
                                         buckets=RATIO_BUCKETS)
        self._m_pack_dispatches = reg.counter("serve_pack_dispatches_total", "token-packed dispatches served",
                                              labels=("task",))
        self._m_pack_parity = reg.gauge("serve_pack_parity_min",
                                        "min packed-vs-unpacked feature cosine of the last parity gate")
        self._m_pack_parity_fail = reg.counter("serve_pack_parity_failures_total",
                                               "packed-parity gate failures (cosine or top-1 below threshold)")
        if warm_cache is True:
            wc_root = wc.default_warmcache_dir(self.device)
        elif warm_cache:
            wc_root = str(warm_cache)
        else:
            wc_root = None
        self.warmcache = wc.WarmCache(wc_root, registry=reg) if wc_root else None
        # task -> entries loaded instead of built; captures stay counted in
        # compile_counts (a graph is never cached)
        self.warm_hits: dict[str, int] = {}

        # the step directory is resolved once: the digest and the one
        # restore read the same save, whatever is committed later
        self._ckpt = str(resolve_save(ckpt)) if ckpt else ""
        self._ckpt_tree: dict | None = None
        self._ckpt_stats: dict | None = None
        self.restore_s = 0.0  # seconds and bytes of the one restore
        self.restore_bytes = 0
        # what names the weights a task is built from: the save's digest,
        # or the init seed without a save; None (cache bypassed) once a
        # swap serves a tree that no save names
        self._weights_id: str | None = None
        if self.warmcache is not None:
            self._weights_id = save_digest(self._ckpt) if self._ckpt else f"init:{cfg.run.init_seed}"
            self._fingerprint = self._model_fingerprint()
        if self._ckpt:
            self._restore()

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
        self._enc_cache_lock = lockwatch.lock("engine.enc_cache")
        self.encoder_cache_hits = 0
        self.encoder_cache_misses = 0

        self.load_stats: dict[str, dict] = {}
        self.quant_reports: dict[str, dict] = {}  # task -> quantize_module's report
        # task -> seconds of its last build (the model, the graft, where the
        # memory-mapped save is read, and the quantization; or the warm
        # cache's load), and those seconds in parts
        self.build_s: dict[str, float] = {}
        self.build_split: dict[str, dict[str, float]] = {}
        self._tasks: dict[str, dict] = {}  # task -> {"model"}
        self.compile_counts: dict[tuple[str, int], int] = {}
        # (task key, bucket) -> the graph's ProgramCost, set at its capture
        self.cost_reports: dict[tuple[str, int], ProgramCost] = {}
        self._graphs: dict[tuple[str, int], _Graph] = {}
        self._pool = None  # the graphs' shared memory pool, made at the first capture
        self._capture_stream: torch.cuda.Stream | None = None
        self.dispatches = 0  # device calls made, one per padded bucket
        self.warmup_s = 0.0
        self._lock = lockwatch.lock("engine.master")  # the task dict and the restored tree
        self._replay_lock = lockwatch.rlock("engine.replay")  # a request's device work, a weight copy
        self._count_lock = threading.Lock()
        self._tls = threading.local()

    # ---------------------------------------------------------------- tasks

    def _restore(self) -> None:
        """Read the save (memory-mapped) into the engine's tree, once."""
        t0 = time.perf_counter()
        self._ckpt_tree, self._ckpt_stats = restore_inference_state(self._ckpt)
        self.restore_s = time.perf_counter() - t0
        self.restore_bytes = sum(_nbytes(t) for d in (self._ckpt_tree, self._ckpt_stats or {}) for t in d.values())

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

    def _maker(self, task: str):
        """``(make(init_weights), whole)``: how ``task``'s model is built
        and whether the whole tree grafts onto it."""
        kw = dict(device=self.device, seed=self.cfg.run.init_seed)
        if task == "features":
            return (lambda init: JumboViT(self._enc, init_weights=init, **kw)), False
        if task == "logits":
            if not self._labels:
                raise ValueError(
                    "the logits task needs a label count — set model.overrides.labels in the recipe or pass labels="
                )
            enc = self._enc.replace(labels=int(self._labels), batch_norm=self._batch_norm)
            return (lambda init: JumboViT(enc, init_weights=init, **kw)), False
        if task == "reconstruct":
            enc = self._enc.replace(mask_ratio=self.cfg.model.overrides.get("mask_ratio", 0.75))
            return (lambda init: MAEPretrainModel(
                enc, self._dec, self.cfg.model.norm_pix_loss, init_weights=init, **kw)), True
        raise ValueError(f"unknown task {task!r}")

    def _construct(self, make) -> torch.nn.Module:
        """``make(False)``'s model, constructed on the device without the
        random init: every parameter is then filled from the save or an
        entry. PyTorch's construction-time init costs little there beside
        the host's, but it advances the device's generator, which a graph capture on
        another thread refuses: the construction holds the capture lock."""
        with _CAPTURE_LOCK, torch.device(self.device):
            model = make(False)
        self._sync()
        return model

    def _build_task(self, task: str) -> dict:
        """``task``'s serving model: constructed on the device, the save's
        tree merged onto it (``merge_pretrained_params``: a matching shape
        loads, a positional grid of another size is resized, another shape
        keeps the init), BatchNorm statistics into a ``logits`` head, then
        quantized where asked. The random init is drawn (on the host, from
        ``run.init_seed``) only when something keeps it: no save, or a
        fresh or mismatched parameter. With a warm cache, a build that drew
        the init or quantizes first tries its entry, and writes it on a
        miss; a build that only copies the save's tensors has no entry,
        because reading the memory-mapped save and copying it is faster
        than reading an entry of the same bytes. ``build_split[task]`` gets
        the seconds of each part."""
        t0 = time.perf_counter()
        make, whole = self._maker(task)
        split: dict[str, float] = {}
        model = self._construct(make)
        split["construct_s"] = time.perf_counter() - t0
        tree, merged = self._ckpt_tree, None
        if tree is not None:
            t1 = time.perf_counter()
            src = tree if whole else _subtree(tree, _encoder_key(tree))
            stats: dict = {}
            merged = merge_pretrained_params(src, dict(model.named_parameters()), stats=stats)
            require_loaded(stats, self._ckpt, f"the {task} serving model")
            self.load_stats[task] = stats
            split["graft_s"] = time.perf_counter() - t1
        drawn = merged is None or bool(stats["new"] or stats["skipped"])
        name = None
        if self.warmcache is not None and self._weights_id is not None and (drawn or self.quant == "int8"):
            name = self._entry_name(task)
            if self._load_entry(task, model, name, split):
                self.build_s[task] = time.perf_counter() - t0
                self.build_split[task] = split
                return {"model": model}
        if drawn:
            t1 = time.perf_counter()
            model = make(True)
            self._sync()
            split["draw_s"] = time.perf_counter() - t1
            if merged is not None:
                merged = merge_pretrained_params(src, dict(model.named_parameters()), verbose=False)
        if merged is not None:
            t1 = time.perf_counter()
            with torch.no_grad():
                for n, p in model.named_parameters():
                    if merged[n] is not p:
                        p.copy_(merged[n])
            self._sync()
            split["to_device_s"] = time.perf_counter() - t1
        if task == "logits":
            self._load_batch_stats(model)
        model.eval().requires_grad_(False)
        if self.quant == "int8":
            # after the graft, so the int8 weights are the save's
            t1 = time.perf_counter()
            self.quant_reports[task] = quantize_module(model)
            self._m_quant.labels(task).set(self.quant_reports[task]["compression"])
            self._sync()
            split["quant_s"] = time.perf_counter() - t1
        build_s = time.perf_counter() - t0
        if name is not None:
            t1 = time.perf_counter()
            self.warmcache.put(name, _weights(model),
                               meta={"build_seconds": build_s, "quant_report": self.quant_reports.get(task)})
            split["put_s"] = time.perf_counter() - t1
        self.build_s[task] = time.perf_counter() - t0
        self.build_split[task] = split
        return {"model": model}

    def _load_entry(self, task: str, model: torch.nn.Module, name: str, split: dict) -> bool:
        """Fill ``model`` (constructed, not yet served) from ``task``'s warm
        cache entry; False on a miss. An entry whose names, shapes or dtypes
        differ from the model it should fill is quarantined as corrupt."""
        model.eval().requires_grad_(False)
        t0 = time.perf_counter()

        def fits(state: dict) -> None:
            if self.quant == "int8":
                int8_layout(model, state)
            live = _weights(model)
            if set(live) != set(state):
                raise ValueError(f"entry names differ from the model's ({len(state)} against {len(live)})")
            for n, t in live.items():
                if t.shape != state[n].shape or t.dtype != state[n].dtype:
                    raise ValueError(f"entry {n} is {state[n].dtype}{tuple(state[n].shape)}, the model's "
                                     f"{t.dtype}{tuple(t.shape)}")

        state = self.warmcache.get(name, validate=fits)
        if state is None:
            return False
        t1 = time.perf_counter()
        _copy_weights(model, state)
        self._sync()
        split.update(load_s=t1 - t0, to_device_s=time.perf_counter() - t1)
        self.warm_hits[task] = self.warm_hits.get(task, 0) + 1
        meta = self.warmcache.entry_meta(name) or {}
        if meta.get("quant_report"):
            self.quant_reports[task] = meta["quant_report"]
            self._m_quant.labels(task).set(meta["quant_report"]["compression"])
        saved = float(meta.get("build_seconds") or 0.0)
        if saved > 0:
            self._m_warm_saved.labels(task).inc(saved)
        return True

    def _model_fingerprint(self) -> str:
        """Everything a task's built weights depend on besides the task,
        dtype and quant mode (the entry name's): the model's config, the
        init seed (fresh parameters are part of an entry), the weights'
        source (the save's digest) and the device with its torch and CUDA
        versions. The JAX fingerprint has no save and no seed in it: there
        parameters are arguments of the cached executable."""

        def cfg_dict(c):
            return dataclasses.asdict(c) if dataclasses.is_dataclass(c) else str(c)

        return wc.fingerprint(
            {
                "enc": cfg_dict(self._enc),
                "dec": cfg_dict(self._dec),
                "labels": self._labels,
                "batch_norm": self._batch_norm,
                "norm_pix_loss": self.cfg.model.norm_pix_loss,
                "mask_ratio": self.cfg.model.overrides.get("mask_ratio", 0.75),
                "image_size": self.image_size,
                "init_seed": self.cfg.run.init_seed,
                "weights": self._weights_id,
                "device": wc.device_fingerprint(self.device),
            }
        )

    def _entry_name(self, task: str) -> str:
        return wc.entry_name(self._fingerprint, task, 0, str(self._enc.dtype), self.quant)

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
        :func:`restore_inference_state` returns it). Every built task's
        model is rebuilt aside (fresh init, graft, quantization); then,
        under the replay lock, the live models' weights are copied to the
        host as the snapshot and the new values into the live models' own
        storage, so the captured graphs serve them without a capture and
        each request serves entirely old or entirely new weights. The
        encoder-output LRU is cleared under the same lock, so a cached
        reconstruction cannot decode encoder rows of the old weights with
        the new decoder; the JAX engine clears it after releasing its lock
        and keeps that race. Builds after a swap bypass the warm cache: no
        save names the new tree. Returns the snapshot for
        :meth:`restore_snapshot`; raises, leaving the old weights live,
        when the tree does not graft."""
        tree = {n: torch.as_tensor(v) for n, v in params.items()}
        stats = None if batch_stats is None else {n: torch.as_tensor(v) for n, v in batch_stats.items()}
        with self._lock:
            # a task mid-build holds this lock: it is in ``built`` or builds
            # from the new tree
            prev = {"ckpt": self._ckpt, "tree": self._ckpt_tree, "stats": self._ckpt_stats,
                    "load_stats": dict(self.load_stats), "weights_id": self._weights_id}
            built = sorted(self._tasks)
            self._ckpt, self._ckpt_tree, self._ckpt_stats = str(ckpt), tree, stats
            self._weights_id = None  # no save names this tree: builds bypass the warm cache
        try:
            fresh = {task: _weights(self._build_task(task)["model"]) for task in built}
        except BaseException:
            with self._lock:
                self._ckpt, self._ckpt_tree, self._ckpt_stats = prev["ckpt"], prev["tree"], prev["stats"]
                self.load_stats = prev["load_stats"]
                self._weights_id = prev["weights_id"]
            raise
        with self._replay_lock:
            snap = {**prev, "weights": {}}
            for task in built:
                live = self._tasks[task]["model"]
                snap["weights"][task] = {n: t.detach().to("cpu", copy=True) for n, t in _weights(live).items()}
                _copy_weights(live, fresh[task])
            self._sync()
            # cached encoder outputs are weight-dependent: cleared under the
            # same lock, so no cached reconstruction decodes old encoder rows
            # with the new decoder (the JAX engine clears after releasing it)
            self._clear_encoder_cache()
        return snap

    def restore_snapshot(self, snap: dict) -> None:
        """Reinstate a :meth:`swap_weights` snapshot (rollback): the
        snapshot's weights are copied back into the live models under the
        replay lock, so the graphs serve bit-equal outputs to before the
        swap. Tasks first built after the swap are dropped, with their
        graphs, to rebuild from the restored tree. The encoder-output LRU
        is cleared under the replay lock, as in :meth:`swap_weights` (the
        JAX engine clears it after the lock)."""
        with self._replay_lock, self._lock:
            self._ckpt, self._ckpt_tree, self._ckpt_stats = snap["ckpt"], snap["tree"], snap["stats"]
            self.load_stats = dict(snap["load_stats"])
            self._weights_id = snap["weights_id"]
            for task in list(self._tasks):
                if task in snap["weights"]:
                    _copy_weights(self._tasks[task]["model"], snap["weights"][task])
                else:
                    del self._tasks[task]
                    for key in [k for k in self._graphs if self._base_task(k[0]) == task]:
                        del self._graphs[key]
            self._sync()
            self._clear_encoder_cache()  # under the lock, as in swap_weights

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _clear_encoder_cache(self) -> None:
        with self._enc_cache_lock:
            self._enc_cache.clear()
            self._enc_cache_nbytes = 0
            self._m_enc_cache_bytes.set(0)

    # ------------------------------------------------------------ dispatch

    @staticmethod
    def _task_key(task: str, pool: str | None) -> str:
        return f"{task}:{pool}" if pool else task

    @staticmethod
    def _base_task(task: str) -> str:
        """The task whose model a key runs: ``reconstruct.enc`` and the
        packed keys (``features.packed:cls@r1s4``) share their base's."""
        return task.split(".", 1)[0]

    def _host_args(self, task: str, model, args) -> tuple[torch.Tensor, ...]:
        """A dispatch's inputs as host tensors, the graph's static inputs:
        a reconstruction's seed becomes its mask noise."""
        if task in ("reconstruct", "reconstruct.enc"):
            images, seed = args
            args = (images, reconstruct_noise(seed, model.encoder_cfg.num_patches))
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a for a in args)

    def _forward(self, task: str, pool: str | None, model, x: tuple[torch.Tensor, ...]):
        """One padded bucket through ``task``'s model, its inputs already on
        the device. Nothing here syncs the host: it is what a graph
        captures."""
        dt = self._enc.compute_dtype
        if task in ("features", "logits"):
            (images,) = x
            h = normalize_images(images, dtype=dt)
            if task == "logits":
                return model(h).float()
            tokens = model.encode(h)
            out = tokens if pool == "tokens" else pool_tokens(tokens, self._enc.num_cls_tokens, pool)
            return out.float()
        if ".embed@" in task:
            (images,) = x
            return model.embed_patches(normalize_images(images, dtype=dt)).float()
        if ".full:" in task:
            (images,) = x
            return model.serve_full(normalize_images(images, dtype=dt), pooling=task.split(".full:", 1)[1].split("@")[0])
        if ".packed:" in task:
            return model.serve_packed(*x, pooling=task.split(".packed:", 1)[1].split("@")[0])
        if task == "reconstruct.dec":
            tokens, mask, ids = x
            return {"reconstruction": model.mae_decode(tokens, ids.long()).float(), "mask": mask}
        images, noise = x
        tokens, mask, ids = model.mae_encode(images, mask_noise=noise)
        if task == "reconstruct":
            return {"reconstruction": model.mae_decode(tokens, ids).float(), "mask": mask.float()}
        # reconstruct.enc: shared mode's one permutation, materialized per
        # row so a cached row is self-contained
        ids = ids.expand(images.shape[0], -1) if ids.dim() == 1 else ids
        return {"tokens": tokens, "mask": mask.float(), "ids": ids.int()}

    def _capture(self, key: tuple[str, int], task: str, pool: str | None, model, host) -> _Graph:
        """The first dispatch of ``key`` on the card: the forward once
        eagerly on the capture stream, then captured over static inputs
        into the engine's pool. Raises when anything fails: there is no
        eager fallback on the card."""
        dev = self.device
        pinned = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in host)
        static = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in host)
        with _CAPTURE_LOCK:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(dev)
                self._pool = torch.cuda.graph_pool_handle()
            stream = self._capture_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), torch.inference_mode():
                for pin, d, t in zip(pinned, static, host):
                    pin.copy_(t)
                    d.copy_(pin, non_blocking=True)
                t0 = time.perf_counter()
                self._forward(task, pool, model, static)  # the eager first run
                stream.synchronize()
                first_run_s = time.perf_counter() - t0
                reserved = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                # the counters' growth over the capture is this graph's own:
                # another engine's replay adds its launches after it
                with _COUNTS_LOCK:
                    before = _launch_counts()
                    t0 = time.perf_counter()
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        outputs = self._forward(task, pool, model, static)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                    capture_s = time.perf_counter() - t0
                    after = _launch_counts()
                    launches = {n: after[n] - before[n] for n in LAUNCH_COUNTERS}
                    for n, d in launches.items():  # a capture launches nothing on the card
                        setattr(flash, n, getattr(flash, n) - d)
            torch.cuda.current_stream(dev).wait_stream(stream)
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        g = _Graph(graph, pinned, static, outputs, launches, model, first_run_s, capture_s, pool_bytes)
        self._graphs[key] = g
        return g

    def _execute(self, key: tuple[str, int], task: str, pool: str | None, args, n: int):
        """Run and fetch one bucket; returns ``(rows, compute_s, fetch_s)``.
        On the card: replay ``key``'s graph, capturing it first."""
        model = self._task(self._base_task(task))["model"]
        host = self._host_args(task, model, args)
        with self._count_lock:
            self.dispatches += 1
        if self.device.type == "cuda":
            g = self._graphs.get(key)
            if g is None:
                self._m_misses.labels(key[0]).inc()
                g = self._capture(key, task, pool, model, host)
                self._compiled(key, model, g.first_run_s + g.capture_s)
            else:
                self._m_hits.labels(key[0]).inc()
            t0 = time.perf_counter()
            out = g.run(host)
        else:
            first = key not in self.compile_counts
            (self._m_misses if first else self._m_hits).labels(key[0]).inc()
            with torch.inference_mode():
                t0 = time.perf_counter()
                out = self._forward(task, pool, model, host)
            if first:
                self._compiled(key, model, time.perf_counter() - t0)
        t1 = time.perf_counter()
        out = _fetch(out, n, numpy=task != "reconstruct.enc")
        return out, t1 - t0, time.perf_counter() - t1

    def _compiled(self, key: tuple[str, int], model, compile_s: float) -> None:
        """A key's capture (its first run on the CPU) of ``compile_s``
        seconds, eager first run included: counted, timed, priced."""
        self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
        self._m_compile.labels(key[0]).observe(compile_s)
        self._m_bucket_compile.labels(*map(str, key)).set(compile_s)
        g = self._graphs.get(key)
        if g is not None and g.pool_bytes > 0:
            self._m_exec_bytes.labels(*map(str, key)).set(g.pool_bytes)
        self._publish_cost(key, model)
        if self.on_compile is not None:
            self.on_compile(*key)

    def _publish_cost(self, key: tuple[str, int], model) -> None:
        """The :class:`ProgramCost` of ``key``'s graph (run by ``model``)
        into ``cost_reports`` and the ``xla_*`` gauges, once per capture."""
        task_key, bucket = key
        enc = getattr(model, "encoder_cfg", self._enc)  # a reconstruction counts its masked encoder
        flops = task_flops(task_key, bucket, enc, self._dec, self._labels)
        if flops is None:
            return
        g = self._graphs.get(key)
        cost = program_cost(task_key, flops=flops, weight_nbytes=weight_bytes(model, self._enc.compute_dtype),
                            dim=self._enc.dim, peak_bytes=None if g is None else g.pool_bytes)
        self.cost_reports[key] = cost
        dtype = str(self._enc.compute_dtype).removeprefix("torch.") + (f"+{self.quant}" if self.quant else "")
        publish_cost(cost, bucket=str(bucket), dtype=dtype, registry=self._registry)

    def _dispatch(self, task: str, pool: str | None, bucket: int, args, n: int):
        """One padded bucket under the replay lock (the task is built
        before it is taken)."""
        key = (self._task_key(task, pool), bucket)
        self._task(self._base_task(task))
        with self._replay_lock:
            return self._execute(key, task, pool, args, n)

    def dispatch(self, task: str, images, *, pool: str | None = None) -> np.ndarray:
        """Run one already-padded bucket of ``features`` or ``logits``
        (uint8 NHWC, len <= max_batch) and return every row."""
        images = np.asarray(images)
        return self._dispatch(task, pool, images.shape[0], (images,), images.shape[0])[0]

    def executable_cache_bytes(self) -> int:
        """Bytes of the captured graphs' memory pool: the sum of each
        capture's pool growth (``graph_stats``), the memory accountant's
        ``exec_cache`` probe; 0 on the CPU, which captures nothing."""
        return sum(max(g.pool_bytes, 0) for g in list(self._graphs.values()))

    def predicted_peak_hbm(self) -> dict[str, float]:
        """The predicted peak card bytes of each captured key
        (``task/b<bucket>``): its :class:`ProgramCost`'s ``peak_bytes``,
        where one is known; the memory watcher's drift gauge divides the
        measured peak by it."""
        return {f"{k[0]}/b{k[1]}": float(c.peak_bytes) for k, c in list(self.cost_reports.items())
                if c.peak_bytes}

    def swap_device_bytes(self) -> int:
        """Card bytes a :meth:`swap_weights` builds aside before it copies:
        the weights of every built task's model (0 on the CPU). The swap
        controller's headroom gate holds them against the card's free
        memory."""
        if self.device.type != "cuda":
            return 0
        with self._lock:
            models = [t["model"] for t in self._tasks.values()]
        return sum(_nbytes(t) for m in models for t in _weights(m).values())

    def graph_stats(self) -> dict[str, dict]:
        """Per captured key (``"<task key>/b<bucket>"``): the seconds of its
        eager first run and of its capture, the pool's growth in bytes at
        its capture (the memory the graph added to the engine's shared
        pool) and the launches one replay stands for."""
        return {
            f"{k[0]}/b{k[1]}": {"first_run_s": g.first_run_s, "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                                 "launches": {n: d for n, d in g.launches.items() if d}}
            for k, g in self._graphs.items()
        }

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
        self._m_pad.observe((bucket - n) / bucket)
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
        on the calling thread (``None`` before any). After
        :meth:`predict_packed`, ``bucket`` is the token budget and
        ``pad_fraction`` the packed dispatch's token pad."""
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
        """Dispatch every (task, bucket) the workload will hit once, on
        zeros, so no request pays a capture (or, on the CPU, a first run).
        Default buckets: :func:`pow2_rungs` of ``max_batch``. Returns the
        number of captures made; ``warmup_s`` is the ladder's seconds. The
        ladder runs on ``workers`` threads (default up to 4): the task
        builds overlap, the device work takes the replay lock in turn."""
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
        self._m_warm_start.set(self.warmup_s)
        return sum(self.compile_counts.values()) - before

    def _warm(self, task: str, pool: str | None, bucket: int, size: int | None = None) -> None:
        size = size or self.image_size
        images = np.zeros((bucket, size, size, 3), np.uint8)
        if task in ("features", "logits") or ".embed@" in task or ".full:" in task:
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
        t0 = time.perf_counter()
        self._reset_breakdown()
        images = self._check_images(images)
        with self._replay_lock:
            out = self._chunks(task, pool, (images,), extra)
        self._m_predict.labels(task).observe(time.perf_counter() - t0)
        self._m_images.labels(task).inc(images.shape[0])
        return out

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
        t0 = time.perf_counter()
        self._reset_breakdown()
        images = self._check_images(images)
        with self._replay_lock:
            out = self._reconstruct_cached_locked(images, seed)
        self._m_predict.labels("reconstruct").observe(time.perf_counter() - t0)
        self._m_images.labels("reconstruct").inc(images.shape[0])
        return out

    def _reconstruct_cached_locked(self, images: np.ndarray, seed: int) -> dict[str, np.ndarray]:
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
            self.encoder_cache_hits += hits
            self.encoder_cache_misses += len(miss_idx)
        if hits:
            self._m_enc_cache.labels("hit").inc(hits)
        if miss_idx:
            self._m_enc_cache.labels("miss").inc(len(miss_idx))
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
                    self._m_enc_cache.labels("evict").inc()
                self._m_enc_cache_bytes.set(self._enc_cache_nbytes)
        tokens, mask, ids = (torch.stack([r[j] for r in rows]) for j in range(3))
        return self._chunks("reconstruct.dec", None, (tokens, mask, ids))

    # ------------------------------------------------- token-packed serving

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

    def _check_packed_request(self, imgs: list, task_list: list) -> list[int]:
        """Validate a packed request mix; returns each request's tokens."""
        lengths = []
        for i, im in enumerate(imgs):
            if im.ndim != 3 or im.shape[-1] != 3:
                raise ValueError(f"packed request {i}: expected one (H, W, 3) uint8 image, got {im.shape}")
            h, w = int(im.shape[0]), int(im.shape[1])
            if h != w:
                raise ValueError(f"packed request {i}: expected a square image, got {h}x{w}")
            if h != self.image_size and self._enc.posemb != "sincos2d":
                raise ValueError(
                    f"packed request {i} is {h}px but the engine's native size is {self.image_size}px and "
                    f"posemb={self._enc.posemb!r} is resolution-locked — serve mixed resolutions with "
                    "posemb='sincos2d'"
                )
            lengths.append(self.seq_len(h))
        bad = sorted({t for t in task_list if t not in ("features", "logits")})
        if bad:
            raise ValueError(f"packed serving covers the encoder-sharing tasks features/logits; got {bad}")
        return lengths

    @staticmethod
    def _by_resolution(imgs: list) -> dict[int, list[int]]:
        by_res: dict[int, list[int]] = {}
        for i, im in enumerate(imgs):
            by_res.setdefault(int(im.shape[0]), []).append(i)
        return dict(sorted(by_res.items()))

    def _per_resolution(self, imgs: list, task: str) -> list:
        """``task`` (an embed or full key's stem, ``@<res>`` appended) over
        the images of each resolution in image-count buckets; one output
        row per request, in request order."""
        out: list = [None] * len(imgs)
        for res, idxs in self._by_resolution(imgs).items():
            stack = np.stack([imgs[i] for i in idxs]).astype(np.uint8, copy=False)
            for off in range(0, len(idxs), self.max_batch):
                got = self._run(f"{task}@{res}", None, (stack[off : off + self.max_batch],))
                for j, i_req in enumerate(idxs[off : off + self.max_batch]):
                    out[i_req] = {k: v[j] for k, v in got.items()} if isinstance(got, dict) else got[j]
        return out

    def _embed_requests(self, imgs: list, tree_task: str) -> list[np.ndarray]:
        """Stage one of the packed path: each request's (n_patches, dim)
        float32 patch tokens, from per-resolution embed dispatches."""
        return self._per_resolution(imgs, f"{tree_task}.embed")

    def _packed_plan(self, lengths: list[int], max_tokens: int | None):
        rungs = packing.budget_rungs(int(max_tokens or self.max_tokens))
        budget, plan = packing.choose_budget(lengths, rungs)
        return budget, plan, ceil_pow2(plan.rows), ceil_pow2(plan.max_segments)

    def predict_packed(self, images, tasks="features", *, pool: str = "cls", max_tokens: int | None = None) -> list:
        """Serve a mixed-resolution, mixed-task request list in ONE
        token-packed dispatch instead of one padded image bucket per
        ``(task, shape)``.

        ``images``: square, patch-aligned ``(H, W, 3)`` uint8 arrays
        (non-native sizes need ``posemb='sincos2d'``). ``tasks``: one task
        name or one per request, from ``features``/``logits`` (when any
        request wants logits the pack runs on the logits task's model,
        whose encoder is the same graft). Returns one float32 row per
        request, in request order. The packed key is
        ``<tree>.packed:<pool>@r<rows>s<smax>`` with the token budget as
        its bucket; ``last_breakdown()["pad_fraction"]`` is the dispatch's
        token pad."""
        if pool not in ("cls", "gap"):
            raise ValueError(f"packed serving pools per segment: pool must be 'cls' or 'gap', got {pool!r}")
        imgs = [np.asarray(im) for im in images]
        n = len(imgs)
        if n == 0:
            return []
        task_list = [tasks] * n if isinstance(tasks, str) else list(tasks)
        if len(task_list) != n:
            raise ValueError(f"{n} images but {len(task_list)} tasks — pass one task name or one per request")
        lengths = self._check_packed_request(imgs, task_list)
        tree_task = "logits" if "logits" in task_list else "features"
        t0 = time.perf_counter()
        self._reset_breakdown()
        k = self._enc.num_cls_tokens
        budget, plan, rows_b, smax_b = self._packed_plan(lengths, max_tokens)
        arrays = packing.build_arrays(plan, k, rows=rows_b, max_segments=smax_b)
        with self._replay_lock:
            buf = packing.place_tokens(plan, self._embed_requests(imgs, tree_task), k, rows=rows_b)
            task_key = f"{tree_task}.packed:{pool}@r{rows_b}s{smax_b}"
            args = (buf, arrays["segment_ids"], arrays["cls_pos"], arrays["cls_index"])
            out, compute_s, fetch_s = self._dispatch(task_key, None, budget, args, rows_b)
        # the embed stage's buckets are small beside the packed dispatch:
        # the pad reported is the packed dispatch's, in tokens
        bd = self._tls.bd
        bd["compute_s"] += compute_s
        bd["fetch_s"] += fetch_s
        bd["bucket"] = budget
        bd["pad_rows"] = rows_b * budget - plan.total_tokens
        bd["bucket_rows"] = rows_b * budget
        device_tokens = rows_b * budget
        self._m_pack_pad.observe((device_tokens - plan.total_tokens) / device_tokens)
        self._m_pack_segments.observe(len(plan.segments))
        self._m_pack_occ.observe(plan.total_tokens / device_tokens)
        self._m_pack_dispatches.labels(tree_task).inc()
        self._m_predict.labels("packed").observe(time.perf_counter() - t0)
        self._m_images.labels("packed").inc(n)
        pooled = packing.unpack_rows(plan, out["pooled"])
        logits = packing.unpack_rows(plan, out["logits"]) if "logits" in out else None
        return [logits[i] if task_list[i] == "logits" else pooled[i] for i in range(n)]

    def packed_parity(
        self,
        images,
        tasks="features",
        *,
        pool: str = "cls",
        max_tokens: int | None = None,
        feature_cos_min: float = 0.999,
        logits_top1_min: float = 0.98,
    ) -> dict:
        """Each request's packed output against the unpacked forward of the
        same task tree at its own resolution: the packed rollout's gate
        (feature cosine >= 0.999, logits top-1 agreement >= 0.98, as the
        int8 gate)."""
        imgs = [np.asarray(im) for im in images]
        n = len(imgs)
        task_list = [tasks] * n if isinstance(tasks, str) else list(tasks)
        with self._replay_lock:
            packed = self.predict_packed(imgs, task_list, pool=pool, max_tokens=max_tokens)
            tree_task = "logits" if "logits" in task_list else "features"
            self._reset_breakdown()
            ref = self._per_resolution(imgs, f"{tree_task}.full:{pool}")
        cosines: list[float] = []
        top1: list[int] = []
        rows = []
        for i in range(n):
            if task_list[i] == "logits":
                agree = int(np.argmax(packed[i]) == np.argmax(ref[i]["logits"]))
                top1.append(agree)
                rows.append({"task": "logits", "top1_agree": agree})
            else:
                a = packed[i].ravel().astype(np.float64)
                b = ref[i]["pooled"].ravel().astype(np.float64)
                denom = np.linalg.norm(a) * np.linalg.norm(b)
                cos = float(a @ b / denom) if denom else 1.0
                cosines.append(cos)
                rows.append({"task": "features", "cosine": round(cos, 6)})
        cos_min = min(cosines) if cosines else None
        top1_agree = float(np.mean(top1)) if top1 else None
        ok = (cos_min is None or cos_min >= feature_cos_min) and (top1_agree is None or top1_agree >= logits_top1_min)
        self._m_pack_parity.set(cos_min if cos_min is not None else 1.0)
        if not ok:
            self._m_pack_parity_fail.inc()
        return {
            "n": n,
            "pool": pool,
            "feature_cosine_min": cos_min,
            "logits_top1_agree": top1_agree,
            "feature_cos_threshold": feature_cos_min,
            "logits_top1_threshold": logits_top1_min,
            "pass": ok,
            "requests": rows,
        }

    def warmup_packed(
        self, resolutions, tasks: tuple[str, ...] = ("features",), *, pool: str = "cls", max_tokens: int | None = None
    ) -> int:
        """Capture the packed path of a representative resolution mix: each
        resolution's embed graph at its image-count bucket and the packed
        graph the mix's plan lands on. Returns the captures made."""
        resolutions = [int(r) for r in resolutions]
        if not resolutions:
            return 0
        tree_task = "logits" if "logits" in tuple(tasks) else "features"
        budget, plan, rows_b, smax_b = self._packed_plan([self.seq_len(r) for r in resolutions], max_tokens)
        before = sum(self.compile_counts.values())
        t0 = time.perf_counter()
        counts: dict[int, int] = {}
        for r in resolutions:
            counts[r] = counts.get(r, 0) + 1
        for res, cnt in sorted(counts.items()):
            self._warm(f"{tree_task}.embed@{res}", None, bucket_for(min(cnt, self.max_batch), self.max_batch), res)
        k = self._enc.num_cls_tokens
        arrays = packing.build_arrays(plan, k, rows=rows_b, max_segments=smax_b)
        buf = np.zeros((rows_b, budget, self._enc.dim), np.float32)
        self._dispatch(f"{tree_task}.packed:{pool}@r{rows_b}s{smax_b}", None, budget,
                       (buf, arrays["segment_ids"], arrays["cls_pos"], arrays["cls_index"]), rows_b)
        self.warmup_s = time.perf_counter() - t0
        self._m_warm_start.set(self.warmup_s)
        return sum(self.compile_counts.values()) - before
