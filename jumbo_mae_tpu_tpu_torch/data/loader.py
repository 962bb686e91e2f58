"""Streaming dataloader: shards → decode → augment → batches → device.

Counterpart of ``jumbo_mae_tpu_tpu/data/loader.py``, with the same
contracts, so both packages give the same batches bit for bit from the
same shards, config and image backend:

- train: an infinite stream; a deterministic shard-order shuffle per
  epoch, per-process striping, a per-worker split, a streaming sample
  shuffle, and repeated augmentation with the clones de-interleaved
  across the batch;
- valid: one sequential pass, the final partial batch padded to full size
  with ``valid=False`` rows and ``label=-1``;
- batches are host numpy uint8 NHWC; normalization runs on the device.

Workers are fresh interpreters (``data/_worker.py``) that never import
torch. Every worker's stream is reproducible from (seed, process_index,
worker_index, epoch), and :class:`TrainLoader` reads the workers in strict
round-robin order, which makes a sample-exact resume possible
(:meth:`TrainLoader.snapshot`). :func:`prefetch_to_device` copies batches
to the card from pinned memory on a side CUDA stream.

With ``use_native`` the train stream comes from the native C++ tar reader
(``data/native.py``) in this process instead of the workers, in an order
fixed by (shard list, ``native_io_threads``); with ``valid_cache`` every
evaluation after the first streams from an on-disk sample cache
(``data/valcache.py``). This module imports torch only inside
:func:`prefetch_to_device`, and PIL only when ``auto_augment`` names a
policy.
"""

from __future__ import annotations

import json
import os
import pickle
import queue as queue_mod
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from collections.abc import Iterator
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

from jumbo_mae_tpu_tpu_torch.data import decode, transforms
from jumbo_mae_tpu_tpu_torch.data.decode import decode_image, decode_label, find_image_key
from jumbo_mae_tpu_tpu_torch.data.randaugment import auto_augment_factory
from jumbo_mae_tpu_tpu_torch.data.resize import ShardLedger, merge_shard_states
from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards, shuffle_shards, split_shards
from jumbo_mae_tpu_tpu_torch.data.tario import RetryPolicy, iter_shards_samples
from jumbo_mae_tpu_tpu_torch.data.transforms import (
    color_jitter,
    eval_transform,
    random_erasing,
    random_hflip,
    random_resized_crop,
    resize,
    simple_resize_crop,
)
from jumbo_mae_tpu_tpu_torch.data.valcache import ValidSampleCache
from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry


@dataclass(frozen=True)
class DataConfig:
    """Pipeline knobs: the JAX package's fields and defaults."""

    train_shards: str | list[str] = ""
    valid_shards: str | list[str] = ""
    image_size: int = 224
    labeled: bool = True
    crop_mode: str = "rrc"  # rrc | src | none
    min_scale: float = 0.2
    hflip: float = 0.5
    auto_augment: str = "none"
    color_jitter: float = 0.0
    random_erasing: float = 0.0
    repeats: int = 1
    shuffle_buffer: int = 1000
    test_crop_ratio: float = 0.875
    seed: int = 0
    workers: int = 4
    prefetch_batches: int = 4
    # shard reads: shard_retries attempts with capped exponential backoff
    # before the shard is quarantined for the rest of the epoch pass
    shard_retries: int = 3
    shard_retry_backoff_s: float = 0.05
    # samples per epoch — converts a resumed step into the stream's
    # starting epoch (the coarse resume, when no data cursor was saved)
    dataset_size: int = 1_281_167
    use_native: bool = False
    native_io_threads: int = 4
    decode_threads: int = 4
    valid_cache: str = ""


@dataclass
class StreamCursor:
    """Mutable position of a train sample stream: ``offset`` samples (clones
    included) have been yielded within ``epoch``. Updated in place by the
    stream after every yield, so whoever drains it can snapshot an exact
    resume point."""

    epoch: int = 0
    offset: int = 0


def _retry_policy(cfg: DataConfig) -> RetryPolicy:
    return RetryPolicy(attempts=max(1, cfg.shard_retries), backoff_s=max(0.0, cfg.shard_retry_backoff_s))


def _aug_rng(seed: int, process_index: int, worker_index: int, epoch: int, idx: int) -> np.random.Generator:
    """Per-sample augmentation generator, keyed on the yielded-sample index
    apart from the shuffle's, so a resumed stream can skip the transforms
    of consumed samples without moving any draw the rest depend on."""
    return np.random.default_rng((seed, 3, process_index, worker_index, epoch, idx))


class TrainTransform:
    """Per-sample train augmentation chain: crop → flip → policy
    (``data.auto_augment``, ``data/randaugment.py``) → jitter → erasing."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.policy = auto_augment_factory(cfg.auto_augment)

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        if cfg.crop_mode == "rrc":
            img = random_resized_crop(rng, img, cfg.image_size, scale=(cfg.min_scale, 1.0))
        elif cfg.crop_mode == "src":
            img = simple_resize_crop(rng, img, cfg.image_size)
        else:
            img = resize(img, (cfg.image_size, cfg.image_size))
        img = random_hflip(rng, img, cfg.hflip)
        if self.policy is not None:
            img = self.policy(rng, img)
        if cfg.color_jitter > 0:
            img = color_jitter(rng, img, cfg.color_jitter)
        if cfg.random_erasing > 0:
            img = random_erasing(rng, img, cfg.random_erasing)
        return np.ascontiguousarray(img)


def _shuffle_stream(it: Iterator, buffer_size: int, rng: np.random.Generator) -> Iterator:
    """Streaming buffer shuffle (webdataset ``detshuffle`` equivalent)."""
    if buffer_size <= 1:
        yield from it
        return
    buf: list = []
    for x in it:
        if len(buf) < buffer_size:
            buf.append(x)
            continue
        i = int(rng.integers(len(buf)))
        buf[i], x = x, buf[i]
        yield x
    rng.shuffle(buf)  # type: ignore[arg-type]
    yield from buf


def _decode_metrics():
    """The per-sample decode time and the failed-decode count of the
    process registry: a worker interpreter's land in its own registry
    (not exported), the inline and native streams' feed the exporter."""
    reg = get_registry()
    return (reg.histogram("data_decode_seconds", "image decode time per sample"),
            reg.counter("data_decode_failures_total", "samples dropped by a failed decode"))


def train_sample_stream(
    cfg: DataConfig,
    *,
    process_index: int = 0,
    process_count: int = 1,
    worker_index: int = 0,
    worker_count: int = 1,
    start_epoch: int = 0,
    skip_samples: int = 0,
    cursor: StreamCursor | None = None,
    ledger: ShardLedger | None = None,
) -> Iterator[tuple[np.ndarray, int]]:
    """Infinite (image, label) stream for one (process, worker) pair.

    ``skip_samples`` fast-forwards past consumed samples of the starting
    epoch: shard order, shuffle draws and decode replay, the augmentation
    is skipped, and per-sample generators keep the rest of the stream
    bit-identical to an uninterrupted one. ``ledger`` tracks which epoch
    shards have been fully yielded. Each decode crosses the ``data.decode``
    fault site, keyed by the sample's ``__key__``, and is timed into
    ``data_decode_seconds``; a sample that does not decode is dropped and
    counted in ``data_decode_failures_total``."""
    shards = expand_shards(cfg.train_shards)
    transform = TrainTransform(cfg)
    m_decode, m_decode_fail = _decode_metrics()
    retry = _retry_policy(cfg)
    epoch = start_epoch
    to_skip = max(0, skip_samples)
    while True:
        rng = np.random.default_rng((cfg.seed, 1, process_index, worker_index, epoch))
        order = shuffle_shards(shards, seed=cfg.seed, epoch=epoch)
        gidx = split_shards(
            list(range(len(order))),  # type: ignore[arg-type]
            process_index=process_index,
            process_count=process_count,
            worker_index=worker_index,
            worker_count=worker_count,
        )
        epoch_pairs = [(g, order[g]) for g in gidx]

        def decoded():
            # one shard per iter_shards_samples call, so the ledger sees
            # shard boundaries
            for g, url in epoch_pairs:
                for sample in iter_shards_samples([url], retry=retry):
                    img_key = find_image_key(sample)
                    if img_key is None:
                        continue
                    t0 = time.perf_counter()
                    payload = fault_point("data.decode", key=str(sample.get("__key__", "")), data=sample[img_key])
                    img = decode_image(payload)  # type: ignore[arg-type]
                    m_decode.observe(time.perf_counter() - t0)
                    if img is None:
                        m_decode_fail.inc()
                        continue
                    label = decode_label(sample["cls"]) if "cls" in sample else -1
                    if ledger is not None:
                        ledger.note_read(epoch, g)
                    yield g, (img, label)
                if ledger is not None:
                    ledger.note_read_done(epoch, g)

        idx = 0
        for g, (img, label) in _shuffle_stream(decoded(), cfg.shuffle_buffer, rng):
            if ledger is not None:
                ledger.note_yield(epoch, g)
            for _ in range(cfg.repeats):
                if to_skip > 0:
                    to_skip -= 1
                    idx += 1
                    continue
                aug = _aug_rng(cfg.seed, process_index, worker_index, epoch, idx)
                out = transform(aug, img), label
                idx += 1
                if cursor is not None:
                    cursor.epoch, cursor.offset = epoch, idx
                yield out
        epoch += 1


def valid_sample_stream(
    cfg: DataConfig, *, process_index: int = 0, process_count: int = 1
) -> Iterator[tuple[np.ndarray, int]]:
    """One sequential eval pass over this process's stripe of the valid set."""
    shards = split_shards(expand_shards(cfg.valid_shards), process_index=process_index, process_count=process_count)
    for sample in iter_shards_samples(shards, retry=_retry_policy(cfg)):
        img_key = find_image_key(sample)
        if img_key is None:
            continue
        img = decode_image(sample[img_key])  # type: ignore[arg-type]
        if img is None:
            continue
        label = decode_label(sample["cls"]) if "cls" in sample else -1
        yield eval_transform(img, cfg.image_size, crop_ratio=cfg.test_crop_ratio), label


def native_train_stream(
    cfg: DataConfig,
    *,
    process_index: int = 0,
    process_count: int = 1,
    start_epoch: int = 0,
    skip_samples: int = 0,
    cursor: StreamCursor | None = None,
) -> Iterator[tuple[np.ndarray, int]]:
    """The train stream over the native reader (``data/native.py``): C++
    reader threads hand out raw image bytes, a thread pool of
    ``decode_threads`` decodes them (cv2 and PIL release the GIL), and the
    shuffle and augmentation run here, as :func:`train_sample_stream`'s do.

    One reader per epoch over the process's stripe of that epoch's shard
    order. The sample order is a pure function of (shard list,
    ``native_io_threads``): each reader thread owns every T-th shard and
    the reader merges the threads' queues in strict round-robin. So
    ``skip_samples`` replays the consumed prefix exactly (decode and
    shuffle draws replay; the augmentation is skipped), the same contract
    as :func:`train_sample_stream`, for the same thread count. Each decode
    crosses the ``data.decode`` fault site (with no key: the reader hands
    out bytes and labels only) and the two decode metrics."""
    from concurrent.futures import ThreadPoolExecutor

    from jumbo_mae_tpu_tpu_torch.data.native import NativeShardReader

    shards = expand_shards(cfg.train_shards)
    transform = TrainTransform(cfg)
    m_decode, m_decode_fail = _decode_metrics()
    epoch = start_epoch
    to_skip = max(0, skip_samples)

    def decode_one(pair):
        payload, label = pair
        t0 = time.perf_counter()
        payload = fault_point("data.decode", data=payload)
        img = decode_image(payload)
        m_decode.observe(time.perf_counter() - t0)
        if img is None:
            m_decode_fail.inc()
            return None
        return (img, label)

    with ThreadPoolExecutor(max_workers=max(1, cfg.decode_threads)) as pool:

        def decoded(reader):
            # a bounded window of futures (pool.map would drain the whole
            # reader at once): the window keeps backpressure on the queues
            window: deque = deque()
            depth = max(2, cfg.decode_threads * 4)
            for pair in reader:
                window.append(pool.submit(decode_one, pair))
                if len(window) >= depth:
                    r = window.popleft().result()
                    if r is not None:
                        yield r
            while window:
                r = window.popleft().result()
                if r is not None:
                    yield r

        while True:
            rng = np.random.default_rng((cfg.seed, 2, process_index, epoch))
            epoch_shards = split_shards(
                shuffle_shards(shards, seed=cfg.seed, epoch=epoch),
                process_index=process_index,
                process_count=process_count,
            )
            with NativeShardReader(epoch_shards, threads=cfg.native_io_threads) as reader:
                idx = 0
                for img, label in _shuffle_stream(decoded(reader), cfg.shuffle_buffer, rng):
                    for _ in range(cfg.repeats):
                        if to_skip > 0:
                            to_skip -= 1
                            idx += 1
                            continue
                        aug = _aug_rng(cfg.seed, process_index, 0, epoch, idx)
                        out = transform(aug, img), label
                        idx += 1
                        if cursor is not None:
                            cursor.epoch, cursor.offset = epoch, idx
                        yield out
            epoch += 1


def _deinterleave(indices: int, repeats: int) -> np.ndarray:
    """Batch reorder that spreads repeated-augmentation clones across the
    batch (the reference's ``batch[i::repeats]`` concatenation)."""
    order = np.arange(indices)
    return np.concatenate([order[i::repeats] for i in range(repeats)])


def batch_train_samples(
    stream: Iterator[tuple[np.ndarray, int]],
    batch_size: int,
    repeats: int = 1,
    cursor: StreamCursor | None = None,
    ledger: ShardLedger | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Assemble train batches; de-interleave repeat clones. With ``cursor``
    (the object the stream updates) each batch carries ``_cursor``, the
    (epoch, offset) after its last sample; with ``ledger``, ``_shards``,
    the consumed-shard snapshot as of its last sample."""
    order = _deinterleave(batch_size, max(1, repeats))
    while True:
        pairs = [next(stream) for _ in range(batch_size)]
        images = np.stack([p[0] for p in pairs])[order]
        labels = np.asarray([p[1] for p in pairs], np.int32)[order]
        batch = {"images": images, "labels": labels}
        if cursor is not None:
            batch["_cursor"] = (cursor.epoch, cursor.offset)
        if ledger is not None:
            batch["_shards"] = ledger.snapshot()
        yield batch


def batch_valid_samples(
    stream: Iterator[tuple[np.ndarray, int]], batch_size: int, image_size: int
) -> Iterator[dict[str, np.ndarray]]:
    """Assemble eval batches; pad the final partial batch (valid=False,
    label=-1) so step shapes stay constant."""
    images = np.zeros((batch_size, image_size, image_size, 3), np.uint8)
    labels = np.full((batch_size,), -1, np.int32)
    valid = np.zeros((batch_size,), bool)
    n = 0
    for img, label in stream:
        images[n], labels[n], valid[n] = img, label, True
        n += 1
        if n == batch_size:
            yield {"images": images.copy(), "labels": labels.copy(), "valid": valid.copy()}
            images = np.zeros_like(images)
            labels = np.full_like(labels, -1)
            valid = np.zeros_like(valid)
            n = 0
    if n:
        yield {"images": images, "labels": labels, "valid": valid}


class _Worker:
    """One data-worker interpreter, its pipe-reader thread and its batch
    queue. The reader thread turns the stdout frame stream into a bounded
    queue; EOF marks the worker dead so the consumer raises instead of
    hanging. The worker sees no GPU (``CUDA_VISIBLE_DEVICES`` empty)."""

    def __init__(self, spec: dict, queue_size: int):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        repo_root = str(Path(__file__).resolve().parent.parent.parent)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.data._worker", json.dumps(spec)],
            stdout=subprocess.PIPE,
            env=env,
        )
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=queue_size)
        self.dead = False
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self):
        stream = self.proc.stdout
        try:
            while True:
                header = stream.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack(">Q", header)
                payload = stream.read(length)
                if len(payload) < length:
                    break
                self.queue.put(pickle.loads(payload))  # frames our own worker wrote
        except (OSError, ValueError):  # pragma: no cover - pipe torn down
            pass
        finally:
            self.dead = True

    def stop(self):
        self.dead = True
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self.proc.kill()
                self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()


class TrainLoader:
    """Infinite train-batch iterator backed by worker interpreters.

    Each worker owns a disjoint shard stripe and yields whole per-process
    batches; the loader reads the workers in strict round-robin order —
    batch n always comes from worker ``n % workers`` — so the batch
    sequence is a pure function of the config. ``workers=0`` runs inline,
    and so does ``use_native`` (:func:`native_train_stream`).

    ``snapshot()`` returns a JSON-able cursor (per-worker stream positions
    and the round-robin phase); a loader built with ``cursor=`` continues
    the exact batch sequence from there. ``wait_s`` accumulates the
    seconds ``__next__`` spent waiting for a batch."""

    def __init__(
        self,
        cfg: DataConfig,
        batch_size: int,
        *,
        process_index: int = 0,
        process_count: int = 1,
        start_epoch: int = 0,
        cursor: dict | None = None,
    ):
        if batch_size % max(1, cfg.repeats):
            raise ValueError(f"repeats ({cfg.repeats}) must divide the per-process batch size ({batch_size})")
        TrainTransform(cfg)  # a policy without PIL raises here, not in a worker
        if decode.backend() == "none":
            raise ImportError(decode.NO_BACKEND)
        self.cfg = cfg
        self.batch_size = batch_size
        self.wait_s = 0.0
        self._workers: list[_Worker] = []
        self._shard_states: list = []
        self._native_threads: int | None = None
        if cfg.use_native:
            self._start_native(cursor, start_epoch, process_index, process_count)
            return
        n_streams = 1 if cfg.workers <= 0 else cfg.workers
        stripe = len(expand_shards(cfg.train_shards)[process_index::process_count])
        if stripe < n_streams:
            # a stream without shards would read nothing forever
            raise ValueError(
                f"{n_streams} data stream(s) but this process's stripe has {stripe} shard(s); "
                "each worker needs at least one: lower data.workers"
            )
        if cursor is not None:
            if cursor.get("native_threads") is not None:
                raise ValueError(
                    "resume cursor was written by the native-IO loader (round-robin-over-threads "
                    "sample order); restart with data.use_native=true or fall back to epoch resume"
                )
            starts = [tuple(c) for c in cursor["workers"]]
            if len(starts) != n_streams:
                raise ValueError(
                    f"resume cursor has {len(starts)} worker streams but the loader is configured for "
                    f"{n_streams} — restart with the checkpointed worker count or fall back to epoch resume"
                )
            self.batches_yielded = int(cursor["batches"])
        else:
            starts = [(start_epoch, 0)] * n_streams
            self.batches_yielded = 0
        self._cursors = list(starts)
        self._shard_states = [None] * n_streams
        print(
            f"[data] train loader: {cfg.workers} worker(s), decode backend {decode.backend()}, "
            f"resize backend {transforms.backend()}",
            flush=True,
        )
        if cfg.workers <= 0:
            led = ShardLedger()
            track = StreamCursor(*starts[0])
            self._stream = train_sample_stream(
                cfg,
                process_index=process_index,
                process_count=process_count,
                start_epoch=starts[0][0],
                skip_samples=starts[0][1],
                cursor=track,
                ledger=led,
            )
            self._inline = batch_train_samples(self._stream, batch_size, cfg.repeats, cursor=track, ledger=led)
            return
        self._stream = self._inline = None
        per_worker_q = max(1, cfg.prefetch_batches // cfg.workers)
        for w in range(cfg.workers):
            spec = {
                "data": asdict(cfg),
                "batch_size": batch_size,
                "process_index": process_index,
                "process_count": process_count,
                "worker_index": w,
                "worker_count": cfg.workers,
                "start_epoch": starts[w][0],
                "skip_samples": starts[w][1],
            }
            self._workers.append(_Worker(spec, per_worker_q))

    def _start_native(self, cursor: dict | None, start_epoch: int, process_index: int, process_count: int) -> None:
        """The native reader's stream, inline. Its sample order depends on
        the thread count, so a cursor records ``native_threads`` and a
        resume refuses a cursor of another thread count, or of the worker
        loader (another order)."""
        cfg = self.cfg
        if cursor is not None:
            saved = cursor.get("native_threads")
            if saved is None:
                raise ValueError(
                    "resume cursor was written by the subprocess-worker loader (different sample order); "
                    "restart with data.use_native=false or fall back to epoch resume"
                )
            if saved != cfg.native_io_threads:
                raise ValueError(
                    f"resume cursor was written with native_io_threads={saved} but the loader is configured "
                    f"with {cfg.native_io_threads} — the merged sample order differs; restart with the "
                    "checkpointed thread count"
                )
            start, skip = (int(x) for x in cursor["workers"][0])
            self.batches_yielded = int(cursor["batches"])
        else:
            start, skip = start_epoch, 0
            self.batches_yielded = 0
        self._native_threads = cfg.native_io_threads
        self._cursors = [(start, skip)]
        print(
            f"[data] train loader: native reader, {cfg.native_io_threads} reader thread(s), "
            f"{cfg.decode_threads} decode thread(s), decode backend {decode.backend()}, "
            f"resize backend {transforms.backend()}",
            flush=True,
        )
        track = StreamCursor(start, skip)
        self._stream = native_train_stream(
            cfg, process_index=process_index, process_count=process_count, start_epoch=start,
            skip_samples=skip, cursor=track,
        )
        self._inline = batch_train_samples(self._stream, self.batch_size, cfg.repeats, cursor=track)

    def snapshot(self) -> dict | None:
        """The resume cursor as of the last batch ``__next__`` returned; the
        native reader's also records its thread count."""
        if not self._cursors:
            return None
        snap = {"workers": [list(c) for c in self._cursors], "batches": self.batches_yielded}
        if self._native_threads is not None:
            snap["native_threads"] = self._native_threads
        return snap

    def shard_snapshot(self) -> dict | None:
        """This process's consumed-shard state merged across its streams,
        as of the last batch returned: ``{"epochs": {str(epoch): [gidx]}}``;
        ``None`` on the native reader (no shard-boundary accounting)."""
        if not self._shard_states:
            return None
        merged = merge_shard_states(self._shard_states)
        return {"epochs": {str(e): sorted(v) for e, v in merged.items()}}

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        t_wait = time.perf_counter()
        if self._inline is not None:
            batch = next(self._inline)
            slot = 0
        else:
            slot = self.batches_yielded % len(self._workers)
            w = self._workers[slot]
            attempts_left = 120  # x 5 s = 10 min of silence before giving up
            while True:
                if w.dead and w.queue.empty():
                    # skipping a dead worker would fork the batch sequence
                    # away from the deterministic schedule
                    raise RuntimeError(f"data worker {slot} died; deterministic stream lost")
                try:
                    batch = w.queue.get(timeout=5)
                    break
                except queue_mod.Empty:
                    attempts_left -= 1
                    if attempts_left <= 0:
                        raise RuntimeError(f"data worker {slot} alive but produced nothing for 10 minutes") from None
        self.wait_s += time.perf_counter() - t_wait
        cur = batch.pop("_cursor", None)
        if cur is not None:
            self._cursors[slot] = (int(cur[0]), int(cur[1]))
        sh = batch.pop("_shards", None)
        if sh is not None:
            self._shard_states[slot] = sh
        self.batches_yielded += 1
        return batch

    def close(self):
        for w in self._workers:
            w.stop()
        self._workers.clear()
        if self._inline is not None:
            self._inline.close()
            self._inline = None
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def valid_loader(
    cfg: DataConfig, batch_size: int, *, process_index: int = 0, process_count: int = 1
) -> Iterator[dict[str, np.ndarray]]:
    """A fresh sequential eval iterator (build one per evaluation). With
    ``cfg.valid_cache`` set, the first pass fills the on-disk sample cache
    (``data/valcache.py``) and every later pass streams from it without
    opening a shard."""
    stream = valid_sample_stream(cfg, process_index=process_index, process_count=process_count)
    if cfg.valid_cache:
        cache = ValidSampleCache(
            cfg.valid_cache,
            key_fields={
                "shards": expand_shards(cfg.valid_shards),
                "image_size": cfg.image_size,
                "test_crop_ratio": cfg.test_crop_ratio,
                "process_index": process_index,
                "process_count": process_count,
            },
            image_size=cfg.image_size,
        )
        stream = cache.read() if cache.complete() else cache.capture(stream)
    return batch_valid_samples(stream, batch_size, cfg.image_size)


def split_for_accum(batch: dict, grad_accum: int) -> dict:
    """Reshape (B, ...) leaves to (accum, B/accum, ...) for gradient
    accumulation."""
    if grad_accum <= 1:
        return batch
    return {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:]) for k, v in batch.items()}


def prefetch_to_device(it: Iterator[dict], device="cuda", buffer_size: int = 2) -> Iterator[dict]:
    """Host → device copies that overlap the step: each batch's arrays are
    staged in pinned host memory and copied with ``non_blocking=True`` on a
    side CUDA stream, ``buffer_size`` batches ahead of the consumer. The
    consumer's stream waits on one event per batch, and ``record_stream``
    ties every tensor's memory to that stream. On the CPU the batches pass
    through as they are."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        yield from it
        return
    side = torch.cuda.Stream(device=dev)

    def put(batch: dict):
        out = {}
        with torch.cuda.stream(side):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
                out[k] = host.pin_memory().to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def get(entry) -> dict:
        out, ready = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ready)
        for t in out.values():
            t.record_stream(consumer)
        return out

    pending: deque = deque()
    for batch in it:
        pending.append(put(batch))
        if len(pending) > buffer_size:
            yield get(pending.popleft())
    while pending:
        yield get(pending.popleft())
