"""Streaming tar reading: URL → byte stream → grouped samples.

Counterpart of ``jumbo_mae_tpu_tpu/data/tario.py`` (standard library only).
A sample is all consecutive tar members sharing a basename stem:
``n01440764_10026.jpg`` + ``n01440764_10026.cls`` →
``{"__key__": "n01440764_10026", "jpg": b..., "cls": b...}``, so a shard
written by either package reads identically in the other.

Supported URL schemes (read and write): local paths and ``file://``;
``pipe:CMD`` (a shell command's stdout, or stdin for writing); ``gs://``
(sugar for the gsutil pipe); ``http(s)://`` (read only).

Shard-level read failures get retries with capped, jittered exponential
backoff (a retry resumes exactly past the samples already yielded) before
the shard is quarantined for the rest of the pass and recorded in
:data:`QUARANTINE`; corrupt members and truncated archives are skipped with
a warning. The JAX package's fault-injection sites and metric counters
belong to the platform layers (ROADMAP A7) and are not here.
"""

from __future__ import annotations

import io
import logging
import random
import shlex
import subprocess
import tarfile
import threading
import time
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

Sample = dict[str, bytes | str]


class TruncatedShardError(OSError):
    """A tar stream ended mid-archive. An ``OSError`` on purpose: the retry
    loop treats truncation as transient (a cut network read and a
    truncated file at rest look the same from here)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Shard-read retry knobs (``data.shard_retries`` /
    ``data.shard_retry_backoff_s`` in recipes)."""

    attempts: int = 3  # total tries per shard per pass
    backoff_s: float = 0.05  # first sleep; doubles per retry
    max_backoff_s: float = 5.0
    jitter: float = 0.25  # +- fraction of the sleep, decorrelates workers

    def sleep_s(self, retry_index: int, rng: random.Random) -> float:
        base = min(self.backoff_s * (2.0**retry_index), self.max_backoff_s)
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


class ShardQuarantine:
    """Process-wide record of shards given up on (after retries). The skip
    decision is per pass — each epoch retries a previously bad shard — but
    the record accumulates, for the operator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: dict[str, str] = {}

    def add(self, url: str, reason: str) -> None:
        with self._lock:
            self._items[url] = reason

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            return dict(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


QUARANTINE = ShardQuarantine()


@contextmanager
def open_url(url: str, mode: str = "rb"):
    """Open a shard URL as a (possibly piped) binary stream."""
    if mode not in ("rb", "wb"):
        raise ValueError(f"mode must be rb/wb, got {mode!r}")
    write = mode == "wb"
    if url.startswith("pipe:"):
        cmd = url[len("pipe:") :]
        proc = subprocess.Popen(
            cmd,
            shell=True,
            stdin=subprocess.PIPE if write else None,
            stdout=None if write else subprocess.PIPE,
        )
        stream = proc.stdin if write else proc.stdout
        try:
            yield stream
        finally:
            stream.close()
            ret = proc.wait()
            if ret != 0:
                raise RuntimeError(f"pipe command failed ({ret}): {cmd}")
        return
    if url.startswith("gs://"):
        q = shlex.quote(url)
        pipe = f"pipe:gsutil cp - {q}" if write else f"pipe:gsutil cat {q}"
        with open_url(pipe, mode) as s:
            yield s
        return
    if url.startswith(("http://", "https://")):
        if write:
            raise ValueError("cannot write to http(s) URLs")
        import urllib.request

        with urllib.request.urlopen(url) as s:
            yield s
        return
    path = urlparse(url).path if url.startswith("file://") else url
    with open(path, mode) as s:
        yield s


def iter_tar(stream, *, strict: bool = False) -> Iterator[tuple[str, bytes]]:
    """Yield (member_name, payload) from a non-seekable tar stream.

    Corrupt members are skipped; a truncated archive stops the shard, and
    with ``strict=True`` raises :class:`TruncatedShardError` so the retry
    layer can read the shard again."""
    try:
        with tarfile.open(fileobj=stream, mode="r|*") as tar:
            for member in tar:
                if not member.isreg():
                    continue
                f = tar.extractfile(member)
                if f is None:
                    continue
                try:
                    yield member.name, f.read()
                except tarfile.TarError as e:  # corrupt member: skip
                    logger.warning("skipping corrupt member %s: %s", member.name, e)
    except tarfile.TarError as e:  # truncated archive: stop this shard
        logger.warning("truncated/corrupt tar stream: %s", e)
        if strict:
            raise TruncatedShardError(str(e)) from e


def _split_member(name: str) -> tuple[str, str]:
    """``dir/key.ext`` → (``dir/key``, ``ext``); the extension is everything
    after the FIRST dot of the basename (webdataset's convention)."""
    slash = name.rfind("/")
    dot = name.find(".", slash + 1)
    if dot < 0:
        return name, ""
    return name[:dot], name[dot + 1 :].lower()


def group_samples(members: Iterator[tuple[str, bytes]]) -> Iterator[Sample]:
    """Group consecutive members with a shared stem into sample dicts."""
    current: Sample = {}
    key: str | None = None
    for name, payload in members:
        stem, ext = _split_member(name)
        if stem != key:
            if current:
                yield current
            current, key = {"__key__": stem}, stem
        current[ext] = payload
    if current:
        yield current


def iter_tar_samples(url: str, retry: RetryPolicy | None = None) -> Iterator[Sample]:
    """Stream one shard URL as grouped samples; never raises on bad data.

    Transient read failures (``OSError``, truncation included, and pipe
    ``RuntimeError``) are retried with capped, jittered backoff. A retry
    reads the shard again and resumes exactly past the samples already
    yielded (tar order is deterministic), so a shard that fails and then
    reads gives the same samples as a clean read. When every attempt
    fails the shard is added to :data:`QUARANTINE` and the stream moves on.
    """
    policy = retry or RetryPolicy()
    rng = random.Random(url)
    yielded = 0
    closing = False
    last_err: BaseException | None = None
    for attempt in range(max(1, policy.attempts)):
        try:
            with open_url(url) as stream:
                for i, sample in enumerate(group_samples(iter_tar(stream, strict=True))):
                    if i < yielded:  # replay of an already-consumed prefix
                        continue
                    yielded += 1
                    try:
                        yield sample
                    except GeneratorExit:
                        # the consumer closed us mid-shard; a pipe teardown
                        # may surface as RuntimeError below, not a failure
                        closing = True
                        raise
            return
        except (OSError, RuntimeError) as e:
            if closing:
                return
            last_err = e
            if attempt + 1 >= max(1, policy.attempts):
                break
            delay = policy.sleep_s(attempt, rng)
            logger.warning(
                "shard %s read failed (attempt %d/%d): %s — retrying in %.2fs",
                url, attempt + 1, policy.attempts, e, delay,
            )
            time.sleep(delay)
    logger.error("quarantining shard %s after %d attempts: %s", url, policy.attempts, last_err)
    QUARANTINE.add(url, f"{type(last_err).__name__}: {last_err}")


def iter_shards_samples(urls: list[str], retry: RetryPolicy | None = None) -> Iterator[Sample]:
    """Stream several shards back to back, tagging each sample with its
    ``__url__``. A shard that exhausts its retries is skipped for this
    pass; the others still stream."""
    for url in urls:
        for sample in iter_tar_samples(url, retry=retry):
            sample["__url__"] = url
            yield sample


def write_tar_samples(url: str, samples: list[Sample]) -> None:
    """Write samples to a tar shard (test fixtures; dataset preparation)."""
    with open_url(url, "wb") as stream:
        with tarfile.open(fileobj=stream, mode="w|") as tar:
            for sample in samples:
                key = str(sample["__key__"])
                for ext, payload in sample.items():
                    if ext.startswith("__"):
                        continue
                    if not isinstance(payload, bytes):
                        raise TypeError(f"sample {key!r} member {ext!r} must be bytes")
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))
