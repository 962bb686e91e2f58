"""Resumable offline-inference jobs: shard leases → replica tier → parts.

Counterpart of ``jumbo_mae_tpu_tpu/batch/job.py``: the same spec, runner,
journal events, metrics and part files, so the same shards and the same
deterministic submit give byte-equal parts and manifests in both packages.

A :class:`JobSpec` names tar shards, a task, and an output directory; the
:class:`BatchJobRunner` streams every sample of every shard through a
``ContinuousScheduler``-shaped submit function as a budget-capped
``batch``-class tenant and writes one durable part file per shard
(`batch/partfile.py`). The job is **killable at any instruction** and a
restart produces bit-identical output to a fault-free run:

- shards are claimed via journaled leases with expiry/steal
  (`batch/leases.py`) — a worker killed mid-shard (the ``batch.worker``
  fault site, or a whole SIGKILL'd process) just stops renewing, and a
  surviving worker steals the shard after ``lease_s``;
- per-shard progress is the count of durable frames in the ``.partial``
  file — the restarted worker truncates the torn tail, re-streams the
  shard, and skips exactly the written prefix (``iter_tar_samples`` resumes
  deterministically), so no sample is ever duplicated or dropped;
- shard completion atomically renames ``.partial`` → ``.part``
  (fsync + ``fsync_dir``); job completion writes the deterministic
  manifest. Both are journaled (``job_shard_done`` / ``job_complete``)
  alongside lease grants (``job_lease``) and progress cursors
  (``job_cursor``) for ``python -m jumbo_mae_tpu_tpu_torch.tools.batch_doctor``.

The runner takes the submit callable instead of building the serving stack
itself, so tests drive it with a deterministic stub and ``cli/batch.py``
drives it with the real scheduler + admission + replica pool.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from jumbo_mae_tpu_tpu_torch.batch.leases import LeaseTable
from jumbo_mae_tpu_tpu_torch.batch.partfile import (
    append_record,
    encode_record,
    file_sha256,
    finalize_part,
    read_manifest,
    scan_part,
    write_manifest,
)
from jumbo_mae_tpu_tpu_torch.data.tario import QUARANTINE, RetryPolicy, iter_tar_samples
from jumbo_mae_tpu_tpu_torch.faults.inject import fault_point
from jumbo_mae_tpu_tpu_torch.infer.batching import QueueFullError, ShutdownError
from jumbo_mae_tpu_tpu_torch.infer.replicaset import PoolUnhealthyError
from jumbo_mae_tpu_tpu_torch.obs.journal import RunJournal
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry


class _WorkerKilled(BaseException):
    """The ``batch.worker`` fault fired: this worker is dead. It must NOT
    release its lease — recovering the shard is the steal path's job."""


class _Fenced(Exception):
    """The worker's lease was stolen mid-shard (it renewed too late); it
    must stop writing immediately — the thief owns the partial file now."""


def part_stem(url: str) -> str:
    """Deterministic, filesystem-safe part name for one shard URL: the
    basename plus a short URL hash (two shards named ``data.tar`` in
    different directories must not collide)."""
    name = url.rsplit("/", 1)[-1] or "shard"
    if name.endswith(".tar"):
        name = name[:-4]
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    h = hashlib.sha256(url.encode("utf-8")).hexdigest()[:8]
    return f"{name}-{h}"


def default_decode(sample: dict, width: int = 256) -> np.ndarray:
    """Payload → fixed-shape uint8 vector (first member by sorted ext,
    zero-padded/truncated to ``width``). Fixed shape on purpose: the
    scheduler buckets by ``(task, shape)`` and the pool stacks batches.
    Real deployments pass a proper image decoder to the runner."""
    for ext in sorted(k for k in sample if not k.startswith("__")):
        raw = np.frombuffer(sample[ext][:width], dtype=np.uint8)
        if raw.size < width:
            raw = np.concatenate([raw, np.zeros(width - raw.size, np.uint8)])
        return raw
    return np.zeros(width, np.uint8)


@dataclass(frozen=True)
class JobSpec:
    """One offline inference job: shard list × task × output dir."""

    shards: tuple[str, ...]
    output_dir: str
    task: str = "features"
    tenant: str = "batch"
    workers: int = 2
    submit_window: int = 8       # samples in flight per worker
    lease_s: float = 30.0
    cursor_every: int = 32       # journal a job_cursor every N samples
    deadline_ms: float | None = None
    result_timeout_s: float = 60.0
    submit_timeout_s: float = 30.0  # budget for shed/heal retries per sample
    retry: RetryPolicy = field(default_factory=RetryPolicy)

    def __post_init__(self):
        if not self.shards:
            raise ValueError("JobSpec needs at least one shard")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if len(set(self.shards)) != len(self.shards):
            raise ValueError("duplicate shard URLs in JobSpec")
        object.__setattr__(self, "shards", tuple(self.shards))


class BatchJobRunner:
    """Shard-parallel, lease-fenced, resumable job executor.

    ``submit(image, *, task=, deadline_ms=, meta=, tenant=) -> Future`` is
    the :meth:`ContinuousScheduler.submit` shape; typed sheds
    (:class:`QueueFullError` subclasses — quota/pressure/budget) and a
    healing pool (:class:`PoolUnhealthyError`) are retried with backoff
    inside the per-sample submit budget, because a batch job's contract is
    throughput, not latency.
    """

    def __init__(
        self,
        spec: JobSpec,
        submit: Callable,
        *,
        decode: Callable[[dict], np.ndarray] | None = None,
        registry=None,
        journal: RunJournal | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = spec
        self._submit = submit
        self._decode = decode or default_decode
        self._clock = clock
        self.out = Path(spec.output_dir)
        self.parts_dir = self.out / "parts"
        self.parts_dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.out / "manifest.json"
        self.journal = journal or RunJournal(self.out / "journal")
        self._stop = threading.Event()
        self._errors: list[str] = []
        self._err_lock = threading.Lock()
        self._done: dict[str, dict] = {}   # shard -> {"part","samples","sha256"} | {"quarantined": True}
        self._done_lock = threading.Lock()
        self._steal_seen = 0

        reg = registry if registry is not None else get_registry()
        self._m_shards = reg.gauge(
            "batch_job_shards",
            "job work units by lease state (pending|leased|done)",
            labels=("state",),
        )
        self._m_samples = reg.counter(
            "batch_samples_processed_total",
            "samples computed and durably written by this job run",
        )
        self._m_resumed = reg.counter(
            "batch_samples_resumed_total",
            "samples skipped on (re)claim because a prior run already "
            "wrote them durably",
        )
        self._m_steals = reg.counter(
            "batch_lease_steals_total",
            "expired shard leases stolen from dead/stalled workers",
        )
        self._m_crashes = reg.counter(
            "batch_worker_crashes_total",
            "batch worker threads killed by the batch.worker fault site",
        )
        self._m_submit_retries = reg.counter(
            "batch_submit_retries_total",
            "sample submits retried after a typed shed or an unhealthy pool",
        )
        # eager children: every state scrapeable at zero from
        # construction, not from the first transition
        for state in ("pending", "leased", "done"):
            self._m_shards.labels(state)

    # ------------------------------------------------------------ control

    def request_stop(self) -> None:
        """Graceful preemption (SIGTERM): workers finish their in-flight
        window, release their leases, and exit; durable cursors mean a
        later run resumes sample-exactly."""
        self._stop.set()

    # ---------------------------------------------------------------- run

    def run(self) -> dict:
        """Execute (or resume) the job to completion; returns the summary.
        Safe to re-invoke after any crash — including after completion,
        when it just revalidates the manifest."""
        existing = read_manifest(self.manifest_path)
        if existing is not None:
            return self._summary(complete=True, already=True)

        table = LeaseTable(
            self.spec.shards, lease_s=self.spec.lease_s,
            clock=self._clock, journal=self.journal,
        )
        resumed = self._reconcile(table)
        self.journal.event(
            "job_start",
            shards=len(self.spec.shards),
            task=self.spec.task,
            tenant=self.spec.tenant,
            workers=self.spec.workers,
            output_dir=str(self.out),
            resumed_shards=resumed,
        )
        self._gauge(table)

        threads = [
            threading.Thread(
                target=self._worker, args=(f"w{i}", table),
                daemon=True, name=f"batch-worker-w{i}",
            )
            for i in range(self.spec.workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._gauge(table)

        if self._stop.is_set() and not table.done():
            self.journal.event(
                "shutdown", reason="preempted", **table.counts()
            )
            return self._summary(complete=False, table=table)
        if not table.done():
            # every worker exited with shards outstanding (all killed, or
            # a shard kept failing) — the job is resumable, not complete
            self.journal.event(
                "shutdown", reason="exception",
                errors=self._errors[-5:], **table.counts(),
            )
            return self._summary(complete=False, table=table)

        entries = []
        total = 0
        quarantined = []
        for shard in self.spec.shards:
            info = self._done.get(shard, {})
            if info.get("quarantined"):
                quarantined.append(shard)
                continue
            entries.append(
                {
                    "shard": shard,
                    "part": info["part"],
                    "samples": info["samples"],
                    "sha256": info["sha256"],
                }
            )
            total += info["samples"]
        manifest_sha = write_manifest(self.manifest_path, entries, total)
        self.journal.event(
            "job_complete",
            shards=len(entries),
            quarantined=len(quarantined),
            total_samples=total,
            manifest_sha256=manifest_sha,
            lease_steals=table.steals,
        )
        return self._summary(
            complete=True, table=table, quarantined=quarantined,
            manifest_sha=manifest_sha,
        )

    # ---------------------------------------------------------- internals

    def _reconcile(self, table: LeaseTable) -> int:
        """Rebuild shard state from the durable parts on disk — the files
        are the authority, the journal is observability. Returns how many
        shards were already complete."""
        done = 0
        for shard in self.spec.shards:
            stem = part_stem(shard)
            part = self.parts_dir / f"{stem}.part"
            if part.exists():
                n, good = scan_part(part)
                if good == part.stat().st_size and n > 0:
                    table.mark_done(shard)
                    with self._done_lock:
                        self._done[shard] = {
                            "part": part.name,
                            "samples": n,
                            "sha256": file_sha256(part),
                        }
                    self._m_resumed.inc(n)
                    done += 1
                    continue
                # damaged final part: demote it to a partial and recompute
                # the tail (its good prefix is still exactly-once durable)
                part.rename(self.parts_dir / f"{stem}.partial")
        return done

    def _gauge(self, table: LeaseTable) -> None:
        for state, n in table.counts().items():
            self._m_shards.labels(state).set(n)

    def _record_error(self, where: str, exc: BaseException) -> None:
        with self._err_lock:
            self._errors.append(f"{where}: {type(exc).__name__}: {exc}")

    def _worker(self, name: str, table: LeaseTable) -> None:
        backoff = 0.01
        while not self._stop.is_set():
            claim = table.claim(name)
            if claim is None:
                if table.done():
                    return
                # nothing claimable now — a live worker holds every
                # remaining lease; wait for completion or expiry/steal
                time.sleep(min(backoff, 0.1))
                backoff = min(backoff * 2, 0.1)
                continue
            backoff = 0.01
            shard, lease = claim
            self._sync_steal_metric(table)
            self._gauge(table)
            try:
                self._process_shard(name, table, shard, lease)
            except _WorkerKilled:
                self._m_crashes.inc()
                return  # dead: the lease expires, someone else steals it
            except _Fenced:
                continue  # the thief owns the shard now; claim another
            except ShutdownError as e:
                self._record_error(shard, e)
                table.release(shard, name, lease)
                return
            except BaseException as e:  # noqa: BLE001 — shard error: release and move on
                self._record_error(shard, e)
                table.release(shard, name, lease)
                time.sleep(0.05)
            finally:
                self._gauge(table)

    def _submit_sample(self, image: np.ndarray):
        """Submit with shed/heal retries — batch traffic waits rather than
        fails when the pool is contended or mid-restart."""
        deadline = self._clock() + self.spec.submit_timeout_s
        delay = 0.02
        while True:
            try:
                return self._submit(
                    image,
                    task=self.spec.task,
                    deadline_ms=self.spec.deadline_ms,
                    meta=None,
                    tenant=self.spec.tenant,
                )
            except (QueueFullError, PoolUnhealthyError):
                if self._stop.is_set() or self._clock() >= deadline:
                    raise
                self._m_submit_retries.inc()
                time.sleep(delay)
                delay = min(delay * 2, 0.5)

    def _process_shard(
        self, name: str, table: LeaseTable, shard: str, lease: int
    ) -> None:
        stem = part_stem(shard)
        partial = self.parts_dir / f"{stem}.partial"
        part = self.parts_dir / f"{stem}.part"
        fence = table.shard_fence(shard)
        with fence:
            if not table.holds(shard, name, lease):
                raise _Fenced(shard)
            cursor, good = scan_part(partial)
            if partial.exists() and good != partial.stat().st_size:
                with open(partial, "r+b") as f:
                    f.truncate(good)
        if cursor:
            self._m_resumed.inc(cursor)

        written = cursor
        window: list = []
        was_quarantined = shard in QUARANTINE.snapshot()

        def flush() -> None:
            nonlocal written
            if not window:
                return
            rows = [
                (key, fut.result(timeout=self.spec.result_timeout_s))
                for key, fut in window
            ]
            with fence:
                if not table.holds(shard, name, lease):
                    raise _Fenced(shard)
                with open(partial, "ab") as f:
                    for key, out in rows:
                        append_record(f, encode_record(key, out))
                    f.flush()
                    os.fsync(f.fileno())
                written += len(rows)
                table.renew(shard, name, lease)
            window.clear()
            self._m_samples.inc(len(rows))
            if written % self.spec.cursor_every < len(rows):
                self.journal.event(
                    "job_cursor", shard=shard, worker=name, samples=written
                )

        for i, sample in enumerate(
            iter_tar_samples(shard, retry=self.spec.retry)
        ):
            if i < cursor:
                continue  # durable from a previous incarnation
            try:
                fault_point("batch.worker", key=name)
            except BaseException as e:  # noqa: BLE001 — injected worker death
                raise _WorkerKilled(str(e)) from e
            key = str(sample.get("__key__", f"sample-{i}"))
            window.append((key, self._submit_sample(self._decode(sample))))
            if len(window) >= self.spec.submit_window:
                flush()
            if self._stop.is_set():
                flush()
                table.release(shard, name, lease)
                return
        flush()

        if shard in QUARANTINE.snapshot() and not was_quarantined:
            # the stream gave up on this shard mid-pass: keep the durable
            # prefix as a .partial (a healed store resumes it next run)
            # but count the shard handled so the job can terminate
            self.journal.event(
                "job_shard_done", shard=shard, worker=name,
                samples=written, status="quarantined",
            )
            with self._done_lock:
                self._done[shard] = {"quarantined": True, "samples": written}
            table.complete(shard, name, lease)
            return

        with fence:
            if not table.holds(shard, name, lease):
                raise _Fenced(shard)
            sha = finalize_part(partial, part)
            if not table.complete(shard, name, lease):
                raise _Fenced(shard)
        with self._done_lock:
            self._done[shard] = {
                "part": part.name, "samples": written, "sha256": sha,
            }
        self.journal.event(
            "job_shard_done", shard=shard, worker=name,
            samples=written, part=part.name, sha256=sha, status="ok",
        )
        self._sync_steal_metric(table)

    def _sync_steal_metric(self, table: LeaseTable) -> None:
        delta = table.steals - self._steal_seen
        if delta > 0:
            self._m_steals.inc(delta)
            self._steal_seen = table.steals

    def _summary(
        self, *, complete: bool, table: LeaseTable | None = None,
        already: bool = False, quarantined=None, manifest_sha: str | None = None,
    ) -> dict:
        manifest = read_manifest(self.manifest_path)
        total = manifest.get("total_samples", 0) if manifest else 0
        return {
            "complete": complete,
            "already_complete": already,
            "shards": len(self.spec.shards),
            "counts": table.counts() if table is not None else None,
            "total_samples": total,
            "quarantined": list(quarantined or []),
            "lease_steals": table.steals if table is not None else 0,
            "manifest": str(self.manifest_path) if manifest else None,
            "manifest_sha256": manifest_sha,
            "errors": list(self._errors),
        }
