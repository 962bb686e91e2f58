"""Append-only, crash-safe JSONL run journal.

Counterpart of ``jumbo_mae_tpu_tpu/obs/journal.py``: the same segments,
rotation, event schema and readers, so a journal written by either
package reads the same in the other. The in-memory metrics registry dies
with the process; the journal is the part of a run's history that
*survives* — one fsync'd JSON line per event, written under
``<run_dir>/journal/``, readable offline long after the run (or the host)
is gone. In the port the batch jobs (``batch/job.py``) write it and
``tools/batch_doctor.py`` reads it; the training and serving events below
are the schema's, wired as their layers are ported (ROADMAP A7).

Event shape: every line is ``{"ts": epoch_s, "seq": n, "type": t, ...}``.
The wired event types (free-form types are allowed):

- ``run_start``        — full config dict + environment fingerprint
- ``step``             — log-cadence metric snapshot (loss, grad_norm,
  throughput, data-wait fraction, per-layer-group diag stats when enabled)
- ``checkpoint_save``  — a checkpoint left the step loop
- ``sentinel_bad_step`` / ``sentinel_loss_spike`` — per-step sentinel
  verdicts (exact step indices, unlike the windowed ``step`` snapshots)
- ``rollback``         — sentinel rollback: from/to steps, budget used
- ``quarantine``       — shard URLs the retry layer gave up on
- ``flight_record``    — a flight-recorder dump was written (with its path)
- ``shutdown``         — how the run ended (completed / preempted /
  exception / diverged)

Crash-safety contract:

- every ``event()`` is flushed AND fsync'd before returning — a SIGKILL
  loses at most the line being written, never a prior one;
- a torn final line (the process died mid-write) is *skipped* by
  :func:`read_journal`, never an error;
- rotation starts a new numbered segment (``journal-00001.jsonl`` …) and
  never rewrites an old one; a restarted run opens a fresh segment, so a
  torn tail can never be appended after.

Multi-host: every process writes its OWN journal — host 0 under
``<run_dir>/journal/``, host *i* under ``<run_dir>/journal-host<i>/`` —
and every row carries a ``host`` field (the writer). There is no shared
write path to coordinate; :func:`read_merged_journal` merges the per-host
streams offline, ordered by ``(ts, host, seq)`` and tolerant of a torn
tail in any one host's segment (a host SIGKILLed mid-line costs that line,
nothing else).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path

_SEGMENT_PREFIX = "journal-"
_SEGMENT_SUFFIX = ".jsonl"
_HOST_DIR_RE = re.compile(r"^journal-host(\d+)$")

# The frozen event schema: every event type the project emits with a
# literal name. Free-form types still *work* (the writer doesn't validate
# at runtime — a crash-safe log must never refuse a row), but readers
# and doctors treat this set as the contract. The JAX package's set.
JOURNAL_EVENTS = frozenset(
    {
        "run_start",
        "step",
        "checkpoint_save",
        "sentinel_bad_step",
        "sentinel_loss_spike",
        "rollback",
        "quarantine",
        "flight_record",
        "compiled_program",
        "profile",
        "shutdown",
        "fleet_straggler",
        "fleet_host_lost",
        "fleet_host_rejoined",
        "retrace",
        "lock_order_violation",
        "mem_sample",
        "mem_leak_suspect",
        "autoscale",
        "replica_added",
        "replica_removed",
        "replica_preempted",
        "tenant_usage",
        "job_start",
        "job_lease",
        "job_cursor",
        "job_shard_done",
        "job_complete",
        "publish",
        "publish_skipped",
        "publish_failed",
        # elastic fleet training (train/elastic.py + cli/train.py)
        "hang_detected",
        "host_lost",
        "elastic_restart",
        "elastic_resize",
        "elastic_rejoin",
        "elastic_exhausted",
        "ckpt_fallback",
        "shard_cursor",
        # goodput accounting (obs/goodput.py): cumulative wall-clock
        # attribution snapshots, journaled at checkpoint boundaries, on
        # hang detection, and at shutdown
        "goodput_report",
    }
)


def fsync_dir(path: "str | Path") -> None:
    """fsync a directory so a just-renamed (or just-created) entry survives
    power loss — ``os.replace`` alone only orders the rename against other
    operations on the *file*; the new directory entry itself is volatile
    until the parent directory's metadata reaches disk. Best-effort: on
    filesystems/platforms that refuse directory fds the rename still
    happened, we just lose the power-loss guarantee we never had before.
    """
    try:
        fd = os.open(str(path), os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - e.g. fsync on FAT/network mounts
        pass
    finally:
        os.close(fd)


def _json_default(obj):
    """Journal payloads carry numpy scalars/arrays and Paths; make them JSON."""
    import numpy as np

    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, Path):
        return str(obj)
    return repr(obj)


def _sanitize(value):
    """JSON refuses NaN/Inf under allow_nan=False; the journal must encode a
    non-finite loss (it's the whole point) — stringify them."""
    if isinstance(value, float):
        if value != value:
            return "nan"
        if value in (float("inf"), float("-inf")):
            return "inf" if value > 0 else "-inf"
        return value
    if isinstance(value, dict):
        return {k: _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return value


class RunJournal:
    """Writer half: fsync-per-line JSONL segments with size-based rotation.

    Writes are serialized by one lock — the train loop owns the cadence,
    but the fleet aggregator emits transition events from the exporter's
    scrape thread (the fsync is the cost ceiling, not the lock). With
    ``host`` set, every record carries it so merged multi-host reads can
    attribute rows.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        max_bytes: int = 4 * 1024 * 1024,
        keep: int = 64,
        fsync: bool = True,
        host: int | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self.fsync = bool(fsync)
        self.host = None if host is None else int(host)
        self._lock = threading.Lock()
        self._seq = 0
        # a restarted run continues in a NEW segment after the highest
        # existing index — an old torn tail stays torn, ordering by
        # filename stays total
        self._index = self._next_index()
        self._file = open(self._segment_path(self._index), "a", encoding="utf-8")
        if self.fsync:
            # the segment's directory entry must be durable too: fsync'd
            # lines inside a file whose name was lost to power loss are gone
            fsync_dir(self.directory)

    def _next_index(self) -> int:
        existing = sorted(self.directory.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}"))
        if not existing:
            return 0
        last = existing[-1].name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
        try:
            return int(last) + 1
        except ValueError:  # foreign file matching the glob
            return len(existing)

    def _segment_path(self, index: int) -> Path:
        return self.directory / f"{_SEGMENT_PREFIX}{index:05d}{_SEGMENT_SUFFIX}"

    @property
    def path(self) -> Path:
        """The segment currently being appended to."""
        return self._segment_path(self._index)

    def event(self, etype: str, **fields) -> dict:
        """Append one event; returns the record as written (post-sanitize)."""
        with self._lock:
            rec = {
                "ts": round(time.time(), 3),
                "seq": self._seq,
                "type": etype,
            }
            if self.host is not None:
                rec["host"] = self.host
            rec.update(_sanitize(fields))
            line = json.dumps(
                rec, default=_json_default, separators=(",", ":"), allow_nan=False
            )
            self._file.write(line + "\n")
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._seq += 1
            if self._file.tell() >= self.max_bytes:
                self._rotate()
            return rec

    def _rotate(self) -> None:
        self._file.close()
        self._index += 1
        self._file = open(self._segment_path(self._index), "a", encoding="utf-8")
        if self.fsync:
            fsync_dir(self.directory)
        # prune the oldest segments beyond the retention budget
        segments = sorted(self.directory.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}"))
        for old in segments[: max(0, len(segments) - self.keep)]:
            try:
                old.unlink()
            except OSError:  # pragma: no cover - concurrent cleanup
                pass

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())
                self._file.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def journal_dir(path: str | Path) -> Path | None:
    """Resolve a user-supplied path (run dir, journal dir, or one segment
    file) to the journal location, or None when there is no journal there."""
    p = Path(path)
    if p.is_file():
        return p
    if p.is_dir():
        if list(p.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")):
            return p
        sub = p / "journal"
        if sub.is_dir() and list(sub.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")):
            return sub
    return None


def read_journal(path: str | Path) -> list[dict]:
    """Reader half: every parseable event across all segments, in order.

    Tolerates exactly the damage a crash can cause: a torn final line
    (partial write + SIGKILL) is skipped; any other unparseable line is
    skipped too rather than aborting the whole read — a diagnosis from 999
    events beats an exception over 1. Raises ``FileNotFoundError`` only when
    there is no journal at ``path`` at all.
    """
    loc = journal_dir(path)
    if loc is None:
        raise FileNotFoundError(f"no journal segments under {path}")
    files = [loc] if loc.is_file() else sorted(
        loc.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")
    )
    events: list[dict] = []
    for f in files:
        text = f.read_bytes().decode("utf-8", errors="replace")
        for line in text.split("\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail or damaged line — skip, keep reading
            if isinstance(rec, dict):
                events.append(rec)
    return events


def _host_of_journal_dir(d: Path) -> int:
    m = _HOST_DIR_RE.match(d.name)
    return int(m.group(1)) if m else 0


def read_merged_journal(path: str | Path) -> list[dict]:
    """Merged multi-host read: every parseable event from host 0's
    ``journal/`` AND every ``journal-host<i>/`` under a run dir, ordered by
    ``(ts, host, seq)``. Rows missing a ``host`` field (pre-multi-host
    journals, hand-built fixtures) inherit the host index encoded in their
    directory name (``journal/`` → 0), so legacy journals read identically.

    Accepts the same inputs as :func:`read_journal` — a run dir, one journal
    dir, or one segment file — and degrades to exactly its behavior (plus
    the ordering pass) when there is only one host's journal to read. Torn
    lines are per-segment, so one host dying mid-write never hides another
    host's rows. Raises ``FileNotFoundError`` when no journal exists at all.
    """
    p = Path(path)
    dirs: list[Path] = []
    if p.is_dir() and not list(p.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")):
        # a run dir: collect host-0's journal/ plus every journal-host<i>/
        cand = [p / "journal"] + sorted(
            (d for d in p.glob("journal-host*") if d.is_dir()),
            key=_host_of_journal_dir,
        )
        dirs = [
            d
            for d in cand
            if d.is_dir() and list(d.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}"))
        ]
    if not dirs:
        # single file / single journal dir → read_journal's resolution rules
        events = read_journal(p)
        inferred = _host_of_journal_dir(p) if p.is_dir() else 0
        for e in events:
            e.setdefault("host", inferred)
    else:
        events = []
        for d in dirs:
            h = _host_of_journal_dir(d)
            for e in read_journal(d):
                e.setdefault("host", h)
                events.append(e)
    events.sort(
        key=lambda e: (e.get("ts", 0.0), e.get("host", 0), e.get("seq", 0))
    )
    return events


def env_fingerprint() -> dict:
    """What was this process, exactly? Enough to tell two restarts apart and
    to blame a config/environment change across a divergence boundary.
    The JAX package's fingerprint with torch's versions, device and
    process count in place of jax's."""
    import platform
    import socket
    import sys

    from jumbo_mae_tpu_tpu_torch import __version__

    info = {
        "version": __version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
    }
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        available = torch.cuda.is_available()
        info["backend"] = "cuda" if available else "cpu"
        info["device_count"] = torch.cuda.device_count() if available else 0
        if available:
            info["device"] = torch.cuda.get_device_name(0)
        dist = torch.distributed
        initialized = dist.is_available() and dist.is_initialized()
        info["process_count"] = dist.get_world_size() if initialized else 1
    except Exception:  # noqa: BLE001 - fingerprint must never fail a run
        info["torch"] = "unavailable"
    for var in ("GRAFT_FAULTS", "GRAFT_HOST", "JUMBO_WARMCACHE", "JUMBO_WARMCACHE_DIR"):
        if os.environ.get(var):
            info.setdefault("env", {})[var] = os.environ[var]
    return info
