"""Crash flight recorder: a ring buffer of recent step diagnostics + events,
dumped to ``<workdir>/flightrec-<ts>-<seq>-<reason>.json`` when something
goes wrong (``flightrec-h<i>-...`` on non-zero hosts of a multi-process run —
every host records and dumps its own black box into the shared run dir).
Counterpart of ``jumbo_mae_tpu_tpu/obs/flightrec.py``: the same ring
bounds, file names, dump shape and hook chains.

The journal (``obs/journal.py``) records *log-cadence* snapshots durably;
the flight recorder keeps the last N *per-step* diagnostics in memory —
too chatty to fsync every step, exactly what you want written out the
moment a step goes non-finite, the sentinel rolls back, a SIGTERM lands,
or an exception escapes the step loop. Like an aircraft black box: cheap
to feed, only materialized on impact.

Triggers (the train loop calls :meth:`dump` for the first two; ``install``
hooks the rest):

- non-finite / skipped step observed at a log boundary
- sentinel rollback (every rollback leaves a record)
- SIGTERM — chained in FRONT of any existing handler (the preemption
  guard's graceful-checkpoint flow still runs after the dump)
- unhandled exception — ``sys.excepthook`` chain, plus an ``atexit``
  fallback that fires only when an abnormal condition was recorded but no
  dump was ever written (an exception swallowed upstream).

All hooks are reversible (:meth:`uninstall`) so in-process test runs and
repeated ``train()`` calls never leak handlers.
"""

from __future__ import annotations

import atexit
import json
import signal
import sys
import threading
import time
from collections import deque
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.journal import _json_default, _sanitize


class FlightRecorder:
    """Bounded in-memory recorder with on-demand JSON dumps.

    ``record_step``/``record_event`` are O(1) deque appends under one lock
    (the step loop and a signal handler may race); ``dump`` snapshots and
    writes atomically-enough (tmp + rename) so a dump interrupted by the
    dying process never leaves a half-JSON at the final name.
    """

    def __init__(
        self,
        workdir: str | Path,
        *,
        capacity: int = 256,
        event_capacity: int = 128,
        host: int = 0,
    ):
        self.workdir = Path(workdir)
        # non-zero hosts tag their dump filenames (flightrec-h<i>-...) so a
        # pod-wide incident leaves one attributable black box per host in the
        # shared run dir; host 0 keeps the historical name unchanged
        self.host = int(host)
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=max(1, int(capacity)))
        self._events: deque = deque(maxlen=max(1, int(event_capacity)))
        self._dumps: list[str] = []
        self._dump_seq = 0
        self._abnormal = False
        self._prev_handlers: dict = {}
        self._prev_excepthook = None
        self._installed = False

    # ------------------------------------------------------------- feeding

    def record_step(self, step: int, payload: dict) -> None:
        with self._lock:
            self._steps.append({"step": int(step), **payload})

    def record_event(self, event: dict) -> None:
        with self._lock:
            self._events.append(dict(event))

    def mark_abnormal(self) -> None:
        """Arm the atexit fallback: something bad was seen; if nothing ever
        dumps before exit, the atexit hook writes one last record."""
        self._abnormal = True

    def ring_bytes(self) -> int:
        """Shallow byte estimate of the in-memory rings — the accounting
        probe ``obs/memwatch.py`` registers as the ``flightrec_ring``
        component. Shallow ``getsizeof`` per entry (container overhead, not
        deep payload bytes): cheap enough to run per log window, and it
        tracks ring *growth*, which is all the leak sentinel needs."""
        import sys as _sys

        with self._lock:
            entries = list(self._steps) + list(self._events)
        return sum(_sys.getsizeof(e) for e in entries)

    # ------------------------------------------------------------- dumping

    @property
    def dumps(self) -> list[str]:
        with self._lock:
            return list(self._dumps)

    def dump(self, reason: str, *, extra: dict | None = None) -> Path:
        """Write the black box now; returns the file path. Always writes a
        new file (timestamped + sequence-numbered), never overwrites."""
        with self._lock:
            steps = list(self._steps)
            events = list(self._events)
            self._dump_seq += 1
            seq = self._dump_seq
        self.workdir.mkdir(parents=True, exist_ok=True)
        ts = time.strftime("%Y%m%d-%H%M%S")
        tag = "" if self.host == 0 else f"h{self.host}-"
        path = self.workdir / f"flightrec-{tag}{ts}-{seq:02d}-{reason}.json"
        payload = {
            "reason": reason,
            "host": self.host,
            "written_at": round(time.time(), 3),
            "steps": _sanitize(steps),
            "events": _sanitize(events),
        }
        if extra:
            payload["extra"] = _sanitize(extra)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(
            json.dumps(payload, default=_json_default, allow_nan=False)
        )
        tmp.rename(path)
        with self._lock:
            self._dumps.append(str(path))
        return path

    # ----------------------------------------------------------- installers

    def install(self, *, signals=(signal.SIGTERM,)) -> bool:
        """Hook SIGTERM + ``sys.excepthook`` + atexit. Handlers chain to
        whatever was installed before (the preemption guard keeps working).
        Returns False when not on the main thread (signals unavailable)."""
        if self._installed:
            return True
        ok = True
        for sig in signals:
            try:
                prev = signal.getsignal(sig)
                signal.signal(sig, self._make_signal_handler(sig, prev))
                self._prev_handlers[sig] = prev
            except ValueError:  # not the main thread
                ok = False
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        atexit.register(self._atexit)
        self._installed = True
        return ok

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                # only restore if OUR handler is still installed — someone
                # (e.g. the guard's force-exit path) may have replaced it
                current = signal.getsignal(sig)
                if getattr(current, "__flightrec__", False):
                    signal.signal(sig, prev)
            except ValueError:  # pragma: no cover - teardown off-main-thread
                pass
        self._prev_handlers.clear()
        # a bound method is a new object at each access: `==` compares the
        # function and the recorder, `is` would never match
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook
        self._prev_excepthook = None
        try:
            atexit.unregister(self._atexit)
        except Exception:  # pragma: no cover - registry already torn down
            pass
        self._installed = False

    def _make_signal_handler(self, sig, prev):
        def handler(signum, frame):
            try:
                self.dump(f"signal_{signum}")
            except Exception:  # noqa: BLE001 - never mask the signal flow
                pass
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                # re-deliver with default semantics (terminate)
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

        handler.__flightrec__ = True
        return handler

    def _excepthook(self, etype, value, tb):
        try:
            self.dump(
                "exception",
                extra={"error": f"{etype.__name__}: {value}"},
            )
        except Exception:  # noqa: BLE001 - never mask the real traceback
            pass
        hook = self._prev_excepthook or sys.__excepthook__
        hook(etype, value, tb)

    def _atexit(self) -> None:
        # last-chance dump: abnormal condition seen, nothing ever written
        with self._lock:
            pending = self._abnormal and not self._dumps
        if pending:
            try:
                self.dump("atexit")
            except Exception:  # noqa: BLE001 - interpreter is shutting down
                pass
