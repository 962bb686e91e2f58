"""Step-deadline hang watchdog: turn a wedged step into a fast death with
an exit code of its own (``EXIT_HANG``, 44) that a supervisor can act on.

Counterpart of ``jumbo_mae_tpu_tpu/obs/hangwatch.py``, the same class and
firing rules. Why exit instead of recover in-process: a step blocked in a
collective or a wedged device call cannot be cancelled from Python — the
thread is parked waiting for something that will never answer. The only
useful move is to die *quickly* and *legibly*: journal a
``hang_detected`` event, give the checkpoint writer a bounded chance to
drain, and ``os._exit`` with a code that means "restart me", not "I
crashed".

Shape:

- :meth:`HangWatchdog.beat` is called from the step loop (pre-step hook)
  and resets the deadline. No beat for ``deadline_s`` seconds → fire.
- :meth:`HangWatchdog.expected` mirrors the retrace sentinel's
  ``expected()`` pattern: a re-entrant pause window for phases that are
  legitimately slow (eval, checkpoint restore and saves, an iterator
  restart). While any window is open the deadline is suspended, and the
  clock restarts from the moment the last window closes.
- :meth:`HangWatchdog.check` contains *all* firing logic and takes the
  current time as an argument, so unit tests drive it with a fake clock
  and never need the poll thread. The thread (:meth:`start`) just calls
  ``check(clock())`` every ``poll_s``.
- Fires at most once (latched), even with a racing poll thread.

The watchdog is per-process and knows nothing about a fleet: self-death
by deadline is the only detector that works on the wedged process itself.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Callable

#: Default exit code — kept equal to ``train.engine.EXIT_HANG`` (pinned by
#: a unit test; obs must not import train).
DEFAULT_EXIT_CODE = 44


class HangWatchdog:
    """Deadline watchdog over step progress (see module docstring).

    ``on_fire(info)`` callbacks run in firing order before the drain; they
    must be fast and exception-safe (exceptions are swallowed — the exit
    must happen). ``drain()`` is the bounded checkpoint drain hook (e.g.
    ``Checkpointer.wait``); it runs in a side thread joined with
    ``drain_timeout_s`` so a wedged checkpoint write cannot turn the
    watchdog itself into a hang. ``exit_fn`` defaults to ``os._exit`` —
    ``sys.exit`` would only unwind the watchdog thread, and atexit
    machinery may block on the same wedged call.
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        clock: Callable[[], float] = time.monotonic,
        exit_code: int = DEFAULT_EXIT_CODE,
        exit_fn: Callable[[int], None] = os._exit,
        drain: Callable[[], None] | None = None,
        drain_timeout_s: float = 30.0,
        poll_s: float = 1.0,
    ):
        self.deadline_s = float(deadline_s)
        self.exit_code = int(exit_code)
        self._clock = clock
        self._exit_fn = exit_fn
        self._drain = drain
        self.drain_timeout_s = float(drain_timeout_s)
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._armed = False
        self._fired = False
        self._expected_depth = 0
        self._last_beat = float(clock())
        self._last_step = 0
        self._on_fire: list[Callable[[dict], None]] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- registration / lifecycle ----------------------------------------
    def on_fire(self, fn: Callable[[dict], None]):
        """Register ``fn(info)`` to run when the deadline trips (before the
        drain and the exit). Usable as a decorator."""
        self._on_fire.append(fn)
        return fn

    def arm(self) -> None:
        """Start enforcing the deadline, measured from now."""
        with self._lock:
            self._armed = True
            self._last_beat = float(self._clock())

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def beat(self, step: int | None = None) -> None:
        """Record step progress; resets the deadline."""
        with self._lock:
            self._last_beat = float(self._clock())
            if step is not None:
                self._last_step = int(step)

    @contextmanager
    def expected(self, reason: str = ""):
        """Re-entrant pause window for legitimately slow phases (eval,
        restore, saves) — mirrors ``RetraceSentinel``."""
        del reason  # documentation at the call site; not recorded
        with self._lock:
            self._expected_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._expected_depth -= 1
                # restart the clock: time spent inside the window is not
                # evidence of a wedge
                self._last_beat = float(self._clock())

    # -- firing logic ----------------------------------------------------
    def check(self, now: float | None = None) -> bool:
        """Evaluate the deadline at time ``now`` (defaults to the clock).
        Returns True iff this call fired the watchdog. All state reads and
        the fire latch happen under the lock; the side-effecting fire path
        runs outside it."""
        if now is None:
            now = float(self._clock())
        with self._lock:
            if (
                self._fired
                or not self._armed
                or self._expected_depth > 0
                or self.deadline_s <= 0
            ):
                return False
            stalled_s = now - self._last_beat
            if stalled_s < self.deadline_s:
                return False
            self._fired = True  # latch before releasing the lock
            info = {
                "stalled_s": round(stalled_s, 3),
                "deadline_s": self.deadline_s,
                "step": self._last_step,
            }
        self._fire(info)
        return True

    @property
    def fired(self) -> bool:
        with self._lock:
            return self._fired

    def _fire(self, info: dict) -> None:
        for fn in self._on_fire:
            try:
                fn(info)
            except Exception:  # noqa: BLE001 - the exit must happen
                pass
        if self._drain is not None:
            # Bounded drain: the checkpoint writer usually finishes, but if
            # it is itself wedged we must not hang here — the next resume's
            # fallback restore walks back past a torn step.
            t = threading.Thread(target=self._safe_drain, daemon=True)
            t.start()
            t.join(self.drain_timeout_s)
        self._exit_fn(self.exit_code)

    def _safe_drain(self) -> None:
        try:
            self._drain()  # type: ignore[misc]
        except Exception:  # noqa: BLE001
            pass

    # -- poll thread -----------------------------------------------------
    def start(self) -> None:
        """Spawn the daemon poll thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._poll, name="hangwatch", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the poll thread (does not reset the fired latch)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(self.poll_s * 2 + 1.0)
        self._thread = None

    def _poll(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self.check():
                return
