"""Lightweight host-side spans + chrome-trace export + the torch profiler.

Counterpart of ``jumbo_mae_tpu_tpu/obs/trace.py``. Three layers of
timing, cheapest first:

- :func:`span` — a ``with span("data_wait"):`` context that aggregates the
  duration into the registry's ``span_seconds{name=...}`` histogram. Always
  on (two ``perf_counter`` calls + one histogram observe).
- chrome-trace — ``start_chrome_trace()`` additionally buffers every span as
  a complete event; ``export_chrome_trace(path)`` writes the standard
  ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto open:
  the data waits and checkpoint stalls *between* the device's work.
- :func:`trace` / :func:`annotate` — ``torch.profiler`` over the host and,
  on a CUDA device, the card's kernels, written as a Chrome trace under a
  directory; ``annotate`` names a region in it
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

_SPAN_HELP = "host-side span durations by stage"


class _ChromeTracer:
    """Process-wide span event buffer (chrome trace 'X' complete events)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] | None = None  # None = disabled

    @property
    def enabled(self) -> bool:
        return self._events is not None

    def start(self) -> None:
        with self._lock:
            self._events = []

    def add(self, name: str, start_s: float, dur_s: float) -> None:
        evt = {
            "name": name,
            "ph": "X",
            "ts": start_s * 1e6,  # chrome trace timestamps are microseconds
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        with self._lock:
            if self._events is not None:
                self._events.append(evt)

    def export(self, path: str | Path) -> Path:
        with self._lock:
            events = list(self._events or [])
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}))
        return path

    def stop(self) -> None:
        with self._lock:
            self._events = None


_TRACER = _ChromeTracer()


def start_chrome_trace() -> None:
    """Begin buffering spans as chrome-trace events (clears prior events)."""
    _TRACER.start()


def stop_chrome_trace() -> None:
    _TRACER.stop()


def export_chrome_trace(path: str | Path) -> Path:
    """Write buffered span events as chrome://tracing / Perfetto JSON."""
    return _TRACER.export(path)


@contextmanager
def span(name: str, registry=None):
    """Time a host-side stage into ``span_seconds{name=...}`` (and the
    chrome-trace buffer when capturing). The histogram handle is resolved
    per entry — for per-step hot loops, hoist with :func:`span_timer`."""
    reg = registry if registry is not None else get_registry()
    hist = reg.histogram("span_seconds", _SPAN_HELP, labels=("name",)).labels(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        hist.observe(dur)
        if _TRACER.enabled:
            _TRACER.add(name, t0, dur)


class span_timer:  # noqa: N801 - context-manager factory, used like span()
    """Pre-resolved reusable span: same contract as :func:`span` but the
    histogram lookup happens once at construction — the shape for per-step
    loops (train step, data wait)."""

    __slots__ = ("name", "_hist", "_t0", "last_s")

    def __init__(self, name: str, registry=None):
        reg = registry if registry is not None else get_registry()
        self.name = name
        self._hist = reg.histogram("span_seconds", _SPAN_HELP, labels=("name",)).labels(name)
        self._t0 = 0.0
        self.last_s = 0.0  # duration of the most recent exit (loop bookkeeping)

    def __enter__(self) -> "span_timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._t0
        self.last_s = dur
        self._hist.observe(dur)
        if _TRACER.enabled:
            _TRACER.add(self.name, self._t0, dur)

    def observe(self, dur_s: float) -> None:
        """Record an externally measured duration under this span's name."""
        self._hist.observe(dur_s)
        if _TRACER.enabled:
            _TRACER.add(self.name, time.perf_counter() - dur_s, dur_s)


@contextmanager
def trace(log_dir: str | Path | None):
    """Profile the block with ``torch.profiler`` into a Chrome trace
    ``<log_dir>/profile-<pid>-<time>.json`` (no-op when ``log_dir`` is
    falsy): host operators and, where CUDA is available, the card's kernels
    by name. The export's path, bytes and seconds are printed."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        t0 = time.perf_counter()
        path = out / f"profile-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json"
        prof.export_chrome_trace(str(path))
        print(f"[obs] device profile -> {path} ({path.stat().st_size} bytes, exported in "
              f"{time.perf_counter() - t0:.2f} s)")


@contextmanager
def annotate(name: str):
    """Named region in the profile's timeline
    (``torch.profiler.record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield
