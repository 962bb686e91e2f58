"""Stdlib-only HTTP exporter: Prometheus ``/metrics`` and ``/healthz``.

Counterpart of ``jumbo_mae_tpu_tpu/obs/exporter.py``: the same endpoints,
the same ``/healthz`` body and the same Prometheus text for the same
registry. ``cli/predict.py --metrics-port`` starts it. A scrape never
touches the hot path: it reads the registry under the same per-metric
locks the instrument sites use, so the worst contention is one lock
hand-off per metric per scrape.

``/healthz`` answers whether the process is *ready* (the engine or the
pool is up) and whether its loops are *live*: each liveness check is a
named heartbeat with a max age, registered by whoever owns the loop.
``build_info`` carries the port's version and torch's, where the JAX
exporter names its JAX version.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry, get_registry

# Process start (well, module import — the closest observable moment) for
# process_uptime_seconds: a scrape-visible restart detector. A counter that
# resets to ~0 tells the scraper "same target, new process" even when every
# app-level counter happens to be small.
_PROCESS_START = time.monotonic()


class HealthState:
    """Thread-safe readiness + liveness state behind ``/healthz``.

    Readiness is a single flag (set when the serving/training state is
    usable). Liveness is a set of named heartbeats: ``watch(name, max_age_s)``
    registers the requirement, ``beat(name)`` is the one-liner the owning
    loop calls. The report is unhealthy if not ready, or any watched
    heartbeat is older than its budget (a watched name never beaten is
    age-infinite, i.e. unhealthy — a loop that never started is not live).

    Named **info probes** (``probe(name, fn)``) attach extra read-only
    context to the report body — e.g. the data layer's quarantined-shard
    list — without affecting the health verdict; a probe that raises
    reports its error string instead of breaking the endpoint.
    """

    def __init__(self, *, ready: bool = False):
        self._lock = threading.Lock()
        self._ready = bool(ready)
        self._detail = ""
        self._max_age: dict[str, float] = {}
        self._beats: dict[str, float] = {}
        self._probes: dict[str, object] = {}
        self._degraded_fns: list = []

    def set_ready(self, ready: bool = True, detail: str = "") -> None:
        with self._lock:
            self._ready = bool(ready)
            self._detail = detail

    def watch(self, name: str, max_age_s: float) -> None:
        with self._lock:
            self._max_age[name] = float(max_age_s)

    def unwatch(self, name: str) -> None:
        """Drop a liveness requirement (e.g. the loader finished cleanly)."""
        with self._lock:
            self._max_age.pop(name, None)

    def beat(self, name: str) -> None:
        # monotonic: wall-clock jumps must not flip health
        self._beats[name] = time.monotonic()

    def probe(self, name: str, fn) -> None:
        """Attach a zero-arg callable whose JSON-able return value is
        included in the report body under ``info[name]``."""
        with self._lock:
            self._probes[name] = fn

    def degraded_when(self, fn) -> None:
        """Attach a zero-arg predicate (e.g. ``SLOTracker.degraded``,
        ``FleetAggregator.degraded``) whose truthiness feeds
        ``body["degraded"]``. Repeated calls *compose* — the body reports
        the OR of every registered predicate, so the SLO tracker, the
        replica breaker, and the fleet aggregator can all contribute
        without overwriting each other. Degraded is *soft*: the process is
        serving but missing its SLO — it must NOT flip the 503
        readiness/liveness verdict, or an autoscaler reacting to load
        would see its overloaded replicas drop out of rotation and make the
        overload worse."""
        with self._lock:
            self._degraded_fns.append(fn)

    def report(self) -> tuple[bool, dict]:
        now = time.monotonic()
        with self._lock:
            ready, detail = self._ready, self._detail
            watches = dict(self._max_age)
            probes = dict(self._probes)
            degraded_fns = list(self._degraded_fns)
        checks = {}
        ok = ready
        for name, budget in sorted(watches.items()):
            last = self._beats.get(name)
            age = None if last is None else now - last
            alive = age is not None and age <= budget
            ok = ok and alive
            checks[name] = {
                "age_s": None if age is None else round(age, 3),
                "max_age_s": budget,
                "ok": alive,
            }
        body = {"ok": ok, "ready": ready, "checks": checks}
        if degraded_fns:
            degraded: bool | str = False
            for fn in degraded_fns:
                try:
                    if fn():
                        degraded = True
                        break
                except Exception as e:  # noqa: BLE001 — never break /healthz
                    # an erroring probe only reports when no other says True
                    if degraded is False:
                        degraded = f"probe error: {type(e).__name__}: {e}"
            body["degraded"] = degraded
        if probes:
            info = {}
            for name, fn in sorted(probes.items()):
                try:
                    info[name] = fn()
                except Exception as e:  # noqa: BLE001 — never break /healthz
                    info[name] = f"probe error: {type(e).__name__}: {e}"
            body["info"] = info
        if detail:
            body["detail"] = detail
        return ok, body


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            pre = getattr(self.server, "pre_scrape", None)
            if pre is not None:
                pre()  # refresh scrape-time gauges (uptime)
            body = self.server.registry.render().encode()
            self._reply(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            ok, report = self.server.health.report()
            body = (json.dumps(report) + "\n").encode()
            self._reply(200 if ok else 503, body, "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # scrapes must not spam the training log


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    registry: MetricsRegistry
    health: HealthState
    pre_scrape = None  # optional zero-arg callable run before each /metrics


class TelemetryServer:
    """The exporter: serve ``registry`` and ``health`` over HTTP in a daemon
    thread. ``port=0`` binds any free port (tests/CI); the bound port is
    ``self.port`` after ``start()``. Use as a context manager or ``close()``.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        health: HealthState | None = None,
        *,
        host: str = "0.0.0.0",
        port: int = 9100,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.health = health if health is not None else HealthState(ready=True)
        self.host = host
        self.port = int(port)
        self._httpd: _Server | None = None
        self._thread: threading.Thread | None = None
        self._pre_scrape: list = []

    def add_pre_scrape(self, fn) -> None:
        """Register a zero-arg callable run before every ``/metrics`` render
        (scrape-time gauge refresh — uptime, SLO evaluation). Safe to call
        before or after ``start()``; a hook that raises is swallowed so one
        broken refresher cannot take down the scrape."""
        self._pre_scrape.append(fn)

    def _run_pre_scrape(self) -> None:
        for fn in list(self._pre_scrape):
            try:
                fn()
            except Exception:  # noqa: BLE001 — scrape must survive hooks
                pass

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = _Server((self.host, self.port), _Handler)
        httpd.registry = self.registry
        httpd.health = self.health
        # restart-distinguishing metadata: build_info{version,torch_version}=1
        # (the Prometheus info-metric idiom) and a scrape-time-refreshed
        # process uptime gauge. Registered at start() so a NullRegistry A/B
        # stays no-op.
        import torch

        from jumbo_mae_tpu_tpu_torch import __version__

        self.registry.gauge(
            "build_info",
            "constant 1; the labels identify the running build",
            labels=("version", "torch_version"),
        ).labels(version=__version__, torch_version=torch.__version__).set(1)
        g_uptime = self.registry.gauge(
            "process_uptime_seconds",
            "seconds since process start — a near-zero value means restart",
        )
        self.add_pre_scrape(
            lambda: g_uptime.set(time.monotonic() - _PROCESS_START)
        )
        httpd.pre_scrape = self._run_pre_scrape
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True, name="telemetry-exporter"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
