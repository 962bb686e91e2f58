"""RunEngine: the step driver behind ``cli/train.py``.

Counterpart of ``jumbo_mae_tpu_tpu/train/engine.py``, ported nearly
verbatim: the hooks, their order, the boundary arithmetic, the rollback,
preemption and crash/shutdown ladder and the exit-code protocol are the
JAX package's. The engine keeps only the driver logic:

- the step counter and the ``while step < training_steps`` loop;
- log-boundary batching of device metrics: the window's metrics are
  fetched in one sweep at the log boundary (:func:`fetch_metrics`), never
  per step, since a per-step ``.item()`` would serialize host dispatch
  against the card's work;
- eval/checkpoint boundary arithmetic;
- rollback control flow (a hook requests it; the rollback hooks restore
  and return the resumed step);
- the preemption agreement point and the crash/shutdown ladder.

Everything else registers as a component through lifecycle hooks, run in
registration order:

- ``pre_step(engine, step)`` — before the data wait.
- ``on_step(engine, StepEvent)`` — after dispatch, metrics still on the
  device; hooks may mutate ``ev.metrics``.
- ``on_log_window(engine, LogWindow)`` — at log boundaries with the
  window's host metrics; hooks may call :meth:`RunEngine.request_rollback`.
- ``on_rollback(engine, step, window) -> int | None`` — restore; the last
  non-``None`` return becomes the resumed step.
- ``on_eval(engine, step, state) -> dict | None`` — eval-boundary work;
  returned dicts merge into the checkpoint event's metrics.
- ``on_checkpoint(engine, CheckpointEvent)`` — the save.
- ``on_crash(engine, exc)`` — the run is dying; hooks may override
  ``engine.exit_reason``.
- ``on_shutdown(engine, reason, step)`` — the ``finally`` ladder.
"""

from __future__ import annotations

from typing import Callable

# -- exit-code protocol ---------------------------------------------------
# The ElasticSupervisor (train/elastic.py) classifies a dead child by its
# exit code. Codes are chosen outside the shell/signal ranges (1, 126-128,
# 128+N) so a supervisor can tell "the run asked to be restarted" from "the
# run tripped over a bug" from "the kernel killed it".
EXIT_OK = 0  # completed (or clean preemption checkpoint + exit)
EXIT_ELASTIC = 42  # host lost / membership change: restart me at new world
EXIT_FATAL = 43  # unrecoverable (diverged, config error): do NOT restart
EXIT_HANG = 44  # hang watchdog fired: a collective is wedged, restart me

#: exit reasons that must NOT be retried by a supervisor.
FATAL_REASONS = frozenset({"diverged"})


def exit_code_for(reason: str) -> int:
    """Map an engine ``exit_reason`` to the supervisor exit-code protocol.

    ``completed``/``preempted``/``stopped`` are clean exits; ``host_lost``
    asks for an elastic restart; reasons in :data:`FATAL_REASONS` (and any
    ``exception:*``) are fatal — the supervisor gives up rather than loop
    on a deterministic crash.
    """
    if reason in ("completed", "preempted", "stopped"):
        return EXIT_OK
    if reason == "host_lost":
        return EXIT_ELASTIC
    if reason == "hang":
        return EXIT_HANG
    return EXIT_FATAL


def fetch_metrics(window: list[dict]) -> list[dict]:
    """The window's metric dicts as host floats: every tensor of the window
    is stacked into one float64 tensor and copied to the host at once (one
    synchronisation per log boundary); other values pass through
    ``float``."""
    import torch

    tensors = [v for m in window for v in m.values() if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([t.detach().reshape(()).double() for t in tensors]).cpu().tolist()) if tensors else None
    return [{k: next(host) if isinstance(v, torch.Tensor) else float(v) for k, v in m.items()} for m in window]


class StepEvent:
    """One dispatched step; ``metrics`` may still live on the device and is
    mutable so hooks can strip non-scalar legs before buffering."""

    __slots__ = ("step", "metrics")

    def __init__(self, step: int, metrics):
        self.step = step
        self.metrics = metrics


class LogWindow:
    """One log boundary: ``fetched`` is ``[(step, host_metrics), ...]``
    for every step dispatched since the previous boundary. Hooks share
    derived scratch (``bad_steps``, ``summary``, ...) as attributes."""

    def __init__(self, step: int, fetched: list):
        self.step = step
        self.fetched = fetched
        self.bad_steps: list[int] = []


class CheckpointEvent:
    """One checkpoint boundary. ``reason`` is ``"interval"`` (periodic /
    final-step save), ``"preemption"`` (stop-flag save on the way out).
    ``metrics`` holds the merged ``on_eval`` results (``None`` when no
    eval ran). Hooks may attach attributes for later hooks in the chain
    (the saver stamps ``save_seconds``; the publisher reads it)."""

    def __init__(self, step: int, metrics: dict | None, reason: str):
        self.step = step
        self.metrics = metrics
        self.reason = reason


class RunEngine:
    """Hook-driven step driver (see module docstring).

    ``next_batch(step)`` produces the step's batch (host wait accounting
    belongs to the caller's closure); ``dispatch(state, batch, step) ->
    (state, metrics)`` issues the device step. ``should_stop()`` is the
    preemption agreement probe, evaluated at stop-safe boundaries only
    (multi-host agreement needs an allgather — per-step would serialize
    dispatch). ``fetch`` maps a list of device metric dicts to host
    (default :func:`fetch_metrics`); injectable so the driver itself is
    testable without a device.
    """

    def __init__(
        self,
        *,
        training_steps: int,
        start_step: int = 0,
        log_interval: int = 1,
        eval_interval: int = 0,
        ckpt_interval: int = 0,
        process_count: int = 1,
        next_batch: Callable[[int], object],
        dispatch: Callable,
        should_stop: Callable[[], bool] | None = None,
        fetch: Callable | None = None,
    ):
        self.training_steps = int(training_steps)
        self.start_step = int(start_step)
        self.log_interval = max(1, int(log_interval))
        self.eval_interval = int(eval_interval)
        self.ckpt_interval = int(ckpt_interval)
        self.process_count = int(process_count)
        self._next_batch = next_batch
        self._dispatch = dispatch
        self._should_stop = should_stop
        self._fetch = fetch or fetch_metrics

        self.state = None
        self.step = self.start_step
        self.exit_reason = "completed"
        self._pending: list = []  # [(step, device metrics)] → log boundary
        self._rollback_wanted = False
        self._stop_reason: str | None = None
        self._pre_step: list = []
        self._on_step: list = []
        self._on_log_window: list = []
        self._on_rollback: list = []
        self._on_eval: list = []
        self._on_checkpoint: list = []
        self._on_crash: list = []
        self._on_shutdown: list = []
        self._on_host_lost: list = []
        self.host_lost_info: dict | None = None

    # -- hook registration (usable as decorators; registration order is
    # -- execution order) ------------------------------------------------
    def pre_step(self, fn):
        self._pre_step.append(fn)
        return fn

    def on_step(self, fn):
        self._on_step.append(fn)
        return fn

    def on_log_window(self, fn):
        self._on_log_window.append(fn)
        return fn

    def on_rollback(self, fn):
        self._on_rollback.append(fn)
        return fn

    def on_eval(self, fn):
        self._on_eval.append(fn)
        return fn

    def on_checkpoint(self, fn):
        self._on_checkpoint.append(fn)
        return fn

    def on_crash(self, fn):
        self._on_crash.append(fn)
        return fn

    def on_shutdown(self, fn):
        self._on_shutdown.append(fn)
        return fn

    def on_host_lost(self, fn):
        """``fn(engine, info)`` — fired once at the stop-safe boundary
        after :meth:`notify_host_lost`, BEFORE the preemption checkpoint,
        so journal/flightrec/beacon hooks can record the membership change
        while the step context still exists."""
        self._on_host_lost.append(fn)
        return fn

    # -- control requests (called from hooks) ----------------------------
    def request_rollback(self) -> None:
        """Ask the driver to run the rollback chain after the current log
        window's hooks finish (the window must complete first: its
        metrics/black-box records describe the divergence)."""
        self._rollback_wanted = True

    def request_stop(self, reason: str = "stopped") -> None:
        """Ask the driver to exit at the next stop-safe boundary with
        ``exit_reason=reason`` (checkpointing first, like preemption)."""
        self._stop_reason = reason

    def notify_host_lost(self, info: dict | None = None) -> None:
        """A fleet peer is gone (dead beacon / supervisor signal). Records
        ``info`` (e.g. ``{"hosts": [1], "detected_by": "beacon"}``), fires
        the ``on_host_lost`` chain at the next stop-safe boundary, then
        exits with ``exit_reason="host_lost"`` → :data:`EXIT_ELASTIC`.

        The loop cannot keep stepping: the next collective would block on
        the dead peer forever. First notification wins."""
        if self._stop_reason != "host_lost":
            self.host_lost_info = dict(info or {})
            self.request_stop("host_lost")

    # -- boundaries ------------------------------------------------------
    def at_log_boundary(self, step: int) -> bool:
        return step % self.log_interval == 0 or step == self.training_steps

    def at_eval_boundary(self, step: int) -> bool:
        return step == self.training_steps or (
            self.eval_interval > 0 and step % self.eval_interval == 0
        )

    def at_ckpt_boundary(self, step: int) -> bool:
        """Checkpoint-only cadence (``run.ckpt_every``), decoupled from
        eval so the save interval can track failure rate, not eval cost.
        0 keeps the legacy coupling: saves ride eval boundaries only."""
        return self.ckpt_interval > 0 and step % self.ckpt_interval == 0

    # -- the driver ------------------------------------------------------
    def run(self, state):
        """Drive ``state`` from ``start_step`` to ``training_steps``.
        Returns the final state; ``exit_reason`` records how the loop
        ended (``completed`` / ``preempted`` / hook-assigned)."""
        self.state = state
        step = self.start_step
        self.step = step
        try:
            while step < self.training_steps:
                step += 1
                self.step = step
                for fn in self._pre_step:
                    fn(self, step)
                batch = self._next_batch(step)
                self.state, metrics = self._dispatch(self.state, batch, step)
                ev = StepEvent(step, metrics)
                for fn in self._on_step:
                    fn(self, ev)
                self._pending.append((ev.step, ev.metrics))

                if self.at_log_boundary(step):
                    # sync ONLY at log boundaries — one fetch for the
                    # whole window's device scalars
                    fetched = list(
                        zip(
                            [s for s, _ in self._pending],
                            self._fetch([m for _, m in self._pending]),
                        )
                    )
                    self._pending.clear()
                    win = LogWindow(step, fetched)
                    for fn in self._on_log_window:
                        fn(self, win)
                    if self._rollback_wanted:
                        self._rollback_wanted = False
                        new_step = None
                        for fn in self._on_rollback:
                            r = fn(self, step, win)
                            if r is not None:
                                new_step = r
                        if new_step is None:
                            raise RuntimeError(
                                "rollback requested but no on_rollback hook "
                                "returned the resumed step"
                            )
                        step = int(new_step)
                        self.step = step
                        continue

                saved_this_step = False
                run_eval = self.at_eval_boundary(step)
                if run_eval or self.at_ckpt_boundary(step):
                    evals: dict | None = None
                    if run_eval:
                        for fn in self._on_eval:
                            r = fn(self, step, self.state)
                            if r:
                                evals = {**(evals or {}), **r}
                    cev = CheckpointEvent(step, evals, reason="interval")
                    for fn in self._on_checkpoint:
                        fn(self, cev)
                    saved_this_step = True

                # Stop-safe boundary: single-host checks the flag every
                # step; multi-host only at log/eval boundaries (agreement
                # needs a host allgather), well inside any grace window.
                boundary = (
                    self.process_count == 1
                    or saved_this_step
                    or step % self.log_interval == 0
                )
                if boundary and (
                    self._stop_reason is not None
                    or (self._should_stop is not None and self._should_stop())
                ):
                    if self._stop_reason == "host_lost":
                        for fn in self._on_host_lost:
                            fn(self, self.host_lost_info or {})
                        # no preemption save: a checkpoint is collective and
                        # the lost peer can never join it — the last
                        # COMMITTED checkpoint is the elastic resume point
                        print(
                            f"[train] host lost at step {step}; exiting "
                            "for elastic restart"
                        )
                    else:
                        if not saved_this_step:
                            cev = CheckpointEvent(
                                step, None, reason="preemption"
                            )
                            for fn in self._on_checkpoint:
                                fn(self, cev)
                        print(
                            f"[train] preemption checkpoint at step {step}; "
                            "exiting"
                        )
                    self.exit_reason = self._stop_reason or "preempted"
                    break
        except BaseException as e:
            # default classification; on_crash hooks may refine it (the
            # train CLI maps DivergenceError → "diverged" and dumps the
            # flight recorder exactly here, while the ring still exists)
            self.exit_reason = f"exception:{type(e).__name__}"
            for fn in self._on_crash:
                try:
                    fn(self, e)
                except Exception:  # noqa: BLE001 - never mask the real failure
                    pass
            raise
        finally:
            for fn in self._on_shutdown:
                fn(self, self.exit_reason, self.step)
        return self.state
