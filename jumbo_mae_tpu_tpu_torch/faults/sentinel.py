"""Training divergence sentinel: the host half that rolls a run back.

Counterpart of ``jumbo_mae_tpu_tpu/faults/sentinel.py``. It has two
halves there; the port keeps the device half in the train step:

- **Device guard**: ``make_train_step(guard_nonfinite=True)``
  (``train/steps.py``) checks ``isfinite(loss × loss_mult) &
  isfinite(grad_norm)`` and skips the optimizer update of a non-finite
  step — parameters, optimizer state and BatchNorm statistics stay as
  they were, only ``step`` advances, so the data stream and the learning
  rate schedule stay aligned. The JAX package's
  ``guarded_apply_gradients`` is that guard.

- **Host sentinel** (:class:`DivergenceSentinel`, driven by
  ``cli/train.py`` at log boundaries, never per step): counts consecutive
  bad steps (device-skipped or EMA-spike), and after ``patience`` of them
  in a row asks for a rollback to the last ``last/`` checkpoint (data
  cursor included). Skips, spikes and rollbacks are counted in the obs
  registry (``train_steps_skipped_total``, ``train_loss_spikes_total``,
  ``train_rollbacks_total``).

Why both: skipping protects the state from a *transient* bad batch;
rollback recovers from *persistent* badness (parameters already diverged,
a poisoned data region) that skipping cannot fix because the state itself
is the problem.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry


@dataclass(frozen=True)
class SentinelConfig:
    """Host-side divergence policy (``RunConfig``'s ``sentinel_*`` fields)."""

    patience: int = 3           # consecutive bad steps before rollback
    spike_factor: float = 10.0  # loss > factor x EMA counts as a bad step
    ema_beta: float = 0.98      # loss EMA decay
    max_rollbacks: int = 3      # give up (raise) after this many rollbacks


class DivergenceError(RuntimeError):
    """Raised when training diverges beyond what the sentinel can repair
    (no checkpoint to roll back to, or ``max_rollbacks`` exhausted)."""


class DivergenceSentinel:
    """Streaming bad-step detector fed with per-step host metrics.

    ``observe(step, metrics)`` is called once per fetched train step, in step
    order; it returns ``True`` when the consecutive-bad streak has reached
    ``patience`` and the caller should roll back. The EMA and streak reset
    after a rollback (``record_rollback``) — the restored stream re-earns its
    baseline.

    ``on_event`` (settable anytime) is the diagnostics tap: a callable
    ``(kind, payload_dict)`` invoked on every ``bad_step`` / ``loss_spike``
    / ``rollback`` verdict with the exact step index — the run journal
    subscribes here, so a rollback is *explainable* offline, not just
    counted. A raising callback is swallowed: diagnostics must never take
    down the recovery path they observe.
    """

    def __init__(self, cfg: SentinelConfig, registry=None, on_event=None):
        self.cfg = cfg
        self.on_event = on_event
        reg = registry if registry is not None else get_registry()
        self._m_skipped = reg.counter(
            "train_steps_skipped_total", "optimizer updates skipped on a non-finite loss/grad"
        )
        self._m_spikes = reg.counter("train_loss_spikes_total", "steps whose loss exceeded spike_factor x EMA")
        self._m_rollbacks = reg.counter("train_rollbacks_total", "automatic rollbacks to the last checkpoint")
        self.bad_streak = 0
        self.rollbacks = 0
        self.ema: float | None = None

    def _notify(self, kind: str, **payload) -> None:
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(kind, payload)
        except Exception:  # noqa: BLE001 - diagnostics never break recovery
            pass

    def observe(self, step: int, metrics: dict) -> bool:
        """Digest one step's host-fetched metrics; True → roll back now."""
        skipped = float(metrics.get("skipped", 0.0)) >= 0.5
        loss = float(metrics.get("loss", math.nan))
        if skipped or not math.isfinite(loss):
            self._m_skipped.inc()
            self.bad_streak += 1
            self._notify(
                "bad_step",
                step=step,
                loss=loss,
                reason="device_skip" if skipped else "nonfinite_loss",
                streak=self.bad_streak,
            )
            return self.bad_streak >= self.cfg.patience
        if self.ema is not None and self.cfg.spike_factor > 0 and loss > self.cfg.spike_factor * max(self.ema, 1e-12):
            self._m_spikes.inc()
            self.bad_streak += 1
            self._notify("loss_spike", step=step, loss=loss, ema=self.ema, streak=self.bad_streak)
            # a spike still carries signal — let the EMA drift toward it so
            # a legitimate regime change stops counting as bad eventually
            self._update_ema(loss)
            return self.bad_streak >= self.cfg.patience
        self.bad_streak = 0
        self._update_ema(loss)
        return False

    def _update_ema(self, loss: float) -> None:
        b = self.cfg.ema_beta
        self.ema = loss if self.ema is None else b * self.ema + (1 - b) * loss

    def record_rollback(self) -> None:
        """Count a performed rollback and reset the streak/EMA baselines;
        raises :class:`DivergenceError` once the budget is exhausted."""
        self.rollbacks += 1
        self._m_rollbacks.inc()
        self.bad_streak = 0
        self.ema = None
        self._notify("rollback", rollbacks=self.rollbacks, max_rollbacks=self.cfg.max_rollbacks)
        if self.rollbacks > self.cfg.max_rollbacks:
            raise DivergenceError(
                f"training diverged {self.rollbacks} times "
                f"(sentinel_max_rollbacks={self.cfg.max_rollbacks}) — "
                "rollback is not converging; inspect the data/LR schedule"
            )
