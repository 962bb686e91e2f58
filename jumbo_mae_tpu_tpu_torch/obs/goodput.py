"""Goodput accounting — where did the run's wall-clock actually go?

Counterpart of ``jumbo_mae_tpu_tpu/obs/goodput.py``, pure Python and held
to equal it on the same inputs.

Resilience (sentinel rollbacks, elastic restarts, hang watchdogs) has a
price, and nothing in the stack measured it: a run could spend half its
wall-clock in supervisor backoff and recompute and still report healthy
step times. This module attributes **every second of run wall-clock to
exactly one bucket** and enforces a conservation invariant — the buckets
must sum to wall-clock within tolerance, so time can neither vanish nor
be counted twice.

Two halves:

``GoodputLedger`` (live, per-process)
    Fed by the train CLI's RunEngine hooks: data-wait and dispatch spans,
    eval and checkpoint spans, rollback recompute windows, hang-detection
    latency. Publishes ``goodput_*`` gauges and journals cumulative
    ``goodput_report`` events at checkpoint boundaries and shutdown.
    ``idle`` is the residual
    (wall − attributed), clamped at zero — so the conservation failure
    mode this catches is *over*-attribution (double counting), which is
    exactly the bug class a bucket taxonomy invites.

``stitch_generations`` (offline, cross-process)
    An elastic run is several process generations separated by supervisor
    downtime that no in-process clock can see. Stitching walks the merged
    journal: each generation's last cumulative ``goodput_report`` gives
    its in-process buckets, the inter-generation gap (previous generation's
    last step activity → next generation's ledger epoch) becomes
    ``hang_latency`` + ``restart_downtime``, and lost work is
    steps executed − steps committed at the moment of death. This is the
    first observability layer that spans generations rather than a single
    process lifetime.

``advise_ckpt_interval``
    Young/Daly optimal checkpoint interval √(2·save_cost·MTBF) from the
    measured save cost and observed failure rate, converted to a concrete
    ``run.ckpt_every`` step count via the measured step time.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

# Every second of wall-clock lands in exactly one of these. Order is
# display order in reports; ``idle`` is always the residual.
GOODPUT_BUCKETS = (
    "productive",          # step compute for steps that advance the run
    "compile",             # first-step trace+compile (and retraces)
    "data_wait",           # host blocked on the input pipeline
    "eval",                # evaluation passes
    "ckpt_save",           # checkpoint save (synchronous portion)
    "ckpt_restore",        # checkpoint restore (startup + rollback)
    "rollback_recompute",  # re-training steps past the last committed step
    "restart_downtime",    # supervisor teardown + backoff + relaunch
    "hang_latency",        # stall time before the watchdog fired
    "idle",                # residual: wall − everything above
)

_DISPLAY = {
    "productive": "productive step compute",
    "compile": "compile/retrace",
    "data_wait": "data wait",
    "eval": "eval",
    "ckpt_save": "checkpoint save",
    "ckpt_restore": "checkpoint restore",
    "rollback_recompute": "rollback recompute",
    "restart_downtime": "restart downtime",
    "hang_latency": "hang-detection latency",
    "idle": "idle",
}


def bucket_display(bucket: str) -> str:
    """Human name for a bucket key (``restart_downtime`` → ``restart
    downtime``)."""
    return _DISPLAY.get(bucket, bucket.replace("_", " "))


class GoodputLedger:
    """Live wall-clock attribution for one training process.

    The clock starts at construction (top of ``train()``), so setup,
    compile and restore are all on the books. ``add`` charges a measured
    span to a bucket; ``note_step`` routes per-step dispatch time to
    ``compile`` (first dispatch after a (re)start traces+compiles),
    ``rollback_recompute`` (steps at or below the step we rolled back
    from) or ``productive``. Unattributed time is ``idle`` — computed at
    snapshot time as the residual, never stored — which makes the
    conservation invariant ``attributed ≤ wall`` the thing unit tests can
    actually falsify.
    """

    def __init__(
        self,
        *,
        generation: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        registry=None,
    ):
        self.generation = int(generation)
        self._clock = clock
        self._t0 = float(clock())
        self._lock = threading.Lock()
        self._s: dict[str, float] = {
            b: 0.0 for b in GOODPUT_BUCKETS if b != "idle"
        }
        self._steps = 0            # productive steps dispatched
        self._recompute_steps = 0  # steps re-trained after rollbacks
        self._first_dispatch_done = False
        self._recompute_until: int | None = None
        reg = registry if registry is not None else get_registry()
        self._g_fraction = reg.gauge(
            "goodput_fraction",
            "share of wall-clock spent in productive step compute",
        )
        self._g_wall = reg.gauge(
            "goodput_wall_seconds",
            "wall-clock seconds covered by the goodput ledger",
        )
        self._g_bucket = reg.gauge(
            "goodput_bucket_seconds",
            "wall-clock seconds attributed to each goodput bucket",
            labels=("bucket",),
        )
        self._g_recompute = reg.gauge(
            "goodput_recompute_steps",
            "steps re-trained past the last committed step after rollbacks",
        )

    # -- feeding ---------------------------------------------------------
    def add(self, bucket: str, seconds: float) -> None:
        """Charge ``seconds`` of measured wall-clock to ``bucket``."""
        if bucket not in self._s:
            raise KeyError(f"unknown goodput bucket {bucket!r}")
        with self._lock:
            self._s[bucket] += max(0.0, float(seconds))

    def note_step(self, step: int, dispatch_s: float) -> None:
        """Attribute one step's dispatch span.

        The first dispatch of a process is trace+compile, not training;
        steps at or below a pending rollback watermark are recompute.
        """
        dispatch_s = max(0.0, float(dispatch_s))
        with self._lock:
            if not self._first_dispatch_done:
                self._first_dispatch_done = True
                self._s["compile"] += dispatch_s
                return
            if (
                self._recompute_until is not None
                and int(step) <= self._recompute_until
            ):
                self._s["rollback_recompute"] += dispatch_s
                self._recompute_steps += 1
                if int(step) >= self._recompute_until:
                    self._recompute_until = None
                return
            self._s["productive"] += dispatch_s
            self._steps += 1

    def note_rollback(self, from_step: int, to_step: int) -> None:
        """Steps re-dispatched up to ``from_step`` are recompute, not
        progress — they were already trained once before the rollback."""
        with self._lock:
            hw = int(from_step)
            if self._recompute_until is None or hw > self._recompute_until:
                self._recompute_until = hw

    # -- reading ---------------------------------------------------------
    def wall_s(self) -> float:
        return max(0.0, float(self._clock()) - self._t0)

    def snapshot(self) -> dict[str, float]:
        """Bucket seconds including the ``idle`` residual."""
        with self._lock:
            buckets = dict(self._s)
        wall = self.wall_s()
        attributed = sum(buckets.values())
        buckets["idle"] = max(0.0, wall - attributed)
        return buckets

    def fraction(self) -> float:
        wall = self.wall_s()
        if wall <= 0.0:
            return 0.0
        with self._lock:
            return min(1.0, self._s["productive"] / wall)

    def conservation_error(self) -> float:
        """Relative attribution error. ``idle`` absorbs under-attribution,
        so a nonzero error means over-attribution (double counting)."""
        wall = self.wall_s()
        if wall <= 0.0:
            return 0.0
        with self._lock:
            attributed = sum(self._s.values())
        return max(0.0, attributed - wall) / wall

    def report(
        self, *, step: int | None = None, reason: str | None = None
    ) -> dict[str, Any]:
        """Cumulative attribution snapshot, shaped for a ``goodput_report``
        journal event (and for offline stitching)."""
        buckets = self.snapshot()
        wall = self.wall_s()
        attributed = sum(v for k, v in buckets.items() if k != "idle")
        out: dict[str, Any] = {
            "generation": self.generation,
            "wall_s": round(wall, 3),
            "attributed_s": round(attributed, 3),
            "idle_s": round(buckets["idle"], 3),
            "goodput_fraction": round(self.fraction(), 4),
            "conservation_error": round(self.conservation_error(), 4),
            "steps": self._steps,
            "recompute_steps": self._recompute_steps,
            "buckets": {k: round(v, 3) for k, v in buckets.items()},
        }
        if step is not None:
            out["step"] = int(step)
        if reason is not None:
            out["reason"] = str(reason)
        return out

    def publish(self) -> None:
        """Push the current attribution to the metrics registry."""
        buckets = self.snapshot()
        self._g_fraction.set(self.fraction())
        self._g_wall.set(self.wall_s())
        self._g_recompute.set(float(self._recompute_steps))
        for k, v in buckets.items():
            self._g_bucket.labels(bucket=k).set(v)


# ---------------------------------------------------------------------------
# Offline: stitch per-generation journals from an elastic run
# ---------------------------------------------------------------------------


def _new_gen(event: dict, index: int) -> dict[str, Any]:
    start = int(event.get("start_step") or 0)
    return {
        "generation": int(event.get("generation", index)),
        "start_ts": float(event.get("ts") or 0.0),
        "first_step_ts": None,
        "last_step_ts": None,
        "last_ts": float(event.get("ts") or 0.0),
        "start_step": start,
        "max_step": start,
        "committed_step": start,
        "save_costs": [],
        "hang_stalled_s": 0.0,
        "report": None,
    }


def stitch_generations(events: list[dict]) -> dict[str, Any]:
    """Cross-generation goodput from a merged journal.

    Uses host-0 events as the canonical per-run record (supervisor events
    are journaled on host 0 too). Each ``run_start`` opens a generation;
    its last cumulative ``goodput_report`` supplies in-process buckets.
    The gap between a generation's last step activity and the next
    generation's ledger epoch (``report.ts − report.wall_s``) is downtime:
    first charged to ``hang_latency`` (up to the stalled time the watchdog
    observed), the remainder to ``restart_downtime``. Lost steps per
    restart = steps executed − steps committed when the generation died.
    """
    gens: list[dict[str, Any]] = []
    restarts: list[dict[str, Any]] = []
    cur: dict[str, Any] | None = None
    for e in events:
        if int(e.get("host") or 0) != 0:
            continue
        ts = float(e.get("ts") or 0.0)
        etype = e.get("type")
        if etype == "run_start" and e.get("role") != "supervisor":
            if cur is not None:
                gens.append(cur)
            cur = _new_gen(e, len(gens))
            continue
        if etype == "elastic_restart":
            restarts.append(dict(e))
            continue
        if cur is None:
            continue
        cur["last_ts"] = max(cur["last_ts"], ts)
        if etype == "step":
            step = int(e.get("step") or 0)
            cur["max_step"] = max(cur["max_step"], step)
            cur["last_step_ts"] = max(cur["last_step_ts"] or ts, ts)
            if cur["first_step_ts"] is None:
                cur["first_step_ts"] = ts
        elif etype == "checkpoint_save":
            cur["committed_step"] = max(
                cur["committed_step"], int(e.get("step") or 0)
            )
            cur["last_step_ts"] = max(cur["last_step_ts"] or ts, ts)
            sv = e.get("save_seconds")
            if sv is not None:
                try:
                    cur["save_costs"].append(float(sv))
                except (TypeError, ValueError):
                    pass
        elif etype == "hang_detected":
            try:
                cur["hang_stalled_s"] = max(
                    cur["hang_stalled_s"], float(e.get("stalled_s") or 0.0)
                )
            except (TypeError, ValueError):
                pass
        elif etype == "goodput_report":
            cur["report"] = dict(e)
    if cur is not None:
        gens.append(cur)

    buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
    total_steps = 0
    save_costs: list[float] = []
    for g in gens:
        save_costs.extend(g["save_costs"])
        rep = g["report"]
        if rep:
            # in-process idle is NOT accumulated: the stall before a hang
            # death is idle to the in-process ledger but becomes
            # hang_latency/restart_downtime here — stitched idle is always
            # recomputed as the cross-generation residual below.
            for k, v in (rep.get("buckets") or {}).items():
                if k in buckets and k != "idle":
                    try:
                        buckets[k] += float(v)
                    except (TypeError, ValueError):
                        pass
            total_steps += int(rep.get("steps") or 0)
        # ledger epoch: when this generation's clock started. The report is
        # cumulative, so its journal ts minus its wall_s recovers t0 even
        # though the ledger predates the journal.
        rep_ts = float(rep.get("ts") or 0.0) if rep else 0.0
        rep_wall = float(rep.get("wall_s") or 0.0) if rep else 0.0
        g["ledger_t0"] = rep_ts - rep_wall if rep else g["start_ts"]

    for i, g in enumerate(gens[1:], start=1):
        prev = gens[i - 1]
        prev_end = prev["last_step_ts"] or prev["last_ts"]
        down = max(0.0, g["ledger_t0"] - prev_end)
        hang = min(down, prev["hang_stalled_s"])
        buckets["hang_latency"] += hang
        buckets["restart_downtime"] += down - hang
        lost = max(0, prev["max_step"] - prev["committed_step"])
        restart_meta = next(
            (
                r
                for r in restarts
                if int(r.get("generation", -1)) == g["generation"]
            ),
            {},
        )
        g["restart"] = {
            "generation": g["generation"],
            "reason": restart_meta.get("reason", "unknown"),
            "backoff_s": float(restart_meta.get("backoff_s") or 0.0),
            "detection_s": round(hang, 3),
            "downtime_s": round(down, 3),
            "lost_steps": lost,
        }

    wall = 0.0
    if gens:
        t0 = min(g["ledger_t0"] for g in gens)
        t1 = max(g["last_ts"] for g in gens)
        wall = max(0.0, t1 - t0)
    attributed = sum(v for k, v in buckets.items() if k != "idle")
    buckets["idle"] += max(0.0, wall - attributed)
    err = max(0.0, attributed - wall) / wall if wall > 0 else 0.0

    committed = max((g["committed_step"] for g in gens), default=0)
    lost_steps = sum(
        g.get("restart", {}).get("lost_steps", 0) for g in gens
    )
    step_time = (
        buckets["productive"] / total_steps if total_steps > 0 else None
    )
    failures = len([g for g in gens if "restart" in g])
    mtbf = wall / failures if failures > 0 and wall > 0 else None
    for g in gens:
        restart = g.get("restart")
        if restart is not None and step_time is not None:
            restart["lost_seconds"] = round(
                restart["lost_steps"] * step_time, 3
            )
    return {
        "wall_s": round(wall, 3),
        "buckets": {k: round(v, 3) for k, v in buckets.items()},
        "goodput_fraction": (
            round(buckets["productive"] / wall, 4) if wall > 0 else 0.0
        ),
        "conservation_error": round(err, 4),
        "generations": gens,
        "restarts": [g["restart"] for g in gens if "restart" in g],
        "steps_committed": committed,
        "steps_lost": lost_steps,
        "failures": failures,
        "mtbf_s": round(mtbf, 3) if mtbf is not None else None,
        "save_cost_s": (
            round(sum(save_costs) / len(save_costs), 3) if save_costs else None
        ),
        "step_time_s": round(step_time, 4) if step_time is not None else None,
    }


# ---------------------------------------------------------------------------
# Checkpoint-interval advisor
# ---------------------------------------------------------------------------


def advise_ckpt_interval(
    save_cost_s: float,
    mtbf_s: float,
    step_time_s: float,
    *,
    observed_span_s: float | None = None,
) -> dict[str, Any]:
    """Young's optimal checkpoint interval: ``√(2·save_cost·MTBF)``.

    With no observed failures, callers pass the run span as a *lower
    bound* on MTBF via ``observed_span_s`` — the recommendation is then a
    floor (checkpoint at least this rarely), flagged ``mtbf_is_bound``.
    Returns a concrete ``ckpt_every`` step count via the step time.
    """
    bound = False
    if not mtbf_s or mtbf_s <= 0:
        mtbf_s = max(float(observed_span_s or 0.0), 1.0)
        bound = True
    save_cost_s = max(float(save_cost_s), 1e-3)
    interval_s = (2.0 * save_cost_s * float(mtbf_s)) ** 0.5
    step_time_s = max(float(step_time_s), 1e-6)
    ckpt_every = max(1, int(round(interval_s / step_time_s)))
    return {
        "interval_s": round(interval_s, 3),
        "ckpt_every": ckpt_every,
        "save_cost_s": round(save_cost_s, 3),
        "mtbf_s": round(float(mtbf_s), 1),
        "step_time_s": round(step_time_s, 4),
        "mtbf_is_bound": bound,
    }
