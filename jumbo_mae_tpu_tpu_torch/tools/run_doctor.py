"""Offline run diagnosis: journal (+ optional flight record) → markdown.

Counterpart of the JAX package's top-level ``tools/run_doctor.py``: the
same report, sections and exit codes over the port's ``obs/journal.py``
(``read_merged_journal``) and ``obs/doctor_common.py``.

The sentinel makes a diverging run *survivable*; this tool makes it
*explainable* after the fact, from the crash-safe artifacts alone — no live
process, no /metrics endpoint, no device:

    python -m jumbo_mae_tpu_tpu_torch.tools.run_doctor runs/my_run            # run dir
    python -m jumbo_mae_tpu_tpu_torch.tools.run_doctor runs/my_run/journal    # journal dir
    python -m jumbo_mae_tpu_tpu_torch.tools.run_doctor ... --flightrec runs/my_run/flightrec-*.json
    python -m jumbo_mae_tpu_tpu_torch.tools.run_doctor ... --out diagnosis.md

The report answers, in order: how did the run end; *when and where* did it
go non-finite (the bad step window, and the first layer group whose grad
norm blew up when per-layer-group diagnostics were on); what the grad-norm
trend looked like before the incident; whether throughput regressed or the
run became data-bound across log windows; and the full resilience timeline
(checkpoints, rollbacks, shard quarantines, flight records, fleet
straggler/lost/rejoined transitions).

Multi-host runs are handled via the merged journal reader: per-host segments
(`journal/` + `journal-host<i>/`) are interleaved by time, host-0 rows drive
the step/throughput analysis (every host journals its own `step` events —
counting them all would multiply throughput by the fleet size), and
flight records from any host appear in the timeline tagged with their host.

The one line that reads the run's own framework: the env line names the
``jax`` version of a JAX journal and the ``torch`` version of the port's
(whose fingerprint has no ``jax``), where the JAX doctor prints ``jax ?``.

Exit codes: 0 = diagnosis written (healthy or not); 2 = no journal found.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import (
    contiguous_windows,
    fmt_num as _fmt_num,
    spans_text,
    write_report,
)
from jumbo_mae_tpu_tpu_torch.obs.journal import read_merged_journal


def _is_bad_loss(v) -> bool:
    if v in ("nan", "inf", "-inf"):
        return True
    try:
        f = float(v)
    except (TypeError, ValueError):
        return False
    return f != f or f in (float("inf"), float("-inf"))


def _bad_windows(events: list[dict]) -> list[tuple[int, int]]:
    """Contiguous runs of known-bad step indices, preferring the sentinel's
    exact per-step verdicts, falling back to the windowed step snapshots."""
    bad: set[int] = set()
    for e in events:
        if e.get("type") in ("sentinel_bad_step",) and "step" in e:
            bad.add(int(e["step"]))
        if e.get("type") == "step":
            for s in e.get("bad_steps", []) or []:
                bad.add(int(s))
            m = e.get("metrics", {}) or {}
            if _is_bad_loss(m.get("train/loss")) and "step" in e:
                bad.add(int(e["step"]))
    return contiguous_windows(bad)


def _grad_norm_series(events: list[dict]) -> list[tuple[int, float]]:
    out = []
    for e in events:
        if e.get("type") != "step":
            continue
        gn = (e.get("metrics", {}) or {}).get("train/grad_norm")
        if gn is None or _is_bad_loss(gn):
            continue
        try:
            out.append((int(e["step"]), float(gn)))
        except (TypeError, ValueError, KeyError):
            continue
    return out


def _first_nonfinite_group(events: list[dict], flight: dict | None) -> str | None:
    """Scan diag payloads (journal step events, then the flight record's
    per-step ring) for the first group with a non-finite grad norm."""
    def scan(diag: dict | None):
        if not isinstance(diag, dict):
            return None
        for grp, stats in diag.items():
            if isinstance(stats, dict) and _is_bad_loss(stats.get("grad_norm")):
                return grp
        return None

    for e in events:
        if e.get("type") == "step":
            found = scan(e.get("diag"))
            if found:
                return found
    if flight:
        for entry in flight.get("steps", []):
            found = scan(entry.get("diag"))
            if found:
                return found
    return None


def _host_of(e: dict) -> int:
    try:
        return int(e.get("host", 0))
    except (TypeError, ValueError):
        return 0


def _fmt_host(host_id) -> str:
    return f"host {host_id}" if host_id is not None else "host ?"


def diagnose(events: list[dict], flight: dict | None = None) -> str:
    """Render the markdown diagnosis for one run's journal events."""
    lines: list[str] = ["# Run doctor report", ""]
    # A merged multi-host journal repeats the lifecycle per host (every host
    # journals its own run_start/step/shutdown). Host-0 rows drive the
    # single-run analysis — counting every host's `step` events would
    # multiply throughput and rollbacks by the fleet size. Flight records
    # and fleet transitions keep all hosts (tagged below).
    hosts = sorted({_host_of(e) for e in events})
    multi = len(hosts) > 1
    h0 = [e for e in events if _host_of(e) == 0] if multi else events
    starts = [e for e in h0 if e.get("type") == "run_start"]
    steps = [e for e in h0 if e.get("type") == "step"]
    shutdowns = [e for e in h0 if e.get("type") == "shutdown"]
    rollbacks = [e for e in h0 if e.get("type") == "rollback"]
    quarantines = [e for e in h0 if e.get("type") == "quarantine"]
    ckpts = [e for e in h0 if e.get("type") == "checkpoint_save"]
    flights = [e for e in events if e.get("type") == "flight_record"]
    stragglers = [e for e in events if e.get("type") == "fleet_straggler"]
    lost = [e for e in events if e.get("type") == "fleet_host_lost"]

    # ---------------------------------------------------------- run summary
    if starts:
        s = starts[-1]
        cfg = s.get("config", {}) or {}
        run_cfg = cfg.get("run", {}) or {}
        env = s.get("env", {}) or {}
        framework = "torch" if "torch" in env and "jax" not in env else "jax"
        lines += [
            "## Run",
            "",
            f"- name: `{run_cfg.get('name', '?')}`  mode: "
            f"`{run_cfg.get('mode', '?')}`  "
            f"steps: {run_cfg.get('training_steps', '?')}  "
            f"global batch: {run_cfg.get('train_batch_size', '?')}",
            f"- started at step {s.get('start_step', 0)}"
            + (" (resumed)" if s.get("resumed") else ""),
            f"- env: python {env.get('python', '?')}, {framework} {env.get(framework, '?')} "
            f"({env.get('backend', '?')}, {env.get('device_count', '?')} devices), "
            f"host `{env.get('hostname', '?')}` pid {env.get('pid', '?')}",
        ]
        if env.get("env"):
            lines.append(f"- notable env vars: `{env['env']}`")
        if s.get("diag_groups"):
            lines.append(
                f"- per-layer-group diagnostics ON every "
                f"{s.get('diag_every')} steps over {len(s['diag_groups'])} "
                f"groups: {', '.join(s['diag_groups'])}"
            )
        if len(starts) > 1:
            lines.append(f"- {len(starts)} run_start events (process restarts)")
        lines.append("")

    # -------------------------------------------------------------- verdict
    windows = _bad_windows(events)
    reason = shutdowns[-1].get("reason", "unknown") if shutdowns else "no shutdown event (crashed hard?)"
    verdict = []
    if windows:
        verdict.append(
            f"**non-finite step window: {spans_text(windows, noun='step')}**"
        )
    if rollbacks:
        verdict.append(f"{len(rollbacks)} sentinel rollback(s)")
    if quarantines:
        n = sum(len(q.get("shards", [])) for q in quarantines)
        verdict.append(f"{n} shard(s) quarantined")
    if stragglers or lost:
        fleet_bits = []
        if stragglers:
            who = sorted({_fmt_host(e.get("host_id")) for e in stragglers})
            fleet_bits.append(
                f"{len(stragglers)} straggler event(s) ({', '.join(who)})"
            )
        if lost:
            who = sorted({_fmt_host(e.get("host_id")) for e in lost})
            fleet_bits.append(f"host(s) lost: {', '.join(who)}")
        verdict.append("fleet: " + "; ".join(fleet_bits))
    if not verdict:
        verdict.append("no incidents recorded")
    if multi:
        verdict.append(
            f"merged journal across {len(hosts)} hosts "
            f"({', '.join(str(h) for h in hosts)}); host-0 rows drive the "
            "step analysis"
        )
    lines += [
        "## Verdict",
        "",
        f"- run ended: **{reason}**",
        f"- {'; '.join(verdict)}",
        "",
    ]

    # --------------------------------------------------- non-finite analysis
    if windows:
        lines += ["## Non-finite analysis", ""]
        first_lo, first_hi = windows[0]
        lines.append(
            f"- first incident: steps {first_lo}–{first_hi} "
            f"({first_hi - first_lo + 1} bad step(s))"
        )
        grp = _first_nonfinite_group(events, flight)
        if grp:
            lines.append(
                f"- first layer group to go non-finite (grad norm): **{grp}**"
            )
        else:
            lines.append(
                "- per-layer-group diag unavailable for the incident "
                "(run with `run.diag_every` > 0 to localize the blow-up)"
            )
        series = _grad_norm_series(h0)
        before = [(s, g) for s, g in series if s < first_lo][-5:]
        if len(before) >= 2:
            first_g, last_g = before[0][1], before[-1][1]
            trend = (
                "rising" if last_g > 1.5 * first_g
                else "falling" if last_g < first_g / 1.5
                else "flat"
            )
            pts = ", ".join(f"{s}:{_fmt_num(g)}" for s, g in before)
            lines.append(
                f"- grad-norm trend before the incident: **{trend}** "
                f"({_fmt_num(first_g)} → {_fmt_num(last_g)} over the "
                f"last {len(before)} snapshots: {pts})"
            )
        lines.append("")

    # ----------------------------------------------------------- throughput
    perf = [
        (
            int(e["step"]),
            (e.get("metrics", {}) or {}).get("perf/images_per_sec"),
            e.get("data_wait_fraction"),
        )
        for e in steps
        if "step" in e
    ]
    perf = [
        (s, float(i), None if w is None else float(w))
        for s, i, w in perf
        if isinstance(i, (int, float))
    ]
    if perf:
        lines += ["## Throughput & data waits", ""]
        best = max(i for _, i, _ in perf)
        last = perf[-1][1]
        lines.append(
            f"- images/sec across {len(perf)} windows: best {_fmt_num(best)}, "
            f"final {_fmt_num(last)}"
            + (
                f" — **{(1 - last / best) * 100:.0f}% below best**"
                if best > 0 and last < 0.8 * best
                else ""
            )
        )
        waits = [w for _, _, w in perf if w is not None]
        if waits:
            mean_w = sum(waits) / len(waits)
            note = " — **data-bound**" if max(waits) > 0.5 else ""
            lines.append(
                f"- data-wait fraction: mean {mean_w:.2f}, "
                f"max {max(waits):.2f}{note}"
            )
        lines.append("")

    # -------------------------------------------------------------- timeline
    lines += ["## Timeline", ""]
    t0 = events[0].get("ts", 0) if events else 0
    # lifecycle rows from host 0 only (merged journals repeat them per host);
    # flight records and fleet transitions from every host, host-tagged
    per_run_types = (
        "run_start",
        "checkpoint_save",
        "rollback",
        "quarantine",
        "profile",
        "compiled_program",
        "shutdown",
        # supervisor rows (train/elastic.py) live in host-0's journal dir
        "elastic_restart",
        "elastic_rejoin",
        "elastic_exhausted",
    )
    fleet_types = ("fleet_straggler", "fleet_host_lost", "fleet_host_rejoined")
    # events any host may emit about itself: keep every host's, host-tagged
    any_host_types = ("elastic_resize", "hang_detected", "ckpt_fallback")
    interesting = [
        e
        for e in events
        if (e.get("type") in per_run_types and (not multi or _host_of(e) == 0))
        or e.get("type") in fleet_types
        or e.get("type") in any_host_types
        or e.get("type") == "flight_record"
    ]
    if not interesting:
        lines.append("(no lifecycle events recorded)")
    for e in interesting:
        dt = e.get("ts", t0) - t0
        etype = e["type"]
        detail = ""
        if etype == "checkpoint_save":
            detail = f"step {e.get('step')}"
            if e.get("preemption"):
                detail += " (preemption)"
        elif etype == "rollback":
            detail = (
                f"step {e.get('from_step')} → {e.get('to_step')} "
                f"(#{e.get('rollbacks')})"
            )
        elif etype == "quarantine":
            detail = ", ".join(str(s) for s in e.get("shards", []))
        elif etype == "flight_record":
            detail = f"{e.get('reason')} → {e.get('path')}"
            if multi:
                detail = f"[host {_host_of(e)}] {detail}"
        elif etype == "fleet_straggler":
            detail = (
                f"{_fmt_host(e.get('host_id'))} at step {e.get('step')}, "
                f"lag {e.get('lag')}, symptom {e.get('symptom')}"
            )
        elif etype == "fleet_host_lost":
            detail = (
                f"{_fmt_host(e.get('host_id'))} "
                f"(last step {e.get('last_step')}, heartbeat "
                f"{e.get('heartbeat_age_s')}s stale)"
            )
        elif etype == "fleet_host_rejoined":
            detail = (
                f"{_fmt_host(e.get('host_id'))} at step {e.get('step')} "
                f"after {e.get('lost_for_s')}s"
            )
        elif etype == "elastic_restart":
            detail = (
                f"gen {e.get('generation')}: {e.get('reason')}, world "
                f"{e.get('old_world')} → {e.get('new_world')}, failed hosts "
                f"{e.get('failed_hosts')}, backoff {e.get('backoff_s')}s "
                f"(restart #{e.get('restarts_used')})"
            )
        elif etype == "elastic_rejoin":
            detail = (
                f"gen {e.get('generation')}: world {e.get('old_world')} → "
                f"{e.get('new_world')} (graceful restart back to full size)"
            )
        elif etype == "elastic_exhausted":
            detail = f"{e.get('verdict')} (reason {e.get('reason')})"
        elif etype == "elastic_resize":
            detail = (
                f"{e.get('cause')}: world {e.get('old_world')} → "
                f"{e.get('new_world')} at step {e.get('step')}, epoch "
                f"{e.get('epoch')} resumes with {e.get('shards_remaining')}/"
                f"{e.get('shards_total')} shards unconsumed"
            )
            if multi:
                detail = f"[host {_host_of(e)}] {detail}"
        elif etype == "hang_detected":
            detail = (
                f"step {e.get('step')}: no progress for "
                f"{e.get('stalled_s')}s (deadline {e.get('deadline_s')}s)"
            )
            if multi:
                detail = f"[host {_host_of(e)}] {detail}"
        elif etype == "ckpt_fallback":
            detail = (
                f"restore walked back step {e.get('from_step')} → "
                f"{e.get('to_step')} ({e.get('error')})"
            )
            if multi:
                detail = f"[host {_host_of(e)}] {detail}"
        elif etype == "shutdown":
            detail = f"{e.get('reason')} at step {e.get('step')}"
        elif etype == "run_start":
            detail = f"start_step {e.get('start_step', 0)}"
        elif etype == "profile":
            detail = f"trace capture → {e.get('combined_trace') or e.get('device_trace')}"
        elif etype == "compiled_program":
            detail = (
                f"{e.get('program')}: {_fmt_num(e.get('flops', 0))} flops, "
                f"{_fmt_num(e.get('bytes_accessed', 0))} bytes"
            )
        lines.append(f"- +{dt:8.1f}s  `{etype}`  {detail}")
    lines.append("")
    if flights and not flight:
        lines.append(
            f"(tip: {len(flights)} flight record(s) were written — pass one "
            "via --flightrec for per-step detail around the incident)"
        )
        lines.append("")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "path",
        help="run dir, journal dir, or one journal-*.jsonl segment",
    )
    parser.add_argument(
        "--flightrec",
        default=None,
        help="flight-record JSON for per-step detail around the incident",
    )
    parser.add_argument(
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    try:
        events = read_merged_journal(args.path)
    except FileNotFoundError as e:
        print(f"[run_doctor] {e}", file=sys.stderr)
        return 2
    if not events:
        print(f"[run_doctor] journal at {args.path} is empty", file=sys.stderr)
        return 2

    flight = None
    if args.flightrec:
        try:
            flight = json.loads(Path(args.flightrec).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(
                f"[run_doctor] WARNING: unreadable flight record: {e}",
                file=sys.stderr,
            )

    report = diagnose(events, flight)
    return write_report(report, args.out, tool="run_doctor")


if __name__ == "__main__":
    sys.exit(main())
