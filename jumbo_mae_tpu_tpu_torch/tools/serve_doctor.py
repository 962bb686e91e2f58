"""Offline serving diagnosis: JSONL access log → markdown.

Counterpart of the JAX package's top-level ``tools/serve_doctor.py``, the
same report and exit codes over the port's ``obs/journal.py`` and
``obs/slo.py``. The access log (``cli.predict --serve --access-log DIR``,
one crash-safe row per finished request) is enough to reconstruct *what
the callers experienced* after the fact, with no live process and no
/metrics endpoint:

    python -m jumbo_mae_tpu_tpu_torch.tools.serve_doctor runs/serve/access
    python -m jumbo_mae_tpu_tpu_torch.tools.serve_doctor ... --slo 'p99_latency_ms<=250;success_rate>=0.99'
    python -m jumbo_mae_tpu_tpu_torch.tools.serve_doctor ... --out diagnosis.md

The report answers, in order: what the traffic looked like (outcome mix,
exact latency quantiles); whether the SLO was breached and *when* (time
windows over ``--window-s`` buckets) and *which requests* (contiguous rid
clusters); which latency component dominated the slow requests (queue
wait vs coalescing vs compute vs fetch — the triage fork between "scale
out", "shrink max_delay", and "shrink the model"); how each batch bucket
behaved; and where sheds / deadline expiries / shutdown aborts clustered.

With a replica-pool access log (``--serve --replicas N``) the report adds
a per-replica latency/outcome table (keyed on each row's ``replica``
field), retry clusters naming the replica whose failure forced each
requeue (``requeued_from``) and who absorbed the retries, and a pool
event timeline — crashes, hangs, restarts, breaker flips, autoscale
resizes, and weight-swap verdicts (a ``swap_rollback`` also lands in the
Verdict line). Rows carrying ``tenant``/``class`` (the traffic-shaping
tier) add a per-tenant table — with device-seconds / FLOPs / pad-waste
columns when the cost meter stamped ``device_ms``/``cost_flops`` onto the
rows — plus a shaping-vs-starvation verdict: low classes shedding first
is the design working; a shed *interactive* tenant while lower classes
kept being served is priority inversion and is called out as starvation,
and a tenant hogging device-time over its implied share while cheaper
tenants shed is called out as a noisy neighbor (the full chargeback view
lives in ``tools/cost_doctor.py``).

Without ``--slo`` the slow-request threshold defaults to 4x the median ok
latency — a shape-based heuristic for "what would have annoyed a caller",
documented in the report so nobody mistakes it for a configured objective.

Exit codes: 0 = diagnosis written (healthy or not); 2 = no access log.
"""

from __future__ import annotations

import argparse
import sys

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import contiguous_windows, fmt_num, spans_text, write_report
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.obs.slo import SLOObjective, parse_slo

COMPONENTS = ("queue_wait_ms", "admission_ms", "compute_ms", "fetch_ms")


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Exact nearest-rank quantile over already-sorted samples."""
    if not sorted_vals:
        return 0.0
    rank = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[rank]


def _breach_windows(
    rows: list[dict], obj: SLOObjective, t0: float, window_s: float
) -> list[tuple[int, int]]:
    """Time buckets (``window_s`` wide, relative to the first request)
    whose violation fraction exceeds the objective's error budget, merged
    into contiguous runs."""
    buckets: dict[int, list[bool]] = {}
    for r in rows:
        w = int((r.get("ts", t0) - t0) // window_s)
        if obj.percentile is not None:
            if r["outcome"] != "ok" or r.get("lat_ms") is None:
                continue
            bad = r["lat_ms"] > obj.threshold
        else:
            bad = r["outcome"] != "ok"
        buckets.setdefault(w, []).append(bad)
    breached = [
        w for w, flags in buckets.items()
        if flags and sum(flags) / len(flags) > obj.budget
    ]
    return contiguous_windows(breached)


def _windows_clock(windows: list[tuple[int, int]], window_s: float) -> str:
    return ", ".join(
        f"t+{int(a * window_s)}s–t+{int((b + 1) * window_s)}s"
        for a, b in windows
    )


def diagnose(
    rows: list[dict],
    objectives: list[SLOObjective],
    *,
    window_s: float,
    events: list[dict] | None = None,
) -> str:
    """Render the markdown diagnosis for one serve run's request rows
    (plus, when the log came from a replica pool, the non-request pool
    events — crashes, restarts, breaker flips, swap verdicts)."""
    lines: list[str] = ["# Serve doctor report", ""]
    ok_rows = [r for r in rows if r["outcome"] == "ok"]
    ok_lat = sorted(r["lat_ms"] for r in ok_rows if r.get("lat_ms") is not None)
    t0 = min(r.get("ts", 0) for r in rows)
    t1 = max(r.get("ts", 0) for r in rows)
    span = max(t1 - t0, 1e-9)

    # ------------------------------------------------------------- traffic
    outcomes: dict[str, int] = {}
    for r in rows:
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
    mix = ", ".join(f"{k}: {v}" for k, v in sorted(outcomes.items()))
    lines += [
        "## Traffic",
        "",
        f"- {len(rows)} request(s) over {span:.1f}s "
        f"({len(rows) / span:.1f} req/s) — outcomes: {mix}",
    ]
    if ok_lat:
        lines.append(
            f"- ok latency: p50 {fmt_num(_quantile(ok_lat, 0.50))} ms, "
            f"p99 {fmt_num(_quantile(ok_lat, 0.99))} ms, "
            f"max {fmt_num(ok_lat[-1])} ms (exact, from "
            f"{len(ok_lat)} samples)"
        )
    lines.append("")

    # auto-threshold when no SLO was configured: 4x the median ok latency
    auto = None
    if not objectives and ok_lat:
        auto = max(4.0 * _quantile(ok_lat, 0.50), 1e-3)
        objectives = [SLOObjective("p99_latency_ms", "<=", round(auto, 3))]

    # ------------------------------------------------------------- verdict
    verdict: list[str] = []
    slow_rows: list[dict] = []
    lines += ["## SLO analysis", ""]
    if auto is not None:
        lines.append(
            f"- no SLO configured — using the auto slow-request threshold "
            f"(4x median ok latency = {fmt_num(auto)} ms); pass --slo for "
            f"the configured objectives"
        )
    for obj in objectives:
        if obj.percentile is not None:
            viol = [
                r for r in ok_rows
                if r.get("lat_ms") is not None and r["lat_ms"] > obj.threshold
            ]
            frac = len(viol) / len(ok_lat) if ok_lat else 0.0
        else:
            viol = [r for r in rows if r["outcome"] != "ok"]
            frac = len(viol) / len(rows)
        breached = frac > obj.budget
        slow_rows.extend(v for v in viol if v["outcome"] == "ok")
        status = "**breached**" if breached else "met"
        lines.append(
            f"- `{obj.name}`: {status} — {len(viol)} violation(s), "
            f"{frac * 100:.1f}% of requests vs a "
            f"{obj.budget * 100:g}% error budget "
            f"(burn {fmt_num(frac / obj.budget)})"
        )
        if viol:
            wins = _breach_windows(rows, obj, t0, window_s)
            if wins:
                lines.append(
                    f"  - breach window(s) ({window_s:g}s buckets): "
                    f"{_windows_clock(wins, window_s)}"
                )
            rids = contiguous_windows(r["rid"] for r in viol)
            lines.append(
                f"  - violating {spans_text(rids, noun='request')}"
            )
        if breached:
            verdict.append(f"`{obj.name}` breached")
    if not verdict:
        verdict.append("all objectives met")
    lines.append("")

    # ------------------------------------------- dominant latency component
    focus = slow_rows if slow_rows else ok_rows
    dominant = None
    if focus:
        lines += ["## Latency decomposition", ""]
        which = "slow (violating)" if slow_rows else "ok"
        lines.append(
            f"- mean per-leg latency over the {len(focus)} {which} request(s):"
        )
        means = {}
        for comp in COMPONENTS:
            vals = [r[comp] for r in focus if r.get(comp) is not None]
            if vals:
                means[comp] = sum(vals) / len(vals)
        dominant = max(means, key=means.get) if means else None
        for comp in COMPONENTS:
            if comp in means:
                mark = " ← dominant" if comp == dominant else ""
                lines.append(
                    f"  - {comp[:-3]}: {fmt_num(means[comp])} ms{mark}"
                )
        if dominant is not None:
            name = dominant[:-3]
            verdict.append(f"dominant latency component: **{name}**")
            hint = {
                "queue_wait": "requests stalled before admission — add "
                "capacity / shed earlier (max_queue) / check submit-side "
                "stalls",
                "admission": "coalescing wait dominates — lower "
                "max_delay_ms or raise offered load",
                "compute": "the forward dominates — bigger buckets, a "
                "smaller model, or a faster device",
                "fetch": "device→host transfer dominates — fetch less "
                "(pool tokens on device) or overlap the copy",
            }[name]
            lines.append(f"  - triage: {hint}")
        lines.append("")

    # ------------------------------------------------------------- buckets
    by_bucket: dict[int, list[float]] = {}
    for r in ok_rows:
        if r.get("bucket") is not None and r.get("lat_ms") is not None:
            by_bucket.setdefault(int(r["bucket"]), []).append(r["lat_ms"])
    if by_bucket:
        lines += [
            "## Buckets",
            "",
            "| bucket | requests | p50 ms | p99 ms |",
            "|---|---|---|---|",
        ]
        worst, worst_p99 = None, -1.0
        for b in sorted(by_bucket):
            vals = sorted(by_bucket[b])
            p99 = _quantile(vals, 0.99)
            if p99 > worst_p99:
                worst, worst_p99 = b, p99
            lines.append(
                f"| {b} | {len(vals)} | {fmt_num(_quantile(vals, 0.50))} "
                f"| {fmt_num(p99)} |"
            )
        lines += ["", f"- worst bucket by p99: **{worst}** "
                  f"({fmt_num(worst_p99)} ms)", ""]

    # ------------------------------------------------------------ replicas
    rep_rows = [r for r in rows if r.get("replica") is not None]
    if rep_rows:
        by_rep: dict[str, list[dict]] = {}
        for r in rep_rows:
            by_rep.setdefault(str(r["replica"]), []).append(r)
        lines += [
            "## Replicas",
            "",
            "| replica | requests | ok | late | retried-in | p50 ms | p99 ms |",
            "|---|---|---|---|---|---|---|",
        ]
        for name in sorted(by_rep):
            sel = by_rep[name]
            oks = [r for r in sel if r["outcome"] == "ok"]
            lat = sorted(
                r["lat_ms"] for r in oks if r.get("lat_ms") is not None
            )
            late = sum(1 for r in sel if r["outcome"] == "late")
            retried = sum(1 for r in sel if r.get("retries"))
            lines.append(
                f"| {name} | {len(sel)} | {len(oks)} | {late} | {retried} "
                f"| {fmt_num(_quantile(lat, 0.50)) if lat else '-'} "
                f"| {fmt_num(_quantile(lat, 0.99)) if lat else '-'} |"
            )
        lines.append("")
        # retry clusters: which replica's failure forced the requeues —
        # the offline answer to "which replica died and who absorbed it"
        retried_rows = [r for r in rows if r.get("retries")]
        if retried_rows:
            by_src: dict[str, list[dict]] = {}
            for r in retried_rows:
                src = str(r.get("requeued_from") or "unknown")
                by_src.setdefault(src, []).append(r)
            lines += ["### Retry clusters (by failed replica)", ""]
            for src in sorted(by_src):
                sel = by_src[src]
                rids = contiguous_windows(r["rid"] for r in sel)
                served_on = sorted(
                    {str(r["replica"]) for r in sel if r.get("replica")}
                )
                ok_n = sum(1 for r in sel if r["outcome"] == "ok")
                lines.append(
                    f"- requeued off **{src}** ({len(sel)} request(s), "
                    f"{ok_n} recovered ok"
                    + (
                        f" on {', '.join(served_on)}" if served_on else ""
                    )
                    + f"): {spans_text(rids, noun='request')}"
                )
            lines.append("")

    # ------------------------------------------------------------- tenants
    ten_rows = [r for r in rows if r.get("tenant") is not None]
    if ten_rows:
        by_ten: dict[str, list[dict]] = {}
        for r in ten_rows:
            by_ten.setdefault(str(r["tenant"]), []).append(r)
        lines += [
            "## Tenants",
            "",
            "| tenant | class | requests | ok | shed | device s | GFLOPs "
            "| waste s | p50 ms | p99 ms |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        shed_by_ten: dict[str, int] = {}
        class_of: dict[str, str] = {}
        dev_by_ten: dict[str, float] = {}
        for name in sorted(by_ten):
            sel = by_ten[name]
            tclass = next(
                (str(r["class"]) for r in sel if r.get("class")), "?"
            )
            class_of[name] = tclass
            oks = [r for r in sel if r["outcome"] == "ok"]
            lat = sorted(
                r["lat_ms"] for r in oks if r.get("lat_ms") is not None
            )
            shed_n = sum(1 for r in sel if r["outcome"] == "shed")
            shed_by_ten[name] = shed_n
            # cost columns from the meter-stamped device_ms/cost_flops;
            # waste = device-time that bought pad rows (row share × pad)
            dev_s = sum(r.get("device_ms") or 0.0 for r in sel) / 1000.0
            gflops = sum(r.get("cost_flops") or 0.0 for r in sel) / 1e9
            waste_s = sum(
                (r.get("device_ms") or 0.0) * (r.get("pad") or 0.0)
                for r in sel
            ) / 1000.0
            dev_by_ten[name] = dev_s
            lines.append(
                f"| {name} | {tclass} | {len(sel)} | {len(oks)} | {shed_n} "
                f"| {fmt_num(dev_s) if dev_s else '-'} "
                f"| {fmt_num(gflops) if gflops else '-'} "
                f"| {fmt_num(waste_s) if waste_s else '-'} "
                f"| {fmt_num(_quantile(lat, 0.50)) if lat else '-'} "
                f"| {fmt_num(_quantile(lat, 0.99)) if lat else '-'} |"
            )
        lines.append("")
        # shaping vs starvation: shedding *low* classes under pressure is
        # the design working; a shed interactive tenant while lower
        # classes kept being served is priority inversion
        class_rank = {"interactive": 0, "batch": 1, "scavenger": 2}
        shed_tenants = [t for t, n in shed_by_ten.items() if n > 0]
        starved = [
            t for t in shed_tenants
            if class_rank.get(class_of[t], 1) == 0
            and any(
                class_rank.get(class_of[o], 1) > 0
                and sum(1 for r in by_ten[o] if r["outcome"] == "ok") > 0
                for o in by_ten
                if o != t
            )
        ]
        # noisy neighbor: a tenant well over its implied (equal) share of
        # metered device-time while a cheaper tenant was shedding — the
        # cost-accounting refinement of the starvation signal
        noisy: list[str] = []
        total_dev = sum(dev_by_ten.values())
        if total_dev > 0 and len(dev_by_ten) > 1 and shed_tenants:
            fair = 1.0 / len(dev_by_ten)
            for name, dev_s in dev_by_ten.items():
                share = dev_s / total_dev
                if share <= 1.25 * fair:
                    continue
                if any(
                    o != name and dev_by_ten[o] < dev_s
                    for o in shed_tenants
                ):
                    noisy.append(name)
        if starved:
            verdict.append(
                "**starvation**: interactive tenant(s) "
                + ", ".join(f"`{t}`" for t in sorted(starved))
                + " shed while lower classes were served"
            )
        elif shed_tenants:
            verdict.append(
                "shaping shed "
                + ", ".join(
                    f"`{t}` ({class_of[t]}, {shed_by_ten[t]})"
                    for t in sorted(shed_tenants)
                )
                + " — low classes gave way first"
            )
        if noisy:
            verdict.append(
                "noisy neighbor: "
                + ", ".join(
                    f"`{t}` ({dev_by_ten[t] / total_dev * 100:.0f}% of "
                    f"device-time)"
                    for t in sorted(noisy)
                )
                + " over its implied share while cheaper tenants shed"
            )

    # ------------------------------------------------- non-ok rid clusters
    bad = [r for r in rows if r["outcome"] not in ("ok",)]
    if bad:
        lines += ["## Shed / deadline / abort clusters", ""]
        for outcome in ("shed", "deadline", "late", "aborted", "shutdown"):
            sel = [r for r in bad if r["outcome"] == outcome]
            if sel:
                rids = contiguous_windows(r["rid"] for r in sel)
                lines.append(
                    f"- {outcome} ({len(sel)}): "
                    f"{spans_text(rids, noun='request')}"
                )
        lines.append("")

    # --------------------------------------------------- pool event timeline
    POOL_EVENTS = (
        "replica_crash", "replica_hang", "replica_restart",
        "replica_restart_failed", "breaker_open", "breaker_close",
        "swap_start", "swap_canary", "swap_rejected", "swap_rollback",
        "swap_promoted", "autoscale", "replica_added", "replica_removed",
    )
    pool_ev = [
        e for e in (events or []) if e.get("type") in POOL_EVENTS
    ]
    if pool_ev:
        lines += ["## Pool events", ""]
        for e in pool_ev:
            t_rel = e.get("ts", t0) - t0
            detail = ", ".join(
                f"{k}={v}"
                for k, v in e.items()
                if k not in ("ts", "seq", "type") and v is not None
            )
            lines.append(f"- t+{t_rel:.1f}s `{e['type']}` — {detail}")
        lines.append("")
        rollbacks = sum(1 for e in pool_ev if e["type"] == "swap_rollback")
        if rollbacks:
            verdict.append(
                f"{rollbacks} weight swap(s) **rolled back** "
                "(see Pool events)"
            )

    # verdict goes up front, rendered last (it needs everything above)
    lines[2:2] = ["## Verdict", "", f"- {'; '.join(verdict)}", ""]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "path", help="access-log dir (or one journal-*.jsonl segment)"
    )
    parser.add_argument(
        "--slo",
        default="",
        help="objectives to judge against, e.g. 'p99_latency_ms<=250;"
        "success_rate>=0.99' (default: auto 4x-median threshold)",
    )
    parser.add_argument(
        "--window-s",
        type=float,
        default=10.0,
        help="time-bucket width for naming breach windows (default 10s)",
    )
    parser.add_argument(
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    try:
        events = read_journal(args.path)
    except FileNotFoundError as e:
        print(f"[serve_doctor] {e}", file=sys.stderr)
        return 2
    rows = [e for e in events if e.get("type") == "request"]
    if not rows:
        print(
            f"[serve_doctor] no request rows in the access log at {args.path}",
            file=sys.stderr,
        )
        return 2

    objectives = parse_slo(args.slo) if args.slo else []
    report = diagnose(rows, objectives, window_s=args.window_s, events=events)
    return write_report(report, args.out, tool="serve_doctor")


if __name__ == "__main__":
    sys.exit(main())
