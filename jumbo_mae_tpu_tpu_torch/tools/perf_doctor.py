"""Offline perf diagnosis: regressions from BENCH_HISTORY.jsonl, or the
program-cost story of one training run's journal.

Counterpart of the JAX package's top-level ``tools/perf_doctor.py``: the
same report and exit codes over the port's ``obs/perfledger.py`` and
``obs/journal.py``.

    python -m jumbo_mae_tpu_tpu_torch.tools.perf_doctor BENCH_HISTORY.jsonl
    python -m jumbo_mae_tpu_tpu_torch.tools.perf_doctor runs/my_run --out perf.md

Ledger mode (the default — point it at a ``BENCH_HISTORY.jsonl``):

- groups rows by (bench, metric, env_key) — rows are only ever baselined
  against history from the *same* environment fingerprint subset;
- the latest row of each group is compared leg-by-leg against the median of
  the previous ``--baseline-window`` rows, with a stated ``--noise`` band;
  leg direction is inferred from its name (``ms``/``latency``/``seconds``/
  ``p50``/``p99`` → lower is better, anything else → higher is better);
- each verdict names the regressed leg, the delta vs the trailing median,
  and the dominant roofline term of the row's cost-model prediction — the
  first question after "it got slower" is "was it compute- or
  bandwidth-bound when it did";
- predicted-vs-measured gap triage is advisory: on the CPU the chip spec
  is an order-of-magnitude generic, so the gap classifies plumbing
  health, not capacity.

Journal mode (auto-detected when the path holds run-journal events): lists
every ``compiled_program`` event's costs, and the predict-vs-measured
drift of the run's ``step`` rows. Both train CLIs journal that drift
under each row's ``metrics``; the JAX doctor looks for it at the row's
top level only, so its drift line never prints on a CLI's journal
(ROADMAP C.R6). This doctor reads it from ``metrics`` and from the top
level. The verdict names the rows' cost source: XLA's for rows the JAX
package compiled (``source`` ``compiled`` or ``lowered``), ``analytic``
for the port's.

Exit codes: 0 = no regression (diagnosis written), 2 = regression detected
or nothing to diagnose. Like run_doctor/serve_doctor, needs only the
artifact — no backend, no live process.
"""

from __future__ import annotations

import argparse
import statistics
import sys

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import fmt_num, write_report
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
from jumbo_mae_tpu_tpu_torch.obs.perfledger import read_ledger

# leg-name tokens meaning "lower is better"; matched on "_"-split tokens,
# not raw substrings, so ``imgs_per_sec`` ("_s"…) stays higher-is-better
_LOWER_BETTER = {"ms", "s", "latency", "seconds", "p50", "p90", "p99", "p999", "time"}
_HIGHER_BETTER = {"throughput", "qps", "speedup"}


def leg_lower_is_better(name: str) -> bool:
    tokens = set(name.lower().split("_"))
    if tokens & _HIGHER_BETTER or "per" in tokens:  # *_per_sec rates
        return False
    return bool(tokens & _LOWER_BETTER)


def _dominant_term(row: dict) -> str | None:
    pred = row.get("prediction")
    if isinstance(pred, dict):
        return pred.get("bound")
    return None


def _gap_triage(row: dict) -> tuple[float, str] | None:
    """measured / predicted for the row's headline step-time leg."""
    pred = row.get("prediction")
    if not isinstance(pred, dict) or not pred.get("step_time_s"):
        return None
    legs = row.get("legs", {})
    measured_s = None
    for name in ("ms_step_bf16", "ms_step", "p50_ms"):
        if legs.get(name):
            measured_s = float(legs[name]) / 1e3
            break
    if measured_s is None:
        return None
    ratio = measured_s / float(pred["step_time_s"])
    if ratio < 2.0:
        verdict = "near its roofline"
    elif ratio < 10.0:
        verdict = "loose vs its roofline (host/dispatch overhead or an untuned shape)"
    else:
        verdict = "detached from its roofline (generic chip spec, or a stall)"
    return ratio, verdict


def diagnose_ledger(
    rows: list[dict], *, baseline_window: int, noise: float
) -> tuple[str, bool]:
    """Markdown diagnosis + whether any leg regressed."""
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        groups.setdefault(
            (r.get("bench"), r.get("metric"), r.get("env_key")), []
        ).append(r)

    lines = [
        "# perf_doctor",
        "",
        f"- rows: {len(rows)} across {len(groups)} (bench, metric, env) group(s)",
        f"- baseline: median of the previous ≤{baseline_window} comparable "
        f"rows; noise band ±{noise:.0%}",
        "",
    ]
    regressions: list[str] = []
    improvements: list[str] = []
    for (bench, metric, env_key), grp in sorted(
        groups.items(), key=lambda kv: str(kv[0])
    ):
        latest, history = grp[-1], grp[:-1][-baseline_window:]
        lines.append(f"## {bench} · {metric}")
        lines.append("")
        lines.append(
            f"- env_key `{env_key}` · {len(grp)} row(s) · latest git "
            f"`{latest.get('git_sha') or '?'}`"
        )
        term = _dominant_term(latest)
        if term:
            lines.append(f"- dominant roofline term: **{term}**")
        gap = _gap_triage(latest)
        if gap:
            lines.append(
                f"- predicted-vs-measured: {fmt_num(gap[0], 3)}× — {gap[1]} "
                "(advisory)"
            )
        lines.append("")
        if not history:
            lines.append("- first row for this group — nothing to baseline against")
            lines.append("")
            continue
        lines.append("| leg | latest | trailing median | Δ | verdict |")
        lines.append("|---|---|---|---|---|")
        for leg, value in latest.get("legs", {}).items():
            base_vals = [
                float(h["legs"][leg])
                for h in history
                if isinstance(h.get("legs", {}).get(leg), (int, float))
            ]
            if not base_vals or not isinstance(value, (int, float)):
                continue
            base = statistics.median(base_vals)
            if base == 0:
                continue
            delta = float(value) / base - 1.0
            lower = leg_lower_is_better(leg)
            regressed = delta > noise if lower else delta < -noise
            improved = delta < -noise if lower else delta > noise
            verdict = "regressed" if regressed else ("improved" if improved else "ok")
            lines.append(
                f"| {leg} | {fmt_num(value)} | {fmt_num(base)} | "
                f"{delta:+.1%} | {verdict} |"
            )
            if regressed:
                regressions.append(
                    f"leg `{leg}` of {metric} regressed {delta:+.1%} vs the "
                    f"trailing median {fmt_num(base)} (noise band ±{noise:.0%})"
                    + (f"; dominant roofline term: {term}" if term else "")
                )
            elif improved:
                improvements.append(f"leg `{leg}` of {metric} improved {delta:+.1%}")
        lines.append("")

    lines.append("## Verdict")
    lines.append("")
    if regressions:
        for r in regressions:
            lines.append(f"- **REGRESSION**: {r}")
    else:
        lines.append(
            f"- no leg moved beyond the ±{noise:.0%} noise band against its "
            "trailing median — no regression"
        )
    for s in improvements:
        lines.append(f"- {s}")
    return "\n".join(lines) + "\n", bool(regressions)


def _drift(step: dict) -> float | None:
    """A ``step`` row's predict-vs-measured drift: under ``metrics``, where
    both train CLIs write it, or at the row's top level."""
    for where in (step.get("metrics") or {}, step):
        v = where.get("perf/predict_vs_measured")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def diagnose_journal(events: list[dict]) -> tuple[str, bool]:
    """Compiled-cost story of one run: programs, costs, roofline bounds."""
    programs = [e for e in events if e.get("type") == "compiled_program"]
    steps = [e for e in events if e.get("type") == "step"]
    lines = ["# perf_doctor (run journal)", ""]
    if programs:
        lines.append("| program | flops | bytes accessed | peak bytes | source |")
        lines.append("|---|---|---|---|---|")
        for p in programs:
            lines.append(
                f"| {p.get('program')} | {fmt_num(p.get('flops', 0))} | "
                f"{fmt_num(p.get('bytes_accessed', 0))} | "
                f"{fmt_num(p.get('peak_bytes', 0))} | {p.get('source')} |"
            )
        lines.append("")
    drift = [d for d in (_drift(s) for s in steps) if d is not None]
    lines.append("## Verdict")
    lines.append("")
    if not programs:
        lines.append(
            "- no `compiled_program` events — this run predates the cost "
            "model or the backend reported no cost analysis"
        )
    else:
        xla = all(p.get("source") in ("compiled", "lowered") for p in programs)
        lines.append(
            f"- {len(programs)} compiled program(s) with "
            f"{'XLA' if xla else 'analytic'} cost accounting"
        )
    if drift:
        last = drift[-1]
        lines.append(
            f"- predicted-vs-measured drift over the run: last "
            f"{fmt_num(last, 3)}×, median {fmt_num(statistics.median(drift), 3)}× "
            "(advisory on non-TPU chip specs)"
        )
    return "\n".join(lines) + "\n", False


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument(
        "path",
        help="BENCH_HISTORY.jsonl (ledger mode) or a run dir / journal "
        "(journal mode, auto-detected)",
    )
    p.add_argument("--out", default="", help="write the markdown here (default stdout)")
    p.add_argument(
        "--baseline-window",
        type=int,
        default=5,
        help="trailing comparable rows the median baseline uses (default 5)",
    )
    p.add_argument(
        "--noise",
        type=float,
        default=0.08,
        help="relative noise band a leg must exceed to count (default 0.08)",
    )
    args = p.parse_args(argv)

    try:
        rows = read_ledger(args.path)
    except FileNotFoundError:
        print(f"[perf_doctor] no ledger or journal at {args.path}", file=sys.stderr)
        return 2
    if rows:
        md, regressed = diagnose_ledger(
            rows, baseline_window=args.baseline_window, noise=args.noise
        )
    else:
        events = read_journal(args.path)
        if not any(e.get("type") for e in events):
            print(
                f"[perf_doctor] {args.path} holds neither ledger rows nor "
                "journal events",
                file=sys.stderr,
            )
            return 2
        md, regressed = diagnose_journal(events)
    rc = write_report(md, args.out or None, tool="perf_doctor")
    if regressed:
        print("[perf_doctor] perf regression detected", file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
