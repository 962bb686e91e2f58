"""Offline tenant chargeback: access log (or run journal) → cost report.

Counterpart of the JAX package's top-level ``tools/cost_doctor.py``, the
same report and exit codes over the port's ``obs/journal.py``. It
answers "who consumed the capacity and what did it cost". Input is a
crash-safe access-log directory (``cli.predict --access-log``,
``<out>/access`` of ``cli.batch``): request rows carry the cost meter's
per-row ``device_ms``/``cost_flops`` stamps, and periodic
``tenant_usage`` events carry the meter's cumulative ledgers::

    python -m jumbo_mae_tpu_tpu_torch.tools.cost_doctor runs/serve/access
    python -m jumbo_mae_tpu_tpu_torch.tools.cost_doctor ... --out chargeback.md

A training journal works too: the weights publisher bills each publish
to a ``publish`` tenant as ``tenant_usage`` rows, a *ledger-only* tenant
in the table.

The report, in order: **Verdict** (budget exhaustion, ledger/rows
disagreement, a noisy neighbour), **Chargeback** (per tenant: requests,
ok/shed, device-seconds, share, GFLOPs, pad waste, sheds by typed
reason), **Waste attribution**, **Budgets** (budget against window
usage from the last ``tenant_usage`` rows) and **Reconciliation** (the
rows' sums against the meter's journaled totals: they disagree only when
rows were lost).

Exit codes: 0 = report written (healthy or not); 2 = no access log or no
costed rows to account.
"""

from __future__ import annotations

import argparse
import sys

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import fmt_num, write_report
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

# typed shed classes the scheduler stamps into the err column
_SHED_REASONS = {
    "TenantQuotaError": "quota",
    "TenantPressureError": "pressure",
    "TenantBudgetError": "budget",
}


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    rank = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[rank]


def _tenant_bills(rows: list[dict]) -> dict[str, dict]:
    """Aggregate request rows into per-tenant bills (row-level truth)."""
    bills: dict[str, dict] = {}
    for r in rows:
        name = str(r.get("tenant") or "_default")
        b = bills.setdefault(
            name,
            {
                "class": "?",
                "requests": 0,
                "ok": 0,
                "shed": 0,
                "shed_reasons": {},
                "device_s": 0.0,
                "flops": 0.0,
                "waste_s": 0.0,
                "lat_ms": [],
            },
        )
        if r.get("class"):
            b["class"] = str(r["class"])
        b["requests"] += 1
        if r["outcome"] == "ok":
            b["ok"] += 1
            if r.get("lat_ms") is not None:
                b["lat_ms"].append(r["lat_ms"])
        elif r["outcome"] == "shed":
            b["shed"] += 1
            reason = _SHED_REASONS.get(str(r.get("err")), "queue")
            b["shed_reasons"][reason] = b["shed_reasons"].get(reason, 0) + 1
        b["device_s"] += (r.get("device_ms") or 0.0) / 1000.0
        b["flops"] += r.get("cost_flops") or 0.0
        b["waste_s"] += (
            (r.get("device_ms") or 0.0) * (r.get("pad") or 0.0) / 1000.0
        )
    return bills


def diagnose(rows: list[dict], events: list[dict]) -> tuple[str, str | None]:
    """Render the chargeback markdown; returns (report, top_consumer)."""
    lines: list[str] = ["# Cost doctor report", ""]
    verdict: list[str] = []
    bills = _tenant_bills(rows)
    # last tenant_usage row per tenant = the meter's final cumulative word
    usage: dict[str, dict] = {}
    for e in events:
        if e.get("type") == "tenant_usage" and e.get("tenant"):
            usage[str(e["tenant"])] = e
    # ledger-only tenants never emit request rows — e.g. the train-side
    # ``publish`` tenant, billed per weights-publish straight into the
    # training journal — so their bill comes from the journaled ledger
    ledger_only = sorted(set(usage) - set(bills))
    for name in ledger_only:
        u = usage[name]
        bills[name] = {
            "class": str(u.get("class") or "?"),
            "requests": int(u.get("requests") or 0),
            "ok": int(u.get("requests") or 0),
            "shed": 0,
            "shed_reasons": {},
            "device_s": float(u.get("device_s") or 0.0),
            "flops": float(u.get("flops") or 0.0),
            "waste_s": float(u.get("waste_device_s") or 0.0),
            "lat_ms": [],
        }
    total_dev = sum(b["device_s"] for b in bills.values())
    total_flops = sum(b["flops"] for b in bills.values())

    # ---------------------------------------------------------- chargeback
    lines += [
        "## Chargeback",
        "",
        "| tenant | class | requests | ok | shed (reasons) | device s "
        "| share | GFLOPs | waste s | p99 ms |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    top = None
    for name in sorted(bills, key=lambda n: -bills[n]["device_s"]):
        b = bills[name]
        if top is None:
            top = name
        share = b["device_s"] / total_dev if total_dev > 0 else 0.0
        reasons = (
            " (" + ", ".join(
                f"{r}: {n}" for r, n in sorted(b["shed_reasons"].items())
            ) + ")"
            if b["shed_reasons"]
            else ""
        )
        lat = sorted(b["lat_ms"])
        lines.append(
            f"| {name} | {b['class']} | {b['requests']} | {b['ok']} "
            f"| {b['shed']}{reasons} "
            f"| {fmt_num(b['device_s'])} | {share * 100:.1f}% "
            f"| {fmt_num(b['flops'] / 1e9)} | {fmt_num(b['waste_s'])} "
            f"| {fmt_num(_quantile(lat, 0.99)) if lat else '-'} |"
        )
    lines += [
        "",
        f"- metered total: {fmt_num(total_dev)} device-s, "
        f"{fmt_num(total_flops / 1e9)} GFLOPs across "
        f"{sum(b['requests'] for b in bills.values())} request row(s)",
    ]
    if top is not None and total_dev > 0:
        lines.append(
            f"- top consumer: **{top}** "
            f"({bills[top]['device_s'] / total_dev * 100:.1f}% of "
            f"device-time)"
        )
    if ledger_only:
        lines.append(
            "- ledger-only tenant(s) (no request rows; billed from "
            "`tenant_usage`): " + ", ".join(f"`{t}`" for t in ledger_only)
        )
    lines.append("")

    # ---------------------------------------------------- waste attribution
    total_waste = sum(b["waste_s"] for b in bills.values())
    if total_dev > 0:
        lines += ["## Waste attribution", ""]
        lines.append(
            f"- {fmt_num(total_waste)} of {fmt_num(total_dev)} device-s "
            f"({total_waste / total_dev * 100:.1f}%) bought bucket padding"
        )
        for name in sorted(bills, key=lambda n: -bills[n]["waste_s"]):
            b = bills[name]
            if b["waste_s"] <= 0 or b["device_s"] <= 0:
                continue
            lines.append(
                f"- `{name}`: {fmt_num(b['waste_s'])} s "
                f"({b['waste_s'] / b['device_s'] * 100:.1f}% of its bill)"
            )
        lines.append("")

    # -------------------------------------------------------------- budgets
    budgeted = {
        t: u for t, u in usage.items() if u.get("budget_device_s") is not None
    }
    if budgeted:
        lines += [
            "## Budgets",
            "",
            "| tenant | budget (device s / window) | window usage | status |",
            "|---|---|---|---|",
        ]
        for name in sorted(budgeted):
            u = budgeted[name]
            over = bool(u.get("over_budget"))
            status = "**exhausted**" if over else "within budget"
            lines.append(
                f"| {name} | {fmt_num(u['budget_device_s'])} "
                f"| {fmt_num(u.get('window_device_s') or 0.0)} "
                f"| {status} |"
            )
            if over:
                verdict.append(
                    f"`{name}` exhausted its budget "
                    f"(degraded to scavenger-class shedding)"
                )
        lines.append("")

    # ------------------------------------------------------- reconciliation
    if usage:
        ledger_dev = sum(u.get("device_s") or 0.0 for u in usage.values())
        ledger_flops = sum(u.get("flops") or 0.0 for u in usage.values())
        lines += ["## Reconciliation (rows vs ledger)", ""]
        if ledger_dev > 0:
            delta = abs(total_dev - ledger_dev) / ledger_dev * 100.0
            agree = "agree" if delta <= 1.0 else "**disagree**"
            lines.append(
                f"- device-seconds: rows {fmt_num(total_dev)} vs ledger "
                f"{fmt_num(ledger_dev)} — {agree} (Δ {delta:.2f}%)"
            )
            if delta > 1.0:
                verdict.append(
                    f"ledger/rows disagree by {delta:.1f}% — request rows "
                    "were lost (torn tail or crash mid-batch)"
                )
        if ledger_flops > 0:
            delta_f = abs(total_flops - ledger_flops) / ledger_flops * 100.0
            lines.append(
                f"- FLOPs: rows {fmt_num(total_flops / 1e9)} vs ledger "
                f"{fmt_num(ledger_flops / 1e9)} GFLOPs (Δ {delta_f:.2f}%)"
            )
        lines.append("")

    # ------------------------------------------------------- noisy neighbor
    shed_tenants = [t for t, b in bills.items() if b["shed"] > 0]
    noisy: list[str] = []
    if total_dev > 0 and len(bills) > 1 and shed_tenants:
        fair = 1.0 / len(bills)
        for name, b in bills.items():
            share = b["device_s"] / total_dev
            if share <= 1.25 * fair:
                continue
            if any(
                o != name and bills[o]["device_s"] < b["device_s"]
                for o in shed_tenants
            ):
                noisy.append(name)
    if noisy:
        verdict.append(
            "noisy neighbor: "
            + ", ".join(
                f"`{t}` ({bills[t]['device_s'] / total_dev * 100:.0f}% of "
                f"device-time)"
                for t in sorted(noisy)
            )
            + " over its implied share while cheaper tenants shed"
        )
    if not verdict:
        verdict.append("no budget exhaustion or noisy-neighbor signal")

    lines[2:2] = ["## Verdict", "", f"- {'; '.join(verdict)}", ""]
    return "\n".join(lines), top


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "path", help="access-log dir (or one journal-*.jsonl segment)"
    )
    parser.add_argument(
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    try:
        events = read_journal(args.path)
    except FileNotFoundError as e:
        print(f"[cost_doctor] {e}", file=sys.stderr)
        return 2
    rows = [e for e in events if e.get("type") == "request"]
    costed = [r for r in rows if r.get("device_ms") is not None]
    # a training journal has no request rows at all, but its tenant_usage
    # ledger (the `publish` tenant) is still chargeable
    if not costed and not any(
        e.get("type") == "tenant_usage" for e in events
    ):
        print(
            f"[cost_doctor] no costed request rows or tenant_usage events "
            f"in {args.path} — was a CostMeter attached?",
            file=sys.stderr,
        )
        return 2

    report, _top = diagnose(rows, events)
    return write_report(report, args.out, tool="cost_doctor")


if __name__ == "__main__":
    sys.exit(main())
