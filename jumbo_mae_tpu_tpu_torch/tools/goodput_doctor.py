"""Offline goodput diagnosis: merged journal → "where did my time go".

Counterpart of the JAX package's top-level ``tools/goodput_doctor.py``:
the same report and exit codes over the port's ``obs/journal.py`` and
``obs/goodput.py``.

The run doctor explains *incidents*; this tool prices *time*. From the
crash-safe journal alone — including the per-generation journals an
elastic supervisor run leaves behind — it answers: what fraction of the
run's wall-clock was productive step compute, and where did the rest go
(compile, data wait, eval, checkpoint save/restore, rollback recompute,
restart downtime, hang-detection latency, idle)?

    python -m jumbo_mae_tpu_tpu_torch.tools.goodput_doctor runs/my_run          # run dir
    python -m jumbo_mae_tpu_tpu_torch.tools.goodput_doctor runs/my_run/journal  # journal dir
    python -m jumbo_mae_tpu_tpu_torch.tools.goodput_doctor ... --out goodput.md

The report has three parts:

- **Verdict + attribution table** — goodput fraction, per-bucket seconds
  and shares, and the conservation check (buckets must sum to wall-clock;
  the stitcher's residual-idle construction makes over-attribution the
  detectable failure).
- **Restart-cost breakdown** — one row per supervisor restart: reason,
  detection latency, backoff, total downtime, and lost steps (executed −
  committed at the moment of death).
- **Checkpoint-interval advisor** — Young's optimal interval
  √(2·save_cost·MTBF) from the measured save cost and observed failure
  rate, as a concrete `run.ckpt_every` recommendation.

Exit codes: 0 = report written (healthy or not); 2 = no journal found.
"""

from __future__ import annotations

import argparse
import sys

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import write_report
from jumbo_mae_tpu_tpu_torch.obs.goodput import (
    GOODPUT_BUCKETS,
    advise_ckpt_interval,
    bucket_display,
    stitch_generations,
)
from jumbo_mae_tpu_tpu_torch.obs.journal import read_merged_journal


def _pct(v: float, total: float) -> str:
    return f"{100.0 * v / total:.1f}%" if total > 0 else "–"


def diagnose(events: list[dict]) -> str:
    """Render the markdown goodput report for one run's journal events."""
    g = stitch_generations(events)
    wall = g["wall_s"]
    buckets = g["buckets"]
    lines: list[str] = ["# Goodput doctor report", ""]

    # ------------------------------------------------------------- verdict
    # idle is the unattributed residual, not a diagnosis — rank only the
    # attributed non-productive buckets for the verdict line
    nonprod = sorted(
        (
            (k, v)
            for k, v in buckets.items()
            if k not in ("productive", "idle") and v > 0
        ),
        key=lambda kv: kv[1],
        reverse=True,
    )
    conserved = g["conservation_error"] <= 0.01
    lines += [
        "## Verdict",
        "",
        f"- goodput: **{g['goodput_fraction'] * 100:.1f}%** of "
        f"{wall:.1f}s wall-clock was productive step compute "
        f"({g['steps_committed']} steps committed"
        + (f", {g['steps_lost']} lost to restarts" if g["steps_lost"] else "")
        + ")",
    ]
    if nonprod:
        top, top_s = nonprod[0]
        lines.append(
            f"- top non-productive bucket: **{bucket_display(top)}** "
            f"({top_s:.1f}s, {_pct(top_s, wall)} of wall-clock)"
        )
    idle_s = buckets.get("idle", 0.0)
    if wall > 0 and idle_s / wall >= 0.25:
        lines.append(
            f"- unattributed (idle) residual is large: {idle_s:.1f}s "
            f"({_pct(idle_s, wall)} of wall-clock) — host-side setup and "
            "gaps no ledger span covered"
        )
    if g["failures"]:
        lines.append(
            f"- {g['failures']} restart(s) observed; restart downtime "
            f"{buckets['restart_downtime']:.1f}s + hang-detection latency "
            f"{buckets['hang_latency']:.1f}s"
        )
    lines.append(
        f"- conservation: {'**OK**' if conserved else '**VIOLATED**'} "
        f"(attribution error {g['conservation_error'] * 100:.2f}% of "
        "wall-clock, tolerance 1%)"
    )
    if len(g["generations"]) > 1:
        lines.append(
            f"- stitched across {len(g['generations'])} process "
            "generation(s) of an elastic run"
        )
    lines.append("")

    # -------------------------------------------------- attribution table
    lines += [
        "## Wall-clock attribution",
        "",
        "| bucket | seconds | share |",
        "|---|---:|---:|",
    ]
    for b in GOODPUT_BUCKETS:
        v = buckets.get(b, 0.0)
        lines.append(f"| {bucket_display(b)} | {v:.1f} | {_pct(v, wall)} |")
    lines += [f"| **wall-clock** | **{wall:.1f}** | 100% |", ""]

    # ---------------------------------------------- restart-cost breakdown
    lines += ["## Restart costs", ""]
    if g["restarts"]:
        lines += [
            "| generation | reason | detection s | backoff s | downtime s "
            "| lost steps | lost s |",
            "|---:|---|---:|---:|---:|---:|---:|",
        ]
        for r in g["restarts"]:
            lines.append(
                f"| {r['generation']} | {r['reason']} | "
                f"{r['detection_s']:.1f} | {r['backoff_s']:.1f} | "
                f"{r['downtime_s']:.1f} | {r['lost_steps']} | "
                f"{r.get('lost_seconds', 0.0):.1f} |"
            )
        lines.append("")
    else:
        lines += ["(no supervisor restarts observed)", ""]

    # -------------------------------------------- checkpoint-interval advisor
    lines += ["## Checkpoint-interval advisor", ""]
    if g["save_cost_s"] is None or g["step_time_s"] is None:
        lines += [
            "(not enough data: need at least one measured checkpoint save "
            "and one productive step)",
            "",
        ]
    else:
        adv = advise_ckpt_interval(
            g["save_cost_s"],
            g["mtbf_s"] or 0.0,
            g["step_time_s"],
            observed_span_s=wall,
        )
        mtbf_note = (
            f"no failures observed — using the run span {adv['mtbf_s']:.0f}s "
            "as an MTBF lower bound (the optimal interval can only be longer)"
            if adv["mtbf_is_bound"]
            else f"MTBF {adv['mtbf_s']:.0f}s from {g['failures']} failure(s) "
            f"over {wall:.0f}s"
        )
        lines += [
            f"- measured save cost: {adv['save_cost_s']:.2f}s/checkpoint; "
            f"step time: {adv['step_time_s']:.3f}s",
            f"- {mtbf_note}",
            f"- Young's optimal interval √(2·save_cost·MTBF) ≈ "
            f"{adv['interval_s']:.0f}s",
            f"- **recommendation: `run.ckpt_every={adv['ckpt_every']}`** "
            f"(≈ one save every {adv['interval_s']:.0f}s at the measured "
            "step time)",
            "",
        ]
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
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    try:
        events = read_merged_journal(args.path)
    except FileNotFoundError as e:
        print(f"[goodput_doctor] {e}", file=sys.stderr)
        return 2
    if not events:
        print(
            f"[goodput_doctor] journal at {args.path} is empty",
            file=sys.stderr,
        )
        return 2

    report = diagnose(events)
    return write_report(report, args.out, tool="goodput_doctor")


if __name__ == "__main__":
    sys.exit(main())
