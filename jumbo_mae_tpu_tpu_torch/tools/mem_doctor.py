"""Offline memory diagnosis: journaled ``mem_sample`` rows → markdown.

Counterpart of the JAX package's top-level ``tools/mem_doctor.py``, the
same report and exit codes over the port's ``obs/journal.py``. It
explains a run's memory (where the peak was, which component grew, and
whether the leak sentinel's live verdict holds up) from the crash-safe
journal alone, with no live process and no /metrics endpoint:

    python -m jumbo_mae_tpu_tpu_torch.tools.mem_doctor runs/my_run
    python -m jumbo_mae_tpu_tpu_torch.tools.mem_doctor runs/my_run --out mem.md

The report covers:

- **Verdict** — the leak sentinel's journaled ``mem_leak_suspect`` (naming
  the fastest-growing component), plus the OOM-risk estimate: measured
  device peak / the ChipSpec HBM capacity recorded in the samples (skipped
  on backends with no capacity claim, e.g. CPU smoke).
- **Peak timeline** — RSS / device-peak per journaled sample.
- **Component attribution** — first→last bytes and growth per accounted
  component (``mem_component_bytes`` sources), fastest grower first.
- **HBM predict-vs-measured** — the last sample's per-program drift ratios.

Exit codes: 0 = healthy diagnosis written; 2 = incident (a leak suspect was
journaled) or nothing to diagnose (no ``mem_sample`` rows — run.memwatch
off, or the run died before its first log boundary).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.obs.doctor_common import fmt_num as _fmt_num
from jumbo_mae_tpu_tpu_torch.obs.doctor_common import write_report
from jumbo_mae_tpu_tpu_torch.obs.journal import read_merged_journal

MB = 1024 * 1024


def _mib(v) -> str:
    return f"{float(v) / MB:.1f} MiB"


def _timeline_rows(samples: list[dict], limit: int) -> list[dict]:
    """At most ``limit`` rows, always keeping the first and last sample —
    the report wants the trend, not a row per log window of a long run."""
    if len(samples) <= limit:
        return samples
    stride = max(1, (len(samples) - 1) // (limit - 1))
    picked = samples[::stride]
    if picked[-1] is not samples[-1]:
        picked.append(samples[-1])
    return picked


def diagnose(events: list[dict], args) -> tuple[str, int]:
    """Markdown report + exit code from one run's journal events."""
    samples = [e for e in events if e.get("type") == "mem_sample"]
    leaks = [e for e in events if e.get("type") == "mem_leak_suspect"]
    dumps = [
        e
        for e in events
        if e.get("type") == "flight_record" and e.get("reason") == "mem_leak"
    ]

    lines = ["# Memory doctor report", ""]
    rc = 0

    # -------------------------------------------------------------- verdict
    lines += ["## Verdict", ""]
    if leaks:
        rc = 2
        for e in leaks:
            lines.append(
                f"- leak suspected: **{e.get('component')}** — "
                f"+{_mib(e.get('robust_growth_bytes', 0))} robust RSS growth "
                f"over {e.get('window')} samples "
                f"({_fmt_num(e.get('window_span_s', 0))}s) at step "
                f"{e.get('step')}; component slope "
                f"{_mib(e.get('component_slope_bytes_per_sample', 0))}/sample"
            )
    else:
        lines.append("- no leak suspected (the sentinel never fired)")
    # OOM risk: measured device high-water vs the chip's HBM capacity. Only
    # when the run recorded both — generic CPU carries capacity 0 and gets
    # no made-up denominator.
    peak = max(
        (int(s.get("device_peak_bytes", 0) or 0) for s in samples), default=0
    )
    cap = max(
        (int(s.get("hbm_capacity_bytes", 0) or 0) for s in samples), default=0
    )
    if peak > 0 and cap > 0:
        frac = peak / cap
        risk = "HIGH" if frac >= 0.9 else "elevated" if frac >= 0.75 else "low"
        lines.append(
            f"- OOM risk **{risk}**: device peak {_mib(peak)} = "
            f"{frac:.1%} of {_mib(cap)} HBM capacity"
        )
    elif peak > 0:
        lines.append(
            f"- OOM risk not assessable: device peak {_mib(peak)} but no HBM "
            "capacity recorded (generic/CPU chip spec)"
        )
    else:
        lines.append(
            "- OOM risk not assessable: no device memory stats in the "
            "samples (backend degraded to host-only telemetry)"
        )
    lines.append("")

    # -------------------------------------------------------- peak timeline
    lines += [
        "## Peak timeline",
        "",
        "| step | rss | device in-use | device peak | py blocks |",
        "|---|---|---|---|---|",
    ]
    for s in _timeline_rows(samples, args.timeline_rows):
        lines.append(
            f"| {s.get('step', '—')} "
            f"| {_mib(s['rss_bytes']) if s.get('rss_bytes') else '—'} "
            f"| {_mib(s['device_bytes']) if s.get('device_bytes') else '—'} "
            f"| {_mib(s['device_peak_bytes']) if s.get('device_peak_bytes') else '—'} "
            f"| {s.get('py_alloc_blocks', '—')} |"
        )
    lines.append("")

    # ---------------------------------------------- component attribution
    lines += ["## Component attribution", ""]
    names: set[str] = set()
    for s in samples:
        names.update((s.get("components") or {}))
    if not names:
        lines.append("(no accounted components in the samples)")
    else:
        rows = []
        for name in names:
            series = [
                int((s.get("components") or {}).get(name, 0)) for s in samples
            ]
            rows.append((series[-1] - series[0], name, series[0], series[-1]))
        rows.sort(reverse=True)
        lines += [
            "| component | first | last | growth |",
            "|---|---|---|---|",
        ]
        for growth, name, first, last in rows:
            lines.append(
                f"| {name} | {_mib(first)} | {_mib(last)} | "
                f"{'+' if growth >= 0 else '−'}{_mib(abs(growth))} |"
            )
    lines.append("")

    # ------------------------------------------------ predict-vs-measured
    lines += ["## HBM predict vs measured", ""]
    drift = next(
        (s.get("hbm_drift") for s in reversed(samples) if s.get("hbm_drift")),
        None,
    )
    if not drift:
        lines.append(
            "(no drift ratios — no device memory stats or no predicted "
            "peaks recorded)"
        )
    else:
        lines += ["| program | measured peak / predicted |", "|---|---|"]
        for prog, ratio in sorted(drift.items()):
            lines.append(f"| {prog} | {_fmt_num(ratio)} |")
    lines.append("")

    # ------------------------------------------------------- flight records
    if dumps:
        lines += ["## Flight records", ""]
        for e in dumps:
            lines.append(f"- `{e.get('path')}`")
        lines.append("")
    return "\n".join(lines), rc


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("path", help="run dir (containing journal/ segments)")
    parser.add_argument(
        "--timeline-rows",
        type=int,
        default=24,
        help="max rows in the peak timeline (first/last always kept)",
    )
    parser.add_argument(
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    run_dir = Path(args.path)
    try:
        events = read_merged_journal(run_dir)
    except FileNotFoundError:
        events = []
    if not any(e.get("type") == "mem_sample" for e in events):
        print(
            f"[mem_doctor] no mem_sample rows in the journal under {run_dir} "
            "(run.memwatch off, or the run died before a log boundary?)",
            file=sys.stderr,
        )
        return 2

    report, rc = diagnose(events, args)
    write_report(report, args.out, tool="mem_doctor")
    return rc


if __name__ == "__main__":
    sys.exit(main())
