"""Offline batch-job audit: job dir (journal + parts + manifest) → report.

Counterpart of the JAX package's top-level ``tools/batch_doctor.py``,
the same report and exit codes over the port's ``batch/partfile.py`` and
``obs/journal.py`` (the two packages write the same job directories, so
either doctor reads either's). It answers "did the job produce exactly
what it claims, and what did it survive along the way". Input is a
:class:`~jumbo_mae_tpu_tpu_torch.batch.BatchJobRunner` output directory::

    python -m jumbo_mae_tpu_tpu_torch.tools.batch_doctor runs/batchjob
    python -m jumbo_mae_tpu_tpu_torch.tools.batch_doctor runs/batchjob --out batch-report.md

The report, in order:

- **Verdict** — complete & reconciled, or the specific failures.
- **Progress** — shards total/done/quarantined, samples written, resumes
  observed (``job_start`` resumed_shards + ``job_cursor`` trail).
- **Lease timeline** — every ``job_lease`` grant in order; steals are
  flagged and **name the worker whose lease was stolen** (the dead or
  stalled holder) — the forensic trail for "who crashed and who rescued
  the shard".
- **Retry / quarantine attribution** — shards that finished
  ``status="quarantined"`` (the shard store gave up mid-pass) with their
  durable sample counts.
- **Reconciliation** — the manifest's word against the bytes on disk:
  every manifest entry's part must exist, match its recorded sha256, and
  contain exactly the recorded number of well-framed records; parts on
  disk that the manifest doesn't claim are orphans.

Exit codes: 0 = manifest present and reconciles 100%; 2 = no job dir /
no manifest (job incomplete or never ran) or any reconciliation failure
(sha mismatch, bad frame count, missing part, orphan part).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.batch.partfile import file_sha256, read_manifest, scan_part
from jumbo_mae_tpu_tpu_torch.obs.doctor_common import fmt_num, write_report
from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal


def _events(job_dir: Path) -> list[dict]:
    try:
        return read_journal(job_dir / "journal")
    except FileNotFoundError:
        return []


def reconcile(job_dir: Path, manifest: dict) -> tuple[list[str], list[str]]:
    """(table rows, failures) of manifest-vs-disk — the exactly-once
    audit. Every failure string is a reason for exit 2."""
    rows: list[str] = []
    failures: list[str] = []
    parts_dir = job_dir / "parts"
    claimed: set[str] = set()
    for entry in manifest.get("shards", []):
        part = parts_dir / entry["part"]
        claimed.add(entry["part"])
        if not part.exists():
            rows.append(f"| `{entry['part']}` | missing | - | - | **FAIL** |")
            failures.append(f"part {entry['part']} missing from disk")
            continue
        n, good = scan_part(part)
        sha = file_sha256(part)
        ok_n = n == entry["samples"] and good == part.stat().st_size
        ok_sha = sha == entry["sha256"]
        status = "ok" if (ok_n and ok_sha) else "**FAIL**"
        rows.append(
            f"| `{entry['part']}` | {n}/{entry['samples']} "
            f"| {'match' if ok_sha else 'MISMATCH'} "
            f"| {fmt_num(part.stat().st_size)} B | {status} |"
        )
        if not ok_n:
            failures.append(
                f"part {entry['part']} holds {n} well-framed records "
                f"({good} good bytes of {part.stat().st_size}), manifest "
                f"says {entry['samples']}"
            )
        if not ok_sha:
            failures.append(f"part {entry['part']} sha256 mismatch")
    if parts_dir.is_dir():
        for p in sorted(parts_dir.glob("*.part")):
            if p.name not in claimed:
                rows.append(f"| `{p.name}` | orphan | - | - | **FAIL** |")
                failures.append(
                    f"orphan part {p.name} on disk but not in the manifest"
                )
    return rows, failures


def diagnose(job_dir: Path, manifest: dict, events: list[dict]) -> tuple[str, list[str]]:
    lines: list[str] = ["# Batch doctor report", ""]
    failures: list[str] = []

    # ------------------------------------------------------------ progress
    starts = [e for e in events if e.get("type") == "job_start"]
    completes = [e for e in events if e.get("type") == "job_complete"]
    cursors = [e for e in events if e.get("type") == "job_cursor"]
    shard_done = [e for e in events if e.get("type") == "job_shard_done"]
    quarantined = [e for e in shard_done if e.get("status") == "quarantined"]
    lines += ["## Progress", ""]
    lines.append(
        f"- manifest: {len(manifest.get('shards', []))} shard(s), "
        f"{fmt_num(manifest.get('total_samples', 0))} samples"
    )
    lines.append(
        f"- journal: {len(starts)} run(s) of this job "
        f"({max(0, len(starts) - 1)} resume(s)), "
        f"{len(shard_done)} shard completion(s), "
        f"{len(cursors)} progress cursor(s)"
    )
    resumed = sum(int(e.get("resumed_shards") or 0) for e in starts)
    if resumed:
        lines.append(
            f"- {resumed} shard(s) were already durable at (re)start "
            "and skipped recompute entirely"
        )
    if completes:
        c = completes[-1]
        lines.append(
            f"- completed with {fmt_num(c.get('total_samples', 0))} samples, "
            f"{int(c.get('lease_steals') or 0)} lease steal(s), "
            f"{int(c.get('quarantined') or 0)} quarantined shard(s)"
        )
    lines.append("")

    # ------------------------------------------------------ lease timeline
    leases = [e for e in events if e.get("type") == "job_lease"]
    if leases:
        lines += [
            "## Lease timeline",
            "",
            "| lease | shard | worker | note |",
            "|---|---|---|---|",
        ]
        for e in leases:
            shard = str(e.get("shard", "?")).rsplit("/", 1)[-1]
            note = (
                f"**stolen from `{e['stolen_from']}`** (lease expired — "
                "holder dead or stalled)"
                if e.get("stolen_from")
                else "claim"
            )
            lines.append(
                f"| {e.get('lease')} | `{shard}` | {e.get('worker')} "
                f"| {note} |"
            )
        lines.append("")

    # ------------------------------------- retry / quarantine attribution
    if quarantined:
        lines += ["## Quarantined shards", ""]
        for e in quarantined:
            lines.append(
                f"- `{e.get('shard')}`: store gave up mid-pass after "
                f"retries; {fmt_num(e.get('samples', 0))} sample(s) durable "
                "in its kept `.partial` (excluded from the manifest; a "
                "healed store resumes it next run)"
            )
        lines.append("")

    # ------------------------------------------------------ reconciliation
    lines += [
        "## Reconciliation (manifest vs disk)",
        "",
        "| part | records | sha256 | bytes | status |",
        "|---|---|---|---|---|",
    ]
    rows, failures = reconcile(job_dir, manifest)
    lines += rows or ["| - | - | - | - | - |"]
    lines.append("")

    verdict = (
        ["complete: manifest reconciles 100% against the bytes on disk"]
        if not failures
        else failures
    )
    steals = sum(1 for e in leases if e.get("stolen_from"))
    if steals and not failures:
        verdict.append(
            f"{steals} lease steal(s) survived without duplicating or "
            "dropping a sample"
        )
    lines[2:2] = ["## Verdict", ""] + [f"- {v}" for v in verdict] + [""]
    return "\n".join(lines), failures


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("path", help="batch job output dir (holds manifest.json)")
    parser.add_argument(
        "--out", default=None, help="write the markdown here (default stdout)"
    )
    args = parser.parse_args(argv)

    job_dir = Path(args.path)
    manifest = read_manifest(job_dir / "manifest.json")
    if manifest is None:
        print(
            f"[batch_doctor] no readable manifest under {job_dir} — job "
            "incomplete (resumable: re-run it) or wrong directory",
            file=sys.stderr,
        )
        return 2
    report, failures = diagnose(job_dir, manifest, _events(job_dir))
    rc = write_report(report, args.out, tool="batch_doctor")
    if failures:
        for f in failures:
            print(f"[batch_doctor] FAIL: {f}", file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
