"""Offline publish-artifact verification: walk the delta chain, prove it.

Counterpart of the JAX package's top-level ``tools/publish_doctor.py``,
the same report and exit codes over the port's ``serve/publisher.py``.
The swap watcher verifies one artifact at a time as it lands; this tool
audits the whole ``--swap-watch`` / ``run.publish_dir`` directory after
the fact — every ``publish-NNNNNN`` artifact's payload hash and leaf
digests, every delta chain resolved back to a full tree, every resolved
tree's fingerprint recomputed against its manifest. A broken link is
*named* (which artifact, which base, what mismatched)::

    python -m jumbo_mae_tpu_tpu_torch.tools.publish_doctor runs/push
    python -m jumbo_mae_tpu_tpu_torch.tools.publish_doctor runs/push --artifact publish-000003
    python -m jumbo_mae_tpu_tpu_torch.tools.publish_doctor runs/push --out publish.md

Quarantined artifacts (``.quarantine/``, entries the live watcher already
rejected) are reported but do not fail the audit: quarantine working as
designed is health, not damage.

Exit codes: 0 = every artifact verified and every chain resolved;
2 = no artifacts found, or at least one broken artifact or chain.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from jumbo_mae_tpu_tpu_torch.serve.publisher import (
    PublishIntegrityError,
    is_publish_artifact,
    load_manifest,
    resolve_chain,
)


def audit_artifact(path: Path) -> dict:
    """One artifact's verdict: resolve its full chain (verifying every
    link) and recompute the parity fingerprint."""
    row: dict = {"name": path.name, "ok": False}
    try:
        m = load_manifest(path)
        row.update(
            step=m.get("step"),
            quant=m.get("quant"),
            base=(m.get("base") or {}).get("name"),
            delta_fraction=m.get("delta_fraction"),
        )
        params, batch_stats, _ = resolve_chain(path)
        n = sum(1 for _ in _walk_leaves(params))
        if batch_stats is not None:
            n += sum(1 for _ in _walk_leaves(batch_stats))
        row.update(ok=True, leaves=n, verdict="verified")
    except PublishIntegrityError as e:
        row["verdict"] = f"BROKEN: {e}"
    return row


def _walk_leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _walk_leaves(v)
    elif node is not None:
        yield node


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("publish_dir", help="the swap-watch / publish directory")
    ap.add_argument(
        "--artifact",
        default="",
        help="audit one named artifact instead of the whole directory",
    )
    ap.add_argument("--out", default="", help="also write the report here")
    args = ap.parse_args(argv)

    root = Path(args.publish_dir)
    if args.artifact:
        names = [args.artifact]
    else:
        names = sorted(
            n
            for n in (os.listdir(root) if root.is_dir() else [])
            if not n.startswith(".") and is_publish_artifact(root / n)
        )
    if not names:
        print(f"publish_doctor: no publish artifacts under {root}")
        return 2

    rows = [audit_artifact(root / n) for n in names]
    qdir = root / ".quarantine"
    quarantined = sorted(p.name for p in qdir.iterdir()) if qdir.is_dir() else []

    lines = [f"# publish_doctor — {root}", ""]
    lines.append("| artifact | step | quant | base | delta | verdict |")
    lines.append("|---|---|---|---|---|---|")
    for r in rows:
        lines.append(
            f"| {r['name']} | {r.get('step', '?')} | {r.get('quant', '?')} "
            f"| {r.get('base') or 'full'} | {r.get('delta_fraction', '?')} "
            f"| {r['verdict']} |"
        )
    broken = [r for r in rows if not r["ok"]]
    lines.append("")
    if quarantined:
        lines.append(
            f"quarantined (rejected by the live watcher, as designed): "
            f"{', '.join(quarantined)}"
        )
    verdict = (
        f"BROKEN: {len(broken)}/{len(rows)} artifact(s) failed verification"
        if broken
        else f"OK: {len(rows)} artifact(s) verified, all chains resolve"
    )
    lines.append(f"verdict: {verdict}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        Path(args.out).write_text(report + "\n")
    return 2 if broken else 0


if __name__ == "__main__":
    sys.exit(main())
