#!/usr/bin/env python3
"""Serving A/B of two checkouts of the port on one GPU.

    python3 scripts/torch_serve_ab.py BASE_DIR NEW_DIR [--pairs 10] [--out runs/serve_ab.json]

Runs each checkout's own ``scripts/torch_serve_profile.py`` in a process
of its own, in the order base, new, new, base, repeated until each side
has run ``--pairs`` times, so that a drift of the card or the host falls
on both sides alike. Prints, per bucket, the median device forward time
and request time of each side and new/base, and the median idle share of
the bucket-1 and bucket-64 forwards; writes every run's report and the
medians as JSON to ``--out``. Needs a CUDA device (the profile script
exits non-zero without one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def run_profile(checkout: Path, out: Path) -> dict:
    script = checkout / "scripts" / "torch_serve_profile.py"
    proc = subprocess.run([sys.executable, str(script), "--out", str(out)], cwd=checkout,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"torch_serve_ab: {script} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text())


def medians(reports: list[dict]) -> dict:
    buckets = reports[0]["buckets"]
    out = {
        b: {key: statistics.median(r["buckets"][b][key] for r in reports)
            for key in ("device_forward_ms", "request_ms")}
        for b in buckets
    }
    for b in ("1", "64"):
        out[f"idle_share_bucket{b}"] = statistics.median(r[f"profile_bucket{b}"]["idle_share"] for r in reports)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("base", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", type=Path, default=Path("runs") / "serve_ab.json")
    args = ap.parse_args()

    order = []
    while len(order) < 2 * args.pairs:
        order += ["base", "new", "new", "base"]
    runs = {"base": [], "new": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(order[: 2 * args.pairs]):
            rep = run_profile(getattr(args, side).resolve(), Path(tmp) / f"{i}.json")
            runs[side].append(rep)
            b64 = rep["buckets"]["64"]
            print(f"run {i:2d} {side:4s}: bucket 64 device forward {b64['device_forward_ms']:.3f} ms, "
                  f"request {b64['request_ms']:.3f} ms", flush=True)
    med = {side: medians(reps) for side, reps in runs.items()}
    print(f"medians over {args.pairs} runs of each side ({runs['new'][0]['device']}):")
    for b in med["base"]:
        if b.startswith("idle"):
            print(f"  {b}: base {med['base'][b]:.3f}, new {med['new'][b]:.3f}")
            continue
        base, new = med["base"][b], med["new"][b]
        print(f"  bucket {b:>2s}: device forward base {base['device_forward_ms']:.3f} ms, new "
              f"{new['device_forward_ms']:.3f} ms ({new['device_forward_ms'] / base['device_forward_ms']:.4f}x); "
              f"request base {base['request_ms']:.3f} ms, new {new['request_ms']:.3f} ms "
              f"({new['request_ms'] / base['request_ms']:.4f}x)")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"order": order[: 2 * args.pairs], "medians": med, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
