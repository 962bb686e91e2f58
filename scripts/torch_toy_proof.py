#!/usr/bin/env python3
"""The spread of chip_smoke's toy proof (phase 18) over runs and step counts, on one NVIDIA GPU.

    python3 scripts/torch_toy_proof.py [--out FILE.json]

Runs chip_smoke's ``toy_probe_proof`` (toy MAE pretraining, then the GAP
linear probe from that save and from a random init, through
``cli.train.main``) at each pair of ``STEPS`` (pretraining steps, probe
steps; the first is phase 18's) and each entry of ``SEEDS``. Seed 0, the
phase's, comes three times: a repeat shows whether a run repeats bit for
bit. ``JOBS`` runs go at once, each in a process of its own with
PyTorch's defaults; their seconds are those of runs sharing the host,
not phase 18's. Per pair it prints the pretrained and random probes'
``val/acc1`` of every run and how many runs passed phase 18's three
gates. Prints one JSON object as its last line and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
STEPS = ((600, 400), (400, 300), (300, 200))
SEEDS = (0, 0, 0, 1, 2, 3)
JOBS = 6


def one_run(pt_steps: int, pr_steps: int, seed: int) -> dict:
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // JOBS))  # the jobs share the host's cores
    tmp = Path(tempfile.mkdtemp(prefix="toy_proof_"))
    try:
        res = cs.toy_probe_proof(tmp, pt_steps=pt_steps, pr_steps=pr_steps, seed=seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, r = res["acc_pt"], res["acc_rand"]
    return dict(res, pt_steps=pt_steps, pr_steps=pr_steps, seed=seed,
                gates=bool(a > r + 0.1 and a > 1.5 * r and a > 0.25))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    runs = [(pt, pr, seed) for pt, pr in STEPS for seed in SEEDS]
    with ProcessPoolExecutor(JOBS, mp_context=mp.get_context("spawn")) as pool:
        results = list(pool.map(one_run, *zip(*runs)))
    summary = []
    for pt, pr in STEPS:
        rs = [r for r in results if (r["pt_steps"], r["pr_steps"]) == (pt, pr)]
        row = dict(pt_steps=pt, pr_steps=pr, seeds=[r["seed"] for r in rs], acc_pt=[r["acc_pt"] for r in rs],
                   acc_rand=[r["acc_rand"] for r in rs], pt_val_loss=[r["pt_val_loss"] for r in rs],
                   passed=sum(r["gates"] for r in rs), runs=len(rs))
        summary.append(row)
        print(f"[toy_proof] {pt} pretraining + {pr} probe steps, seeds {row['seeds']}: pretrained {row['acc_pt']}, "
              f"random {row['acc_rand']}; {row['passed']} of {row['runs']} runs pass the gates")
    out = json.dumps({"pairs": summary, "runs": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
