#!/usr/bin/env python3
"""Host memory around checkpoint saves of a ViT-L/16 MAE train state.

    python3 scripts/torch_ckpt_rss.py [--saves 3] [--root DIR] [--out rss.json]

Builds the state of ``recipes/pretrain_vit_l16_in1k_800ep.yaml`` (random
weights, AdamW with its bf16 first moment) on the card in a fresh
process, then saves it ``--saves`` times through
``train.checkpoint.Checkpointer`` into a temporary directory. Around each
save it reads the process's resident set (``/proc/self/status``): before,
after the blocking host copy, after ``wait()`` joined the writer thread.
After the writes it counts how many of the last save's host tensors are
still alive (weak references, before any ``gc.collect()``; a checkpointer
that keeps its host copy from save to save keeps them all, and reports
their bytes as ``host_copy_gb``), then the
resident set after ``gc.collect()`` and after glibc's ``malloc_trim(0)``.
A tensor still alive is traced to the types that refer to it. The
numbers tell whether the process keeps a save's host copy after its
write or merely keeps the freed pages. ``--root`` measures the package of
another checkout. Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import weakref
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
RECIPE = "recipes/pretrain_vit_l16_in1k_800ep.yaml"
GB = 2**30


def rss_gb() -> float:
    with open("/proc/self/status", "rb") as f:
        for line in f:
            if line.startswith(b"VmRSS:"):
                return int(line.split()[1]) * 1024 / GB
    raise RuntimeError("no VmRSS in /proc/self/status")


def referrer_types(obj, depth: int = 2) -> list:
    """The types of what refers to ``obj``, ``depth`` levels up (frames of
    this script left out)."""
    out = []
    for r in gc.get_referrers(obj):
        if r is obj or type(r).__name__ == "frame" or isinstance(r, list) and len(r) > 1000:
            continue
        entry = {"type": type(r).__name__}
        if depth > 1:
            entry["by"] = referrer_types(r, depth - 1)[:6]
        out.append(entry)
    return out[:6]


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--saves", type=int, default=3)
    p.add_argument("--root", default=str(HERE), help="the checkout whose package is measured")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[ckpt_rss] FAIL: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.train import checkpoint as ck
    from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    cfg = load_config(HERE / RECIPE, ["run.use_wandb=false"])
    model, enc, _ = build_model(cfg, device="cuda")
    state = create_state(model, make_optimizer(cfg.optim, 128, num_layers=enc.layers), device="cuda")
    torch.cuda.synchronize()
    refs: list = []
    copy = ck.host_state

    def watched(st, *staging):
        payload = copy(st, *staging)
        refs.clear()
        refs.extend(weakref.ref(t) for t in payload["model"].values())
        refs.extend(weakref.ref(t) for ts in payload["opt"].values() if isinstance(ts, list) for t in ts)
        return payload

    ck.host_state = watched
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_rss_"))
    res = {"torch": torch.__version__, "glibc": os.confstr("CS_GNU_LIBC_VERSION"), "root": str(args.root),
           "rss_start_gb": rss_gb(), "saves": []}
    try:
        ckpt = ck.Checkpointer(ck.CheckpointConfig(str(tmp / "ckpt")))
        for i in range(1, args.saves + 1):
            r0 = rss_gb()
            t0 = time.perf_counter()
            ckpt.save(i * 2, state)
            r1, t1 = rss_gb(), time.perf_counter()
            ckpt.wait()
            r2, t2 = rss_gb(), time.perf_counter()
            alive = [r() for r in refs]
            n_alive = sum(t is not None for t in alive)
            row = {"step": i * 2, "rss_before_gb": r0, "rss_after_copy_gb": r1, "rss_after_wait_gb": r2,
                   "copy_s": t1 - t0, "write_s": t2 - t1, "bytes": ckpt.last_save_bytes,
                   "alive_after_wait": n_alive, "tensors": len(refs),
                   # the staging the checkpointer keeps (0 where it keeps none)
                   "host_copy_gb": getattr(ckpt, "host_copy_bytes", lambda: 0)() / GB}
            if n_alive:
                row["held_by"] = referrer_types(next(t for t in alive if t is not None))
            del alive
            res["saves"].append(row)
            print(json.dumps(row), flush=True)
        gc.collect()
        res["alive_after_gc"] = sum(r() is not None for r in refs)
        res["rss_after_gc_gb"] = rss_gb()
        ctypes.CDLL("libc.so.6").malloc_trim(0)
        res["rss_after_malloc_trim_gb"] = rss_gb()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
