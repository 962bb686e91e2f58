#!/usr/bin/env python3
"""Where the serving time goes: the port's ViT-B/16 engine on one GPU.

    python3 scripts/torch_serve_profile.py [--out runs/torch_serve_profile.json]

Builds the ViT-B/16 classifier from recipes/finetune_vit_b16.yaml (bf16
compute, random weights from its ``run.init_seed``) in ``InferenceEngine`` and
measures, on the card:

- the device forward time of every bucket of the ladder (CUDA events);
- the engine's host-clock time per request at each bucket (upload,
  normalize, forward, fetch), hence images/s;
- a ``torch.profiler`` trace of one forward at buckets 1 and 64: device
  time by kernel, the flash-attention kernel's share, and the device's
  idle share of the forward.

Prints a summary and writes the numbers as JSON to ``--out``. Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_forward(engine, batch, bucket_report: dict) -> dict:
    """torch.profiler over one forward: device time by kernel. Only kernel
    rows are summed (an op row's device time repeats its kernels'), and
    the idle share is against the forward's CUDA-event time, since the
    profiler itself slows the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images

    with torch.inference_mode():
        xn = normalize_images(torch.from_numpy(batch).cuda(), dtype=torch.bfloat16)
        engine.model("logits")(xn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.model("logits")(xn)
            torch.cuda.synchronize()

    def dev_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=dev_us, reverse=True,
    )
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    flash_ms = sum(dev_us(e) for e in kernels if "flash_fwd" in e.key) / 1e3
    fwd_ms = bucket_report["device_forward_ms"]
    return {
        "kernel_ms": total_ms,
        "forward_ms": fwd_ms,
        "idle_share": max(0.0, 1.0 - total_ms / fwd_ms),
        "flash_ms": flash_ms,
        "flash_share": flash_ms / fwd_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [
            {"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "calls": e.count}
            for e in kernels[:15]
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(REPO / "runs" / "torch_serve_profile.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: no CUDA device")
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, pow2_rungs
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    engine = InferenceEngine(load_config(REPO / "recipes" / "finetune_vit_b16.yaml"), max_batch=64, device="cuda")
    images = np.random.default_rng(0).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    report = {"device": smi, "torch": torch.__version__, "buckets": {}}

    for bucket in pow2_rungs(64):
        batch = images[:bucket]
        with torch.inference_mode():
            xn = normalize_images(torch.from_numpy(batch).cuda(), dtype=torch.bfloat16)
            fwd = cuda_ms(lambda: engine.model("logits")(xn))
        engine.logits(batch)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.logits(batch)
        req_ms = (time.perf_counter() - t0) / reps * 1e3
        report["buckets"][bucket] = {
            "device_forward_ms": fwd,
            "request_ms": req_ms,
            "images_per_s": bucket / req_ms * 1e3,
        }
        print(f"bucket {bucket:3d}: device forward {fwd:8.3f} ms, request {req_ms:8.3f} ms, "
              f"{bucket / req_ms * 1e3:9.1f} images/s")

    for bucket in (1, 64):
        report[f"profile_bucket{bucket}"] = profile_forward(engine, images[:bucket], report["buckets"][bucket])
    print(f"device idle share of the forward: bucket 1 {report['profile_bucket1']['idle_share']:.3f}, "
          f"bucket 64 {report['profile_bucket64']['idle_share']:.3f}")
    for row in report["profile_bucket64"]["top"]:
        print(f"  {row['device_ms']:8.3f} ms  x{row['calls']:<4d} {row['name']}")
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
