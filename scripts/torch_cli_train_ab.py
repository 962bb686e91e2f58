#!/usr/bin/env python3
"""The CLI's ViT-L/16 MAE training step on one NVIDIA GPU, in variants taken in turns.

    python3 scripts/torch_cli_train_ab.py [--pairs 2] [--steps 16] [--profile-steps 2]
        [--profile-variants shards,synthetic] [--out FILE.json]

Writes chip_smoke's toy shards (224 px) once, then runs chip_smoke's
driver configuration (``recipes/pretrain_vit_l16_in1k_800ep.yaml`` at
batch 128, 4 data workers) through ``cli.train.main`` in this process
with chip_smoke's ``run_driver``, ``--steps`` steps a run, in four
variants taken in rotation ``--pairs`` times: tar shards or synthetic
data, each with the step's non-finite guard (``run.sentinel``, which
reads the loss and gradient norm on the host: one synchronisation a
step) and without, and a fifth, phase 7's loop of chip_smoke
(``create_state`` + ``make_train_step`` on one repeated batch, no guard,
its step ms from CUDA events). Per CLI run it takes the step ms from the
CLI's StepTimer (steps 3 to the last), the host ms of the train-step
call and of the loader's ``__next__`` (means over the steps after the
4th; shards only) and the CLI's own host wait for a batch per step (its
one log window, the first batch included). It prints per variant the
median and range of each over its runs.

With ``--profile-steps N`` (N > 0) it then traces N step cycles under
``torch.profiler`` for each variant of ``--profile-variants``: one more
CLI run, from just before its 10th train-step call to just before its
(10 + N)-th (the batch wait, the prefetch's copy and the hooks
included), and N steps of phase 7's loop. For each it gives the window's
host ms a step, the device's kernel ms a step and idle share, the kernel
groups of ``scripts/torch_train_profile.py`` and the host operators with
the most self time.

Prints one JSON object as its last line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

VARIANTS = {
    "shards": [],
    "shards_noguard": ["run.sentinel=false"],
    "synthetic": ["run.synthetic_data=true"],
    "synthetic_noguard": ["run.synthetic_data=true", "run.sentinel=false"],
}
PROFILE_FROM = 10  # the train-step call the traced window starts before


def one_run(cs, fa, sets: list[str], out: Path, before_step=None) -> dict:
    """``cli.train.main`` once through chip_smoke's ``run_driver``."""
    rec = cs.run_driver(fa, ["--config", str(HERE / cs.RECIPE), "--set", *sets, f"run.output_dir={out}"],
                        before_step=before_step)
    summary = [r for r in cs._jsonl(out) if "perf/images_per_sec" in r][-1]
    shutil.rmtree(out, ignore_errors=True)
    loader = rec["loader_wait_s"][4:]
    return {
        "step_ms": cs.TRAIN_BATCH * 1e3 / summary["perf/images_per_sec"],
        "dispatch_ms": 1e3 * statistics.mean(rec["dispatch_s"][4:]),
        "loader_ms": 1e3 * statistics.mean(loader) if loader else 0.0,
        "cli_wait_ms": 1e3 * summary["perf/data_wait_s_per_step"],
    }


def trace_report(prof, window_ms: float, steps: int) -> dict:
    """Per step: the traced window's host ms, the kernels' device ms, the
    idle share, the kernel groups and the host operators by self time."""
    from torch.autograd import DeviceType
    from torch_train_profile import kernel_report

    k = kernel_report(prof, top=15)
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "window_ms_per_step": window_ms / steps,
        "kernel_ms_per_step": k["kernel_ms"] / steps,
        "idle_share": max(0.0, 1.0 - k["kernel_ms"] / window_ms),
        "launches_per_step": k["kernel_launches"] / steps,
        "groups_ms_per_step": {g: v["device_ms"] / steps for g, v in k["groups"].items()},
        "top_kernels": k["top"],
        "host_ops_ms_per_step": [{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3 / steps,
                                  "calls": e.count / steps} for e in host[:15]],
    }


def profile_cli(cs, fa, sets: list[str], out: Path, steps: int) -> dict:
    """One CLI run; N step cycles traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = {}

    def before_step(i: int):
        if i == PROFILE_FROM:
            torch.cuda.synchronize()
            box["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            box["prof"].__enter__()
            box["t0"] = time.perf_counter()
        elif i == PROFILE_FROM + steps:
            torch.cuda.synchronize()
            box["ms"] = (time.perf_counter() - box["t0"]) * 1e3
            box["prof"].__exit__(None, None, None)

    one_run(cs, fa, sets, out, before_step=before_step)
    return trace_report(box["prof"], box["ms"], steps)


def profile_loop(steps: int) -> dict:
    """Phase 7's loop (one repeated batch, no guard); N steps traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    enc, dec, opt = cs.vit_l16_mae()
    state = create_state((enc, dec, True), opt, device="cuda", init_seed=0, rng_seed=0,
                         global_batch_size=cs.TRAIN_BATCH)
    step = make_train_step(mode="pretrain")
    batch = next(synthetic_batches(cs.TRAIN_BATCH, enc.image_size, seed=0, distinct=1))
    for _ in range(PROFILE_FROM):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    del state
    torch.cuda.empty_cache()
    return trace_report(prof, ms, steps)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--profile-steps", type=int, default=0)
    p.add_argument("--profile-variants", default="shards", help="comma-separated names of VARIANTS to trace")
    p.add_argument("--out", default="")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this needs an NVIDIA GPU")
    if args.profile_steps and args.steps <= PROFILE_FROM + args.profile_steps:
        raise SystemExit(f"--steps must exceed {PROFILE_FROM} + --profile-steps")
    traced = [v for v in args.profile_variants.split(",") if v] if args.profile_steps else []
    unknown = set(traced) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown --profile-variants {sorted(unknown)}; choose from {list(VARIANTS)}")
    import chip_smoke as cs
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.ops import _build
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

    smi = cs.nvidia_smi_line()
    cs.build_kernels(_build)
    tmp = Path(tempfile.mkdtemp(prefix="cli_ab_"))
    profiles = {}
    try:
        urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
        epochs = args.steps * cs.TRAIN_BATCH / 1024
        sets = [s for s in cs.DRIVER_SETS if not s.startswith("run.epochs=")] + [
            f"run.epochs={epochs}", "run.sanity_eval=false",
            f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
        ]
        names = [*VARIANTS, "phase7_loop"]
        runs: dict[str, list[dict]] = {k: [] for k in names}
        for i in range(args.pairs):
            for name in names if i % 2 == 0 else reversed(names):
                if name == "phase7_loop":
                    r = {"step_ms": cs.phase_train(fa, smi)["step_ms"]}
                else:
                    r = one_run(cs, fa, sets + VARIANTS[name], tmp / f"{name}-{i}")
                runs[name].append(r)
                print(f"[cli_ab] {name} run {i}: " + ", ".join(f"{k} {v:.2f}" for k, v in r.items()), flush=True)
        for name in traced:
            profiles[f"cli_{name}"] = profile_cli(cs, fa, sets + VARIANTS[name], tmp / f"profile-{name}",
                                                  args.profile_steps)
        if traced:
            profiles["phase7_loop"] = profile_loop(args.profile_steps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {
        name: {k: {"median": statistics.median(r[k] for r in rs), "min": min(r[k] for r in rs),
                   "max": max(r[k] for r in rs)} for k in rs[0]}
        for name, rs in runs.items() if rs
    }
    for name, s in summary.items():
        print(f"[cli_ab] {name}: " + "; ".join(
            f"{k} median {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f})" for k, v in s.items()) + f" on {smi}")
    for name, r in profiles.items():
        print(f"[cli_ab] traced {name}: window {r['window_ms_per_step']:.2f} ms a step, kernels "
              f"{r['kernel_ms_per_step']:.2f} ms in {r['launches_per_step']:.0f} launches, idle share "
              f"{r['idle_share']:.3f} on {smi}")
        for g, ms in r["groups_ms_per_step"].items():
            print(f"    {ms:9.3f} ms  {g}")
        for op in r["host_ops_ms_per_step"][:8]:
            print(f"    host {op['self_ms']:9.3f} ms  x{op['calls']:<6.0f} {op['name']}")
    result = {"device": smi, "steps": args.steps, "pairs": args.pairs, "variants": summary, "runs": runs,
              "profiles": profiles}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
