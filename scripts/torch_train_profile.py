#!/usr/bin/env python3
"""Where the training time goes: the port's ViT-L/16 (or ViT-H/14) MAE step on one GPU.

    python3 scripts/torch_train_profile.py [--batch 128] [--seq 4] [--out runs/torch_train_profile.json]
    python3 scripts/torch_train_profile.py --model h14 --batch 256 --policies dots,none

Builds the pretraining step as chip_smoke.py does
(recipes/pretrain_vit_l16_in1k_800ep.yaml's model and optimizer, bf16
compute, grad_ckpt, random weights from a seed) through ``create_state``
and ``make_train_step``, and measures on the card:

- the step time from CUDA events over back-to-back steps, and the host's
  time to enqueue one step (a host that enqueues no faster than the card
  runs is the bottleneck);
- the split of one step into forward, backward and optimizer update
  (CUDA events around each, the same calls the train step makes);
- a ``torch.profiler`` trace of one step: device time by kernel, grouped
  (matrix products, the flash kernels K1/K2/K3, casts and copies,
  elementwise, reductions and norms, the optimizer's foreach kernels,
  the patch convolution), each flash kernel by name (which instantiation
  ran), and the device's idle share of the step.

``--seq N`` (N > 1) profiles the sequence-parallel step of chip_smoke.py
instead: the encoder on the flash ring and the decoder on the einsum ring
of a one-process seq = N mesh, the whole step under ``set_mesh``.

``--model h14`` profiles chip_smoke.py's phase-25 step instead
(recipes/pretrain_vit_h14_in1k_fsdp.yaml's model and optimizer).
``--policies dots,none,none,dots`` measures each remat policy in turn on
one state (the encoder's ``remat_policy`` switched); the report then
holds the numbers above for each, in that order, under ``policies``.

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

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("flash K1 (forward)", ("flash_fwd",)),
    ("flash K2 (dq)", ("flash_bwd_dq",)),
    ("flash K3 (dk, dv)", ("flash_bwd_dkv",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("matrix products", ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90_", "ampere_", "s16816", "wgmma")),
    ("convolution", ("conv", "cudnn", "implicit")),
    ("norms and reductions", ("layer_norm", "LayerNorm", "reduce", "softmax", "norm")),
    ("casts and copies", ("copy", "Copy", "cast", "convert")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "gelu", "Gelu", "where", "index", "gather", "scatter")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def dev_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def kernel_report(prof, top: int = 25) -> dict:
    """A finished ``torch.profiler`` trace's device time: the total, the
    launches, the groups of :data:`GROUPS`, the ``top`` kernels and every
    flash kernel by name."""
    from torch.autograd import DeviceType

    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA), key=dev_us, reverse=True)
    groups: dict[str, list] = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key), [0.0, 0])
        g[0] += dev_us(e) / 1e3
        g[1] += e.count
    return {
        "kernel_ms": sum(dev_us(e) for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "groups": {k: {"device_ms": v[0], "calls": v[1]} for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": e.key[:100], "device_ms": dev_us(e) / 1e3, "calls": e.count} for e in kernels[:top]],
        # every flash kernel by name: which instantiation the step ran
        "flash": [{"name": e.key, "device_ms": dev_us(e) / 1e3, "calls": e.count}
                  for e in kernels if "flash_" in e.key],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5, help="timed steps")
    ap.add_argument("--seq", type=int, default=1, help="ring attention over a one-process seq axis of this size")
    ap.add_argument("--model", choices=("l16", "h14"), default="l16")
    ap.add_argument("--policies", default="", help="comma-separated remat policies, each measured in turn")
    ap.add_argument("--out", default=str(REPO / "runs" / "torch_train_profile.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device")
    from chip_smoke import vit_h14_mae, vit_l16_mae
    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh, set_mesh
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    enc, dec, opt = vit_h14_mae() if args.model == "h14" else vit_l16_mae()
    mesh = None
    if args.seq > 1:
        enc = enc.replace(attn_impl="ring", ring_inner="flash")
        dec = dec.replace(attn_impl="ring", ring_inner="einsum")
        mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=args.seq), device="cuda", one_process_seq=True)
    with set_mesh(mesh):
        state = create_state((enc, dec, True), opt, device="cuda", global_batch_size=args.batch)
        step = make_train_step()
        batch = next(synthetic_batches(args.batch, enc.image_size, distinct=1))
        if not args.policies:
            report = measure(args, state, step, batch, enc, dec, smi)
        else:
            report = {"device": smi, "torch": torch.__version__, "batch": args.batch, "model": args.model,
                      "policies": []}
            for policy in args.policies.split(","):
                print(f"remat policy {policy}:")
                cfg = enc.replace(remat_policy=policy)
                state.model.encoder.cfg = cfg
                report["policies"].append(measure(args, state, step, batch, cfg, dec, smi))
    print(smi)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))


def measure(args, state, step, batch, enc, dec, smi: str) -> dict:
    """Time, split and trace ``step`` on ``state`` and ``batch`` (the
    caller's mesh stays set); prints the summary and returns the report."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jumbo_mae_tpu_tpu_torch.obs.mfu import mfu, pretrain_flops_per_image

    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    start, end = events()
    start.record()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

    # host enqueue time of one step, the card idle before it
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    # forward / backward / optimizer split, the calls the step makes
    model, params = state.model.train(), list(state.model.parameters())
    images = torch.from_numpy(batch["images"]).cuda()
    marks = [events() for _ in range(3)]
    for p in params:
        p.grad = None
    marks[0][0].record()
    out = model(images, generators=state.step_generators())
    marks[0][1].record()
    marks[1][0].record()
    out["loss"].backward()
    marks[1][1].record()
    marks[2][0].record()
    state.tx.update(state.opt_state, params, [p.grad for p in params])
    marks[2][1].record()
    torch.cuda.synchronize()
    split = {k: a.elapsed_time(b) for k, (a, b) in zip(("forward", "backward", "optimizer"), marks)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels = kernel_report(prof)
    kernel_ms = kernels["kernel_ms"]
    ips = args.batch * 1e3 / step_ms
    report = {
        "device": smi,
        "torch": torch.__version__,
        "batch": args.batch,
        "model": args.model,
        "remat_policy": enc.remat_policy,
        "seq": args.seq,
        "step_ms": step_ms,
        "images_per_s": ips,
        "mfu": mfu(ips, pretrain_flops_per_image(enc, dec)),
        "host_enqueue_ms": enqueue_ms,
        "split_ms": split,
        "idle_share": max(0.0, 1.0 - kernel_ms / step_ms),
        **kernels,
    }
    print(f"step {step_ms:.2f} ms ({ips:.1f} images/s, MFU {100 * report['mfu']:.2f}%), host enqueue "
          f"{enqueue_ms:.2f} ms, kernels {kernel_ms:.2f} ms in {report['kernel_launches']} launches, idle share "
          f"{report['idle_share']:.3f}")
    print("split: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()))
    for k, v in report["groups"].items():
        print(f"  {v['device_ms']:9.3f} ms  x{v['calls']:<6d} {k}")
    for row in report["top"]:
        print(f"  {row['device_ms']:9.3f} ms  x{row['calls']:<5d} {row['name']}")
    print("flash kernels:")
    for row in report["flash"]:
        print(f"  {row['device_ms']:9.3f} ms  x{row['calls']:<5d} {row['name']}")
    return report


if __name__ == "__main__":
    main()
