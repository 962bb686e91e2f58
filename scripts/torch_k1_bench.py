#!/usr/bin/env python3
"""The flash-attention kernels of one checkout of the port, on one NVIDIA GPU.

    python3 scripts/torch_k1_bench.py [--root DIR] [--phases fwd,bwd] [--out FILE.json]
    python3 scripts/torch_k1_bench.py --base DIR [--root DIR] [--phases ...] [--pairs 10] [--out FILE.json]

Loads ``jumbo_mae_tpu_tpu_torch`` from ``--root`` (default: this checkout)
and everything else from this checkout's ``chip_smoke.py``, so an older
checkout is held to the same shapes, gates and clocks. It builds the
kernels there and runs, for the phases asked for (default both):

- ``fwd``, K1 (the forward):
  1. chip_smoke's phase 3: K1 against its plain version at every tile
     edge and Sq != Sk case, bf16 and f32, bf16 reruns bit-identical,
     strided views of a fused projection equal to contiguous copies;
  2. chip_smoke's phase 5a: K1 at the main path's four shapes, 448 px
     and the ViT-H/14 encoder (256, 67, 16, 80) with lse, device ms per
     call from CUDA-graph replay and from eager launches, its plain
     version, SDPA's forward, the bound, and the host µs per wrapper call;
  3. the host µs per call at the encoder shape split into the argument
     checks, the two output allocations and the C entry alone (tensor-map
     encodes and the launch);
- ``bwd``, K2 and K3 (the backward):
  1. chip_smoke's phase 4: K2 and K3 against the plain backward at every
     shape of ``BWD_SHAPES`` and K1's Sq != Sk cases, both dtypes, with
     and without an lse cotangent, K2's D against the plain D pass, reruns
     bit-identical, strided and broadcast views, inert padding;
  2. chip_smoke's phase 5b: K2 (computing D), K3, the whole backward and
     the standalone D pass at the MAE encoder and decoder shapes, the
     ring hop, the finetune batch and the ViT-H/14 encoder by graph
     replay, beside the plain backward, SDPA's backward and the bounds;
     FlashAttention forward + backward against SDPA's (with ``fwd``, also
     K1 + K2 + K3 against the einsum path);
  3. the blocks an SM holds of K2 and K3 at every head_dim (the occupancy
     query), where the checkout has it.

An older checkout whose K2 takes D from the plain D pass
(``attention_delta``) runs the same phases through that pass
(chip_smoke's ``folds_delta``): its backward is D + K2 + K3.

With ``--base DIR`` it runs itself on ``--base`` and on ``--root`` in
processes of their own, in the order base, new, new, base, until each
side has run ``--pairs`` times, and prints per side the median and
quartiles of every time it took (device ms per kernel and shape; host µs
per K1 wrapper call and of its C entry).

Exits non-zero on any disagreement. Prints one JSON object as its last
line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_parts(cs, fa, shape) -> dict:
    """Host µs per call of the wrapper's parts at ``shape`` with lse: the
    argument checks, the two output allocations, and the C entry alone
    with its arguments ready."""
    import torch

    q, k, v = cs.qkv(shape, torch.bfloat16, seed=7)
    b, sq, h, d = shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device="cuda")
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, b, h, sq, sq, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            torch.cuda.current_stream().cuda_stream)
    return dict(
        check_us=cs.host_us(lambda: fa.check_kernel_args(q, k, v), calls=2000),
        alloc_us=cs.host_us(lambda: (torch.empty_like(q),
                                     torch.empty((b * h, sq), dtype=torch.float32, device="cuda")), calls=2000),
        c_entry_us=cs.host_us(lambda: lib.jumbo_flash_fwd(*args), calls=2000),
    )


def run_one(root: Path, phases: set[str]) -> dict:
    sys.path.insert(0, str(root))
    import torch

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("[k1_bench] FAIL: no CUDA device")
    from jumbo_mae_tpu_tpu_torch.ops import _build
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

    smi = cs.nvidia_smi_line()
    cs.log(f"k1_bench: package from {root}; {smi}; torch {torch.__version__}; phases {sorted(phases)}")
    build_s = cs.build_kernels(_build, ["flash_fwd", "flash_bwd"] if "bwd" in phases else ["flash_fwd"])
    res = dict(root=str(root), device=smi, build_s=build_s, metrics={})
    metrics = res["metrics"]  # flat: name -> one number, what --base compares
    timings = {}
    if "fwd" in phases:
        errs = cs.phase_kernels(fa)
        timings = cs.phase_timings(fa)
        timings.update(cs.phase_timings(fa, shapes=((cs.H14_ENC_SHAPE, True),), f32=False))
        parts = host_parts(cs, fa, cs.ENC_SHAPE)
        cs.log("host µs per call at the encoder shape: " + ", ".join(f"{n} {t:.2f}" for n, t in parts.items()))
        res["max_abs_err_bf16_fwd"] = max(e for (name, *_), e in errs.items() if name == "bfloat16")
        res["timings"] = [dict(shape=list(shape), **row) for shape, row in timings.items()]
        res["host_parts"] = parts
        for shape, row in timings.items():
            metrics[f"K1 {shape} ms"] = row["ms"]
            metrics[f"K1 {shape} host_us"] = row["host_us"]
        metrics["K1 C entry host_us"] = parts["c_entry_us"]
    if "bwd" in phases:
        errs = cs.phase_bwd_kernels(fa)
        bwd = cs.phase_bwd_timings(fa, timings)
        bwd.update(cs.phase_bwd_timings(fa, timings, shapes=(cs.H14_ENC_SHAPE,), fb_shapes=(cs.H14_ENC_SHAPE,)))
        res["max_abs_err_bf16_bwd"] = max(e for (name, *_), e in errs.items() if name == "bfloat16")
        res["bwd_timings"] = [dict(kernel=key, shape=list(shape), **row) for (key, shape), row in bwd.items()]
        for (key, shape), row in bwd.items():
            if key in ("K2", "K3", "D", "backward", "FlashAttention"):
                metrics[f"{key} {shape} ms"] = row["ms"]
            if key == "K2":
                metrics[f"sdpa backward {shape} ms"] = row["library_ms"]
            if key == "FlashAttention":
                metrics[f"sdpa forward + backward {shape} ms"] = row["library_ms"]
        if hasattr(fa, "blocks_per_sm"):
            for kern in ("K2", "K3"):
                for d in fa.HEAD_DIMS:
                    metrics[f"{kern} head_dim {d} blocks per SM"] = fa.blocks_per_sm(kern, d)
    return res


def quartiles(xs: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(q1=q1, median=med, q3=q3)


def run_ab(base: Path, new: Path, pairs: int, phases: set[str]) -> dict:
    order = []
    while len(order) < 2 * pairs:
        order += ["base", "new", "new", "base"]
    order = order[: 2 * pairs]
    runs = {"base": [], "new": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(order):
            out = Path(tmp) / f"{i}.json"
            root = base if side == "base" else new
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", str(root),
                                   "--phases", ",".join(sorted(phases)), "--out", str(out)],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"[k1_bench] FAIL: run {i} ({side}) exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            rep = json.loads(out.read_text())
            runs[side].append(rep)
            print(f"[k1_bench] run {i:2d} {side:4s}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in rep["metrics"].items()), flush=True)
    summary = {}
    for side, reps in runs.items():
        summary[side] = {key: quartiles([r["metrics"][key] for r in reps]) for key in reps[0]["metrics"]}
        for key, q in summary[side].items():
            print(f"[k1_bench] {side:4s} {key}: median {q['median']:.4f} (quartiles {q['q1']:.4f}, "
                  f"{q['q3']:.4f})", flush=True)
    return dict(base=str(base), new=str(new), order=order, summary=summary, runs=runs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--base", type=Path, default=None, help="A/B against this checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--phases", default="fwd,bwd", help="comma-separated: fwd (K1), bwd (K2, K3)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases or not phases <= {"fwd", "bwd"}:
        ap.error(f"--phases takes fwd and/or bwd, got {args.phases!r}")
    if args.base is not None:
        res = run_ab(args.base.resolve(), args.root.resolve(), args.pairs, phases)
    else:
        res = run_one(args.root.resolve(), phases)
    text = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text if args.base is None else json.dumps(res["summary"]))


if __name__ == "__main__":
    main()
