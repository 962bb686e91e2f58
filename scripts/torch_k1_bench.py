#!/usr/bin/env python3
"""K1 (the flash-attention forward) of one checkout of the port, on one NVIDIA GPU.

    python3 scripts/torch_k1_bench.py [--root DIR] [--out FILE.json]
    python3 scripts/torch_k1_bench.py --base DIR [--root DIR] [--pairs 10] [--out FILE.json]

Loads ``jumbo_mae_tpu_tpu_torch`` from ``--root`` (default: this checkout)
and everything else from this checkout's ``chip_smoke.py``, so an older
checkout is held to the same shapes, gates and clocks. It builds the
kernels there and runs:

1. chip_smoke's phase 3: K1 against its plain version at every tile edge
   and Sq != Sk case, bf16 and f32, bf16 reruns bit-identical, strided
   views of a fused projection equal to contiguous copies;
2. chip_smoke's phase 5a: K1 at the main path's four shapes and 448 px,
   device ms per call from CUDA-graph replay and from eager launches,
   its plain version, SDPA's forward, the bound, and the host µs per
   wrapper call;
3. the host µs per call at the encoder shape split into the argument
   checks, the two output allocations and the C entry alone (tensor-map
   encodes and the launch).

With ``--base DIR`` it runs itself on ``--base`` and on ``--root`` in
processes of their own, in the order base, new, new, base, until each
side has run ``--pairs`` times, and prints per side the median and
quartiles of the host µs per call at each main-path shape and of the C
entry's, and the median device ms.

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
import time
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


def run_one(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("[k1_bench] FAIL: no CUDA device")
    from jumbo_mae_tpu_tpu_torch.ops import _build
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

    smi = cs.nvidia_smi_line()
    cs.log(f"k1_bench: package from {root}; {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build(["flash_fwd"])
    build_s = time.perf_counter() - t0
    errs = cs.phase_kernels(fa)
    timings = cs.phase_timings(fa)
    parts = host_parts(cs, fa, cs.ENC_SHAPE)
    cs.log("host µs per call at the encoder shape: " + ", ".join(f"{n} {t:.2f}" for n, t in parts.items()))
    return dict(
        root=str(root), device=smi, build_s=build_s,
        max_abs_err_bf16=max(e for (name, *_), e in errs.items() if name == "bfloat16"),
        timings=[dict(shape=list(shape), **row) for shape, row in timings.items()],
        host_parts=parts,
    )


def quartiles(xs: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(q1=q1, median=med, q3=q3)


def run_ab(base: Path, new: Path, pairs: int) -> dict:
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
                                   "--out", str(out)], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"[k1_bench] FAIL: run {i} ({side}) exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            rep = json.loads(out.read_text())
            runs[side].append(rep)
            print(f"[k1_bench] run {i:2d} {side:4s}: host us per call "
                  + ", ".join(f"{t['host_us']:.2f}" for t in rep["timings"])
                  + f"; C entry {rep['host_parts']['c_entry_us']:.2f}", flush=True)
    summary = {}
    for side, reps in runs.items():
        rows = {}
        for j, row in enumerate(reps[0]["timings"]):
            rows[str(tuple(row["shape"]))] = dict(
                host_us=quartiles([r["timings"][j]["host_us"] for r in reps]),
                ms_median=statistics.median(r["timings"][j]["ms"] for r in reps),
            )
        rows["c_entry_us"] = quartiles([r["host_parts"]["c_entry_us"] for r in reps])
        summary[side] = rows
        for key, row in rows.items():
            h = row if key == "c_entry_us" else row["host_us"]
            extra = "" if key == "c_entry_us" else f"; device {row['ms_median']:.4f} ms"
            print(f"[k1_bench] {side:4s} {key}: host us median {h['median']:.2f} (quartiles {h['q1']:.2f}, "
                  f"{h['q3']:.2f}){extra}", flush=True)
    return dict(base=str(base), new=str(new), order=order, summary=summary, runs=runs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--base", type=Path, default=None, help="A/B against this checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.base is not None:
        res = run_ab(args.base.resolve(), args.root.resolve(), args.pairs)
    else:
        res = run_one(args.root.resolve())
    text = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text if args.base is None else json.dumps(res["summary"]))


if __name__ == "__main__":
    main()
