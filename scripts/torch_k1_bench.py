#!/usr/bin/env python3
"""The flash-attention kernels of one checkout of the port, on one NVIDIA GPU.

    python3 scripts/torch_k1_bench.py [--root DIR] [--phases fwd,bwd] [--out FILE.json]
    python3 scripts/torch_k1_bench.py --base DIR [--root DIR] [--phases ...] [--pairs 10] [--out FILE.json]
    python3 scripts/torch_k1_bench.py --k2-variants 16x3,32x3,64x3 [--root DIR] [--pairs 2] [--out FILE.json]

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
     query), where the checkout has it;
  4. the host µs per K2 wrapper call at the ViT-H/14 encoder shape, whole
     and split into the argument checks, the TMA view rule, the two output
     allocations (dq, D) and the C entry alone (tensor-map encodes and
     the launch), 200 calls each, fewer than the launch queue holds, so
     the card's time does not hold the host back;
- ``h80``, K2 and K3 at head_dim 80 alone (the variant runs): K2/K3
  against the plain backward at ``H80_EDGES`` and the ViT-H/14 encoder,
  both dtypes, with and without an lse cotangent, K2's D, reruns
  bit-identical; K2 and K3 by graph replay at the encoder (256, 67, 16,
  80) and at (256, 64, 16, 80), where no tile is ragged (the difference
  is what the 3-row ragged tiles cost); blocks an SM at head_dim 80.

An older checkout whose K2 takes D from the plain D pass
(``attention_delta``) runs the same phases through that pass
(chip_smoke's ``folds_delta``): its backward is D + K2 + K3.

With ``--base DIR`` it runs itself on ``--base`` and on ``--root`` in
processes of their own, in the order base, new, new, base, until each
side has run ``--pairs`` times, and prints per side the median and
quartiles of every time it took (device ms per kernel and shape; host µs
per K1 and K2 wrapper call and of their C entries).

With ``--k2-variants COLSxBLOCKS,...`` it copies ``--root``'s package into
a temporary directory once per variant with K2's product width
(``BwdTile<80>::kDqCols``) and register bound (``kMinBlocksDq``) at
head_dim 80 set to COLS and BLOCKS, and runs the ``h80`` phase on
``--root`` and on each copy in processes of their own, in turns (the
order forwards, then backwards), ``--pairs`` times each. A variant whose
build spills is reported as refused by the build and not timed.

Exits non-zero on any disagreement. Prints one JSON object as its last
line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
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


def host_parts_bwd(cs, fa, shape) -> dict:
    """Host µs per K2 wrapper call at ``shape`` (bf16, no lse cotangent),
    whole and in parts: the argument checks, the TMA view rule, the two
    output allocations and the C entry alone with its arguments ready.
    200 calls each: the launch queue holds more, so the card's time does
    not stall the host."""
    import torch

    q, k, v, do, o, lse = cs.bwd_inputs(shape, torch.bfloat16, 9, fa)
    b, sq, h, d = shape
    dq = torch.empty_like(q)
    delta = torch.empty((b * h, sq), dtype=torch.float32, device="cuda")
    lib = fa._library("flash_bwd")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), None,
            delta.data_ptr(), dq.data_ptr(), 1, b, h, sq, sq, d,
            *(st for x in (q, k, v, do, o, dq) for st in x.stride()[:3]), torch.cuda.current_stream().cuda_stream)
    return dict(
        wrapper_us=cs.host_us(lambda: fa.flash_attention_bwd_dq(q, k, v, do, o, lse), calls=200),
        check_us=cs.host_us(lambda: fa._check_bwd_args(q, k, v, do, {"lse": lse, "g_lse": None}, o=o), calls=200),
        alloc_us=cs.host_us(lambda: (torch.empty_like(q),
                                     torch.empty((b * h, sq), dtype=torch.float32, device="cuda")), calls=200),
        c_entry_us=cs.host_us(lambda: lib.jumbo_flash_bwd_dq(*args), calls=200),
        views_us=cs.host_us(lambda: fa._tma_views("K2", q, k, v, do, o), calls=200),
    )


def phase_h80(cs, fa, metrics: dict) -> None:
    """K2 and K3 at head_dim 80: the gates of chip_smoke's phase 4
    (``check_bwd_case``) at ``H80_EDGES`` and the ViT-H/14 encoder, then
    graph-replay times at the encoder and at 64 tokens (no ragged tile),
    and the blocks an SM."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, shape in enumerate([*cs.H80_EDGES, cs.H14_ENC_SHAPE]):
            q, k, v, do, o, lse = cs.bwd_inputs(shape, dtype, 700 + i, fa)
            b, sq, h, _ = shape
            for g_lse in (None, torch.randn((b * h, sq), device="cuda")):
                case = f"h80 {shape} {name}{' g_lse' if g_lse is not None else ''}"
                grads, d_err = cs.check_bwd_case(fa, case, q, k, v, do, o, lse, g_lse, dtype)
                if dtype == torch.bfloat16 and sq > 1:  # at one key dq and dk are 0 exactly: no scale
                    worst = max(worst, *(e / sc for e, sc in grads.values()))
                cs.log(f"{case}: " + ", ".join(f"{g} {e:.3e}/{sc:.3e}" for g, (e, sc) in grads.items())
                       + f", D {d_err:.3e}; rerun bit-identical")
    metrics["h80 bf16 worst err / max|ref|"] = worst
    for shape in (cs.H14_ENC_SHAPE, (cs.H14_BATCH, 64, 16, 80)):
        q, k, v, do, o, lse = cs.bwd_inputs(shape, torch.bfloat16, 720, fa)
        dd = fa.flash_attention_bwd_dq(q, k, v, do, o, lse)[1]
        k2 = cs.graph_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, o, lse))
        k3 = cs.graph_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd))
        bound, by = cs.bwd_bound_ms(shape, 3, 6, 2)
        metrics[f"K2 {shape} ms"], metrics[f"K3 {shape} ms"] = k2, k3
        cs.log(f"h80 timing {shape}: K2 {k2:.4f} ms (bound {bound:.4f}, {by}), K3 {k3:.4f} ms")
    for kern in ("K2", "K3"):
        metrics[f"{kern} head_dim 80 blocks per SM"] = fa.blocks_per_sm(kern, 80)


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
    build_s = cs.build_kernels(_build, ["flash_fwd", "flash_bwd"] if phases & {"bwd", "h80"} else ["flash_fwd"])
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
    if "h80" in phases:
        phase_h80(cs, fa, metrics)
    if phases & {"bwd", "h80"} and cs.folds_delta(fa):
        parts = host_parts_bwd(cs, fa, cs.H14_ENC_SHAPE)
        cs.log(f"host µs per K2 call at {cs.H14_ENC_SHAPE}: " + ", ".join(f"{n} {t:.2f}" for n, t in parts.items()))
        res["host_parts_bwd"] = parts
        for n, t in parts.items():
            metrics[f"K2 {cs.H14_ENC_SHAPE} host {n}"] = t
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


def make_variant(root: Path, dest: Path, cols: int, blocks: int) -> Path:
    """A copy of ``root``'s package under ``dest`` whose K2 at head_dim 80
    takes products of ``cols`` keys under a register bound of ``blocks``
    blocks an SM."""
    shutil.copytree(root / "jumbo_mae_tpu_tpu_torch", dest / "jumbo_mae_tpu_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dest / "jumbo_mae_tpu_tpu_torch" / "csrc" / "flash_bwd.cu"
    text = src.read_text()
    for name, value in (("kDqCols", cols), ("kMinBlocksDq", blocks)):
        decl = f"static constexpr int {name} = "
        if text.count(decl) != 1:
            raise SystemExit(f"[k1_bench] FAIL: {src} declares {name} {text.count(decl)} times, want once")
        text = text.replace(decl, f"{decl}D == 80 ? {value} : ")
    src.write_text(text)
    return dest


def k2_80_registers(log: str) -> str:
    """ptxas's register line for K2 at head_dim 80 (``flash_bwd_dq_wgmma<80>``)
    in a run's build log."""
    entry = ""
    for line in log.splitlines():
        if "ptxas flash_bwd" not in line:
            continue
        if "Compiling entry" in line:
            entry = line
        elif "registers" in line and "flash_bwd_dq_wgmmaILi80E" in entry:
            return line.split("ptxas info", 1)[-1].strip(" :")
    return "not found"


def run_variants(root: Path, specs: list[str], pairs: int) -> dict:
    """The ``h80`` phase on ``root`` and on one copy per ``COLSxBLOCKS``
    spec, in turns (forwards, then backwards), ``pairs`` times each."""
    runs, refused = {"tree": []}, {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"tree": root}
        for spec in specs:
            cols, blocks = (int(x) for x in spec.split("x"))
            roots[spec] = make_variant(root, Path(tmp) / spec, cols, blocks)
            runs[spec] = []
        order = []
        while len(order) < pairs * len(roots):
            order += list(roots) if len(order) // len(roots) % 2 == 0 else list(roots)[::-1]
        for i, name in enumerate(order):
            if name in refused:
                continue
            out = Path(tmp) / f"{i}.json"
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", str(roots[name]),
                                   "--phases", "h80", "--out", str(out)], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                if "ptxas reports register spills" in proc.stdout + proc.stderr:
                    spills = [ln for ln in proc.stdout.splitlines()
                              if "spill stores" in ln and " 0 bytes spill stores" not in ln]
                    refused[name] = spills
                    print(f"[k1_bench] variant {name}: refused by the build (spills): {spills}", flush=True)
                    continue
                raise SystemExit(f"[k1_bench] FAIL: run {i} ({name}) exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            rep = json.loads(out.read_text())
            runs[name].append(rep)
            rep["ptxas"] = k2_80_registers(proc.stdout)
            print(f"[k1_bench] run {i:2d} {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in rep["metrics"].items()),
                  flush=True)
    summary = {name: {key: quartiles([r["metrics"][key] for r in reps]) if len(reps) > 1
                      else {"q1": reps[0]["metrics"][key], "median": reps[0]["metrics"][key],
                            "q3": reps[0]["metrics"][key]}
                      for key in reps[0]["metrics"]}
               for name, reps in runs.items() if reps}
    for name, keys in summary.items():
        for key, q in keys.items():
            print(f"[k1_bench] {name:5s} {key}: median {q['median']:.4f} (quartiles {q['q1']:.4f}, {q['q3']:.4f})",
                  flush=True)
    # a run that found its library already built (the tree, after an
    # earlier phase of the same call) compiled nothing and logs no ptxas
    ptxas = {name: next((r["ptxas"] for r in reps if r["ptxas"] != "not found"), "not found")
             for name, reps in runs.items() if reps}
    return dict(root=str(root), order=order, summary=summary, refused=refused, ptxas=ptxas, runs=runs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--base", type=Path, default=None, help="A/B against this checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--phases", default="fwd,bwd",
                    help="comma-separated: fwd (K1), bwd (K2, K3), h80 (K2, K3 at head_dim 80 alone)")
    ap.add_argument("--k2-variants", default=None,
                    help="comma-separated COLSxBLOCKS: K2's product width and register bound at head_dim 80")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases or not phases <= {"fwd", "bwd", "h80"}:
        ap.error(f"--phases takes fwd, bwd and/or h80, got {args.phases!r}")
    if args.k2_variants is not None:
        res = run_variants(args.root.resolve(), args.k2_variants.split(","), args.pairs)
    elif args.base is not None:
        res = run_ab(args.base.resolve(), args.root.resolve(), args.pairs, phases)
    else:
        res = run_one(args.root.resolve(), phases)
    text = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text if args.base is None and args.k2_variants is None else json.dumps(res["summary"]))


if __name__ == "__main__":
    main()
