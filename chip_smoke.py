#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jumbo_mae_tpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. device — the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build  — every kernel of ``jumbo_mae_tpu_tpu_torch/csrc`` with nvcc
   (sm_90a), in parallel, with the ptxas register/spill report;
3. kernel vs plain — the flash-attention forward kernel against its plain
   PyTorch version on the card, ``o`` and ``lse``: float32 (TF32 off) at
   atol/rtol 1e-5 (sum order), bfloat16 on the same bf16 inputs at atol
   2e-2, at the serving shapes (ViT-B/16 at 224 px and batch 64, 448 px,
   the MAE-visible 52-token length, ViT-H/14 with head_dim 80, head_dims
   32 and 128), plus strided q/k/v views of a fused projection;
4. kernel timings — the kernel, its plain version and one PyTorch library
   call (scaled_dot_product_attention, a yardstick the port never calls)
   at the ViT-B/16 shape, beside the least time the card could take;
5. the slice — the ViT-B/16 classifier as recipes/finetune_vit_b16.yaml
   builds it (12 layers, dim 768, 3 CLS tokens, sincos2d, 1000 labels,
   bf16 compute, random weights from a seed) served through
   ``InferenceEngine`` (logits, features cls and gap; requests of 1, 5,
   64 and 70 images) and through ``cli.predict``: shapes, finite values,
   kernel launches = 12 x dispatches, padding inertness, the float32
   engine on the card against the float32 engine on the CPU, images/s.

Before the last line it prints the ``{"kernels": [...]}`` line and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import time

VIT_B_SHAPE = (64, 199, 12, 64)  # ViT-B/16 at 224 px, batch 64
KERNEL_SHAPES = [
    VIT_B_SHAPE,
    (4, 787, 16, 64),  # ViT-L/16 at 448 px
    (8, 52, 16, 64),  # 49 visible patches + 3 CLS (MAE, mask 0.75)
    (4, 259, 16, 80),  # ViT-H/14 at 224 px
    (8, 199, 8, 32),  # head_dim 32
    (2, 331, 8, 128),  # head_dim 128
]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
REQUESTS = (1, 5, 64, 70)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"[chip_smoke] FAIL: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
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


def attention_bound_ms(shape, dtype_bytes: int, peak_flops: float) -> tuple[float, str]:
    """Least time for softmax(q·kᵀ)·v at (B, S, H, D): 4·B·H·S²·D
    operations over the peak rate, or q, k, v read once and o written
    once over the memory rate, whichever is larger."""
    b, s, h, d = shape
    t_ops = 4 * b * h * s * s * d / peak_flops
    t_bytes = 4 * b * s * h * d * dtype_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def qkv(shape, dtype, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    return (q * shape[-1] ** -0.5).to(dtype), k.to(dtype), v.to(dtype)


def phase_kernels(fa) -> dict:
    """Phase 3: kernel against plain version, every shape, both dtypes."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)), (torch.bfloat16, dict(atol=2e-2, rtol=0.0))):
        for i, shape in enumerate(KERNEL_SHAPES):
            q, k, v = qkv(shape, dtype, seed=i)
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
            e_o = (o.float() - ref_o.float()).abs().max().item()
            e_l = (lse - ref_lse).abs().max().item()
            name = str(dtype).split(".")[-1]
            log(f"kernel {name} {shape}: max|o-plain| {e_o:.3e}  max|lse-plain| {e_l:.3e}")
            check(torch.isfinite(o.float()).all().item(), f"non-finite kernel output at {shape} {name}")
            torch.testing.assert_close(o, ref_o, **tol)
            torch.testing.assert_close(lse, ref_lse, **tol)
            errs[(name, shape)] = e_o
    # strided inputs: q, k, v as views of one fused (B, S, 3, H, D) projection
    b, s, h, d = VIT_B_SHAPE
    fused = torch.randn((b, s, 3, h, d), device="cuda").to(torch.bfloat16)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    o = fa.flash_attention_fwd(q, k, v)
    ref = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    check(torch.equal(o, ref), "strided q/k/v views disagree with contiguous copies")
    log("kernel on strided q/k/v views equals contiguous copies: True")
    return errs


def phase_timings(fa) -> dict:
    """Phase 4: kernel, plain and library times at the ViT-B/16 shape."""
    import torch
    import torch.nn.functional as F

    out = {}
    for shape in (VIT_B_SHAPE, (4, 787, 16, 64)):
        q, k, v = qkv(shape, torch.bfloat16, seed=100)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v), iters=10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D) views
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
        bound, by = attention_bound_ms(shape, 2, PEAK_BF16_FLOPS)
        log(
            f"timing bf16 {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"kernel at {100 * bound / ms:.1f}% of bound"
        )
        out[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)
    q, k, v = qkv(VIT_B_SHAPE, torch.float32, seed=101)
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10)
    bound, by = attention_bound_ms(VIT_B_SHAPE, 4, PEAK_F32_FLOPS)
    log(f"timing f32 {VIT_B_SHAPE}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return out


def phase_slice(fa, smi: str, cfg, device: str = "cuda", cli_args: tuple = ()) -> tuple[int, int]:
    """Phase 5: the serving slice on ``cfg``. Returns (launches,
    dispatches) of the main-path run."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.cli import predict
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images

    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, max_batch=64, init_seed=0, device=device)
    nparams = sum(p.numel() for p in engine.model.parameters())
    log(f"engine built in {time.perf_counter() - t0:.2f} s: {nparams} params, "
        f"seq {cfg.num_cls_tokens + cfg.num_patches}, {engine.cfg.dtype}")
    size, layers = cfg.image_size, cfg.layers
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (max(REQUESTS), size, size, 3), dtype=np.uint8)
    widths = {"logits": cfg.labels, "cls": cfg.num_cls_tokens * cfg.dim, "gap": cfg.dim}

    # ---- the main path: counts set to 0 just before, read just after
    fa.LAUNCHES = 0
    engine.dispatches = 0
    outs = {}
    for n in REQUESTS:
        outs[("logits", n)] = engine.logits(images[:n])
        for pool in ("cls", "gap"):
            outs[(pool, n)] = engine.features(images[:n], pool=pool)
    launches, dispatches = fa.LAUNCHES, engine.dispatches
    for (what, n), out in outs.items():
        check(out.shape == (n, widths[what]) and out.dtype == np.float32,
              f"{what} for {n} images has shape {out.shape} {out.dtype}")
        check(bool(np.isfinite(out).all()), f"{what} for {n} images is not finite")
    want = sum(-(-n // 64) for n in REQUESTS) * 3
    log(f"main path: {dispatches} dispatches (expected {want}), "
        f"{launches} flash launches ({layers} x dispatches = {layers * dispatches})")
    check(dispatches == want, "dispatch count")
    check(launches == layers * dispatches, "flash launches != layers x dispatches")
    check(np.array_equal(outs[("logits", 70)][:64], outs[("logits", 64)]),
          "the first 64 rows of a 70-image request differ from the 64-image request")

    # ---- padding is inert: the same bucket, zero vs random pad rows
    for task, pool in (("logits", None), ("features", "cls"), ("features", "gap")):
        zero_pad = np.concatenate([images[:5], np.zeros((3, size, size, 3), np.uint8)])
        rand_pad = np.concatenate([images[:5], images[-3:]])
        a = engine.dispatch(task, zero_pad, pool=pool)[:5]
        b = engine.dispatch(task, rand_pad, pool=pool)[:5]
        check(np.array_equal(a, b), f"pad rows changed valid rows ({task} {pool})")
        check(np.array_equal(a, outs[(pool or "logits", 5)]), f"bucket-8 rows differ from predict ({task})")
    log("padding inert: zero and random pad rows give bit-identical valid rows")

    # ---- throughput at bucket 64 in the compute dtype
    batch = images[:64]
    engine.logits(batch)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.logits(batch)
    dt = time.perf_counter() - t0
    log(f"throughput: {64 * reps / dt:.1f} images/s (logits, bucket 64, {engine.cfg.dtype}, "
        f"host clock incl. upload and fetch) on {smi}")
    with torch.inference_mode():
        xn = normalize_images(torch.from_numpy(batch).to(engine.device), dtype=engine.cfg.compute_dtype)
        fwd_ms = cuda_ms(lambda: engine.model(xn), iters=10, warmup=2)
    log(f"device forward, bucket 64: {fwd_ms:.3f} ms ({64e3 / fwd_ms:.1f} images/s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine

    # ---- cli.predict, the user's entry point: 8 images, one dispatch
    before = fa.LAUNCHES
    predict.main([*cli_args, "--task", "logits", "--synthetic", "8", "--max-batch", "64"])
    check(fa.LAUNCHES - before == layers, f"cli.predict made {fa.LAUNCHES - before} launches, want {layers}")
    log(f"cli.predict served 8 images through {layers} kernel launches")

    # ---- float32 on the card against float32 on the CPU, same weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev32 = InferenceEngine(cfg, dtype="float32", max_batch=64, init_seed=0, device=device)
    cpu32 = InferenceEngine(cfg, dtype="float32", max_batch=64, init_seed=0, device="cpu")
    small = images[:2]
    for task, kw in (("logits", {}), ("features", {"pool": "cls"})):
        g = dev32.predict(small, task=task, **kw)
        c = cpu32.predict(small, task=task, **kw)
        scale = np.abs(c).max()
        log(f"f32 {device} vs CPU ({task}): max abs diff {np.abs(g - c).max():.3e}, max |cpu| {scale:.3e}")
        # rtol 1e-3 elementwise, with an atol of 1e-3 of the output's scale
        # for entries near zero: 12 layers of sums in another order
        np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-3 * scale)
    return launches, dispatches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] FAIL: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    try:
        from jumbo_mae_tpu_tpu_torch.ops import _build
        from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
    except ImportError as exc:
        raise SystemExit(f"[chip_smoke] FAIL: the port is not importable here: {exc}") from exc

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {len(_build.sources())} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")

    errs = phase_kernels(fa)
    timings = phase_timings(fa)
    from jumbo_mae_tpu_tpu_torch.models import preset

    # recipes/finetune_vit_b16.yaml's model; the CLI builds the same one
    vit_b16 = preset("vit_b16", posemb="sincos2d")
    cli_args = ("--preset", "vit_b16", "--set", "posemb=sincos2d")
    launches, dispatches = phase_slice(fa, smi, vit_b16, "cuda", cli_args)

    t = timings[VIT_B_SHAPE]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "jumbo_mae_tpu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "jumbo_mae_tpu_tpu/ops/pallas/attention.py:84",
        "launches": launches,
        "max_abs_err": errs[("bfloat16", VIT_B_SHAPE)],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
